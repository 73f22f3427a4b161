"""Config dataclasses: model architecture, input shapes, mesh, training.

The twin of ``repro/configs/base.py``, copied as data: the same fields and
defaults, with ``dtype`` a torch dtype. The distribution fields
(``sharding_profile``, ``sp_shardmap_mlp``, ``fsdp``, ``remat``,
``unroll_scans``, ...) describe the JAX package's TPU meshes and compiled
programs; the port's single-GPU paths carry them and do not read them.
``scan_layers`` still sets the layer stack's parameter layout
(``nn/transformer.py::stack_pattern``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # attention / block options
    qkv_bias: bool = False
    tie_embeddings: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: str = "global"    # global | local_global | griffin | ssm
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_plus_one: bool = False      # gemma-style (1 + scale) rmsnorm
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True           # SwiGLU/GeGLU vs plain MLP
    pos: str = "rope"                # rope | sinusoidal
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False     # arctic: parallel dense FFN
    capacity_factor: float = 1.25
    expert_fsdp: bool = False
    moe_inner_remat: bool = True     # remat each dispatch group (peak mem
                                     # vs third-recompute trade; see §Perf)
    router_aux_coef: float = 0.01    # load-balance loss

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # RG-LRU (griffin / recurrentgemma)
    lru_width: int = 0
    lru_conv: int = 4
    lru_c: float = 8.0

    # modality frontend stub
    frontend: Optional[str] = None   # vision | audio
    prefix_len: int = 0              # patch/frame embedding slots

    # numerics / distribution
    dtype: Any = torch.bfloat16
    sharding_profile: str = "tp"     # tp | dp_only (fold the model axis
                                     # into batch; small models pay more in
                                     # TP collectives than they gain)
    sp_shardmap_mlp: bool = False    # hand-scheduled Megatron-SP FFN
                                     # (all-gather -> FFN -> reduce-scatter)
    fsdp: bool = False               # shard weights over data axes too
    remat: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    scan_layers: bool = True
    train_microbatches: int = 1      # gradient-accumulation factor at the
                                     # production train shape (bounds
                                     # per-microbatch activation memory)
    unroll_scans: bool = False       # analysis mode: python loops instead of
                                     # lax.scan/map so HLO cost analysis sees
                                     # every iteration (see launch/hlo_cost.py)
    optimizer: str = "adamw"         # adamw | adafactor

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def vocab_pad(self) -> int:
        """Vocab rows padded to a multiple of 32 so the table shards over a
        16-way model axis (logits beyond vocab_size are masked to -inf)."""
        return (self.vocab_size + 31) // 32 * 32

    @property
    def d_inner(self) -> int:        # mamba
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


# The assigned shape set (every arch is paired with all four; long_500k
# applicability is resolved per-arch in the registry).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1            # gradient accumulation
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    grad_compression: bool = False   # int8 error-feedback on pod axis
    seed: int = 0
