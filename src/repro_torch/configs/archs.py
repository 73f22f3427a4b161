"""The 10 assigned architectures (exact public configs) + reduced smoke
variants + per-arch shape applicability.

The twin of ``repro/configs/archs.py``, copied as data with its source tags
([hf] / [arXiv] per entry). ``REDUCED`` variants keep the family (pattern,
MoE, SSM, ...) with tiny dims for CPU tests. The port serves the dense
families (``nn/transformer.py``); a FULL config runs on the card where its
weights fit (llama3-8b in bf16, ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# full configs (dry-run / roofline)
# ---------------------------------------------------------------------------

QWEN15_05B = ModelConfig(
    name="qwen1.5-0.5b", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64, d_ff=2816, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, act="silu", rope_theta=1e6,
    # EXPERIMENTS.md §Perf: a 0.5B model is collective-bound under TP=16;
    # pure DP (model axis folded into batch) is 2x closer to roofline.
    # Baseline (sharding_profile="tp") recorded in experiments/dryrun.
    sharding_profile="dp_only",
)  # [hf:Qwen/Qwen1.5-0.5B]

DEEPSEEK_67B = ModelConfig(
    name="deepseek-67b", family="dense", num_layers=95, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22016,
    vocab_size=102400, act="silu", rope_theta=1e4, fsdp=True,
    # EXPERIMENTS.md §Perf iters 1-2: hand-scheduled SP FFN + 4 microbatches
    train_microbatches=4, sp_shardmap_mlp=True,
)  # [arXiv:2401.02954] llama-arch GQA

GEMMA2_27B = ModelConfig(
    name="gemma2-27b", family="dense", num_layers=46, d_model=4608,
    num_heads=32, num_kv_heads=16, head_dim=128, d_ff=36864,
    vocab_size=256000, act="gelu", layer_pattern="local_global",
    local_window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, norm_plus_one=True, embed_scale=True,
    tie_embeddings=True, fsdp=True, train_microbatches=8,
    sp_shardmap_mlp=True,  # §Perf: 0.099 -> 0.130
)  # [arXiv:2408.00118] alternating local/global + softcaps

LLAMA3_8B = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, act="silu", rope_theta=5e5,
    train_microbatches=4, sp_shardmap_mlp=True,  # §Perf: 0.070 -> 0.087
)  # [arXiv:2407.21783]

INTERNVL2_2B = ModelConfig(
    name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92553,
    act="silu", frontend="vision", prefix_len=256,
    sp_shardmap_mlp=True,  # §Perf: 0.043 -> 0.053
)  # [arXiv:2404.16821] InternViT (stub) + InternLM2 backbone

MAMBA2_27B = ModelConfig(
    name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
    vocab_size=50280, layer_pattern="ssm", ssm_state=128, ssm_conv=4,
    ssm_expand=2, ssm_head_dim=64, ssm_chunk=128, tie_embeddings=True,
    norm_plus_one=False,
)  # [arXiv:2405.21060] SSD

OLMOE_1B_7B = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1024,
    vocab_size=50304, num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
    act="silu",
)  # [arXiv:2409.02060] 64e top-8

ARCTIC_480B = ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=4864, vocab_size=32000,
    num_experts=128, num_experts_per_tok=2, moe_d_ff=4864,
    dense_residual=True, act="silu", fsdp=True, expert_fsdp=True,
    optimizer="adafactor", train_microbatches=8,
)  # [hf:Snowflake/snowflake-arctic-base] 128e top-2 + dense residual

RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
    act="gelu", layer_pattern="griffin", local_window=2048, lru_width=2560,
    lru_conv=4, norm_plus_one=True, embed_scale=True, tie_embeddings=True,
    sp_shardmap_mlp=True,  # §Perf: 0.041 -> 0.048
)  # [arXiv:2402.19427] RG-LRU + local attn, 2:1

MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
    act="gelu", gated_mlp=False, norm="layernorm", pos="sinusoidal",
    frontend="audio", prefix_len=0,
)  # [arXiv:2306.05284] decoder-only over EnCodec tokens

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        QWEN15_05B, DEEPSEEK_67B, GEMMA2_27B, LLAMA3_8B, INTERNVL2_2B,
        MAMBA2_27B, OLMOE_1B_7B, ARCTIC_480B, RECURRENTGEMMA_2B,
        MUSICGEN_LARGE,
    ]
}

# long_500k applicability: sub-quadratic decode only (DESIGN.md §5).
LONG_CONTEXT_OK = {"mamba2-2.7b", "recurrentgemma-2b"}


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "skipped(long-context): full-attention layers are not sub-quadratic"
    return True, ""


# ---------------------------------------------------------------------------
# reduced smoke variants (CPU: one forward/train step, shapes + finiteness)
# ---------------------------------------------------------------------------

_PATTERN_LEN = {"global": 1, "local_global": 2, "griffin": 3, "ssm": 1}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config, preserving its family/pattern structure."""
    kw = dict(
        num_layers=max(2, _PATTERN_LEN[cfg.layer_pattern]),
        d_model=64, vocab_size=512, dtype=torch.float32, remat=False,
        attn_q_chunk=32, attn_kv_chunk=32,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
                  head_dim=16)
        if cfg.num_kv_heads == cfg.num_heads:
            kw["num_kv_heads"] = 4
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.num_experts:
        kw.update(num_experts=8, num_experts_per_tok=min(
            cfg.num_experts_per_tok, 4), moe_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.lru_width:
        kw["lru_width"] = 64
    if cfg.local_window:
        kw["local_window"] = 16
    if cfg.prefix_len:
        kw["prefix_len"] = 4
    if cfg.layer_pattern == "griffin":
        kw["num_layers"] = 5   # one full group + 2 remainder (tests both paths)
    return cfg.replace(**kw)


REDUCED: Dict[str, ModelConfig] = {k: reduced(v) for k, v in ARCHS.items()}
