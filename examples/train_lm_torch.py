"""End-to-end training driver on the PyTorch port: synthetic data ->
trainer -> checkpoints -> resume, with the losses printed.

The twin of ``examples/train_lm.py``: a ~10M-param llama-style model for
200 steps by default (``--full``: the ~100M config, the same code path),
stopped halfway by a simulated preemption and resumed from the newest
checkpoint. The checkpoints are the JAX package's format, so either
package's trainer resumes the other's. On the card (the default) the
attention runs the hand-written flash kernels, forward and backward.

Run (from the root of a checkout):
    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--full]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""

import argparse
import tempfile

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch.train import Trainer

SMALL = ModelConfig(
    name="demo-10m", family="dense", num_layers=4, d_model=256,
    num_heads=4, num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=4096,
    act="silu", remat=False, dtype=torch.float32,
    attn_q_chunk=128, attn_kv_chunk=128,
)

FULL_100M = ModelConfig(
    name="demo-100m", family="dense", num_layers=10, d_model=640,
    num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=32000,
    tie_embeddings=True, act="silu", remat=False,
    attn_q_chunk=256, attn_kv_chunk=256,
)


def train(steps: int = 200, batch: int = 8, seq: int = 128,
          full: bool = False, ckpt_dir=None, device=None) -> dict:
    """Train ``steps`` steps with a restart at ``steps // 2``; returns the
    losses before and after the restart and the step it resumed at."""
    cfg = FULL_100M if full else SMALL
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=min(20, steps // 2),
                       total_steps=steps,
                       checkpoint_every=max(steps // 4, 10))

    print(f"config: {cfg.name}; checkpoints -> {ckpt_dir}")
    half = steps // 2
    tr = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq, device=device,
                 ckpt_dir=ckpt_dir)
    out1 = tr.run(half)
    print(f"-- simulated preemption at step {out1['final_step']}; "
          f"restarting from checkpoints --")

    tr2 = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq, device=device,
                  ckpt_dir=ckpt_dir)
    resumed = tr2.try_resume()
    print(f"resumed={resumed} at step {tr2.step}")
    out2 = tr2.run(steps - tr2.step)
    print(f"loss: start={out1['losses'][0]:.4f} "
          f"mid={out1['losses'][-1]:.4f} final={out2['losses'][-1]:.4f}")
    assert out2["losses"][-1] < out1["losses"][0], "loss should decrease"
    print("OK: loss decreased across restart")
    return {"first": out1["losses"], "second": out2["losses"],
            "resumed_at": tr2.step - len(out2["losses"]),
            "resumed": resumed}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, which must exist)")
    args = ap.parse_args()
    train(args.steps, args.batch, args.seq, args.full, args.ckpt_dir,
          args.device)
