"""End-to-end trainer: data -> train step -> metrics -> checkpoints.

The twin of ``repro/launch/train.py``: on one device (the card unless the
caller passes ``device="cpu"``), or with ``mesh=`` over the mesh's
positions by the rule table of ``cfg``'s profile
(``launch/steps.py::make_sharded_train_step``: data parallel, the model
axis, FSDP; several positions may share one card, each on its own
stream). On a mesh the parameters and optimizer state are split as the
rules place them, each position holding its pieces. Fault tolerance as in
the reference:

  * auto-resume from the newest *valid* checkpoint (torn or corrupt steps
    are skipped by checksum validation);
  * periodic and on-crash checkpoints (the except path saves the last
    good state before re-raising) and a final one;
  * a per-step watchdog: steps slower than ``watchdog_factor`` times the
    rolling median are logged as straggler events;
  * deterministic (seed, step)-keyed data, so a restart never replays
    tokens;
  * elastic: a checkpoint restores onto another mesh (checkpoints hold
    unsharded arrays; see ``distributed/elastic.py``).

Checkpoints are the JAX package's format (``checkpoint/checkpoint.py``):
``{"params": ..., "opt": ...}`` with the same leaves, one unsharded copy
(gathered from the positions' pieces on a mesh), so a JAX ``Trainer``'s
checkpoint resumes here and the reverse, and a mesh's resumes on another
mesh (``distributed/elastic.py::elastic_restore``). Fresh weights are drawn from
``torch.Generator().manual_seed(tcfg.seed)`` by the JAX package's init
rule (on position 0's device, then placed on the positions); the numbers
differ from ``jax.random``'s.

Usage (from the root of a checkout):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 2048          # full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --data-parallel 2 --model-parallel 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-67b \
      --reduced --data-parallel 2 --model-parallel 2 --device cpu  # FSDP
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.archs import ARCHS, REDUCED
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.tokens import TokenDataConfig, TokenStream
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.distributed.sharding import (Sharded, device_put, map_defs,
                                              param_shardings,
                                              zeros_like_defs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_rules, make_train_step
from repro_torch.models import lm
from repro_torch.optim.optimizers import get_optimizer, tree_leaves


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 global_batch: int, seq_len: int, mesh=None,
                 device: DeviceLike = None, ckpt_dir: Optional[str] = None,
                 watchdog_factor: float = 3.0):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else resolve_device(device))
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.watchdog_factor = watchdog_factor
        self.straggler_events = 0

        self.pdefs = lm.lm_param_defs(cfg)
        self.opt = get_optimizer(cfg.optimizer)
        self.odefs = self.opt.state_defs(self.pdefs)
        self.rules = build_rules(cfg, mesh, "train", global_batch=global_batch)
        self.step_fn = make_train_step(cfg, tcfg, self.rules, mesh)
        self._shardings = None
        if mesh is not None:
            self._shardings = {
                "params": param_shardings(self.pdefs, self.rules, mesh),
                "opt": param_shardings(self.odefs, self.rules, mesh)}
        self.data_cfg = TokenDataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=tcfg.seed,
            prefix_len=cfg.prefix_len, d_model=cfg.d_model)

        self.params = None
        self.opt_state = None
        self.step = 0

    # ----- state ---------------------------------------------------------
    def _set_params(self, params) -> None:
        for p in tree_leaves(params):
            for t in (p.pieces.flat if isinstance(p, Sharded) else [p]):
                t.requires_grad_(True)
        self.params = params

    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = lm.init_params(gen, self.cfg, self.device)
        opt_state = zeros_like_defs(self.odefs, self.device)
        if self.mesh is not None:
            params = device_put(params, self._shardings["params"])
            opt_state = device_put(opt_state, self._shardings["opt"])
        self._set_params(params)
        self.opt_state = opt_state
        self.step = 0

    def try_resume(self) -> bool:
        if self.ckpt_dir is None:
            return False
        # 0-element tensors on the device: each restored leaf goes there
        # (restore places a leaf on its ``like`` leaf's device)
        like = map_defs(lambda d: torch.empty(0, device=self.device),
                        {"params": self.pdefs, "opt": self.odefs})
        if self.mesh is None:
            res = ckpt.restore_latest(self.ckpt_dir, like)
        else:
            res = elastic_restore(self.ckpt_dir,
                                  {"params": self.pdefs, "opt": self.odefs},
                                  self.rules, self.mesh, like)
        if res is None:
            return False
        step, tree, _ = res
        self._set_params(tree["params"])
        self.opt_state = tree["opt"]
        self.step = step
        return True

    def save(self):
        if self.ckpt_dir is None:
            return
        ckpt.save(self.ckpt_dir, self.step,
                  {"params": self.params, "opt": self.opt_state},
                  keep_n=self.tcfg.keep_checkpoints,
                  extra={"data_step": self.step})

    # ----- loop ----------------------------------------------------------
    def run(self, num_steps: int, log_every: int = 10) -> Dict[str, Any]:
        if self.params is None and not self.try_resume():
            self.init_state()
        start = self.step
        stream = TokenStream(self.data_cfg, start_step=self.step,
                             device=self.device)
        losses = []
        durations = []
        try:
            while self.step < start + num_steps:
                batch = next(stream)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])        # waits for the step
                dt = time.perf_counter() - t0
                durations.append(dt)
                med = float(np.median(durations[-50:]))
                if len(durations) > 5 and dt > self.watchdog_factor * med:
                    self.straggler_events += 1
                    print(f"[watchdog] step {self.step} took {dt:.3f}s "
                          f"(median {med:.3f}s)")
                losses.append(loss)
                self.step += 1
                if self.step % log_every == 0:
                    print(f"step {self.step:6d} loss {loss:8.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"{dt*1e3:7.1f} ms")
                if (self.tcfg.checkpoint_every
                        and self.step % self.tcfg.checkpoint_every == 0):
                    self.save()
        except Exception:
            # snapshot last good state for post-mortem restart, then re-raise
            self.save()
            raise
        finally:
            stream.close()
        self.save()
        return {"losses": losses, "final_step": self.step,
                "straggler_events": self.straggler_events,
                "step_s": durations}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (every mesh "
                    "position on the CPU); default: cuda")
    args = ap.parse_args(argv)

    cfg = REDUCED[args.arch] if args.reduced else ARCHS[args.arch]
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 5),
                       checkpoint_every=max(args.steps // 4, 25))
    mesh = None
    if args.data_parallel * args.model_parallel > 1:
        mesh = make_host_mesh(args.data_parallel, args.model_parallel,
                              devices=args.device)
    try:
        trainer = Trainer(cfg, tcfg, global_batch=args.batch,
                          seq_len=args.seq, mesh=mesh, device=args.device,
                          ckpt_dir=args.ckpt_dir)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    out = trainer.run(args.steps)
    print(f"done: step={out['final_step']} "
          f"first-loss={out['losses'][0]:.4f} "
          f"last-loss={out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
