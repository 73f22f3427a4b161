"""Synthetic LM token pipeline: deterministic, prefetched on a thread.

The twin of ``repro/data/tokens.py``. Generation is keyed on (seed, step)
with numpy, so any run regenerates any batch: a restart never replays or
skips data, and ``synth_batch`` gives bitwise the reference's arrays, so
the two packages train on the same tokens. A background thread builds the
next batches while the device runs the current step; on a CUDA device it
stages each batch in pinned host memory, and the iterator copies it to the
device without blocking (the reference ``device_put``s with shardings).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefix_len: int = 0      # VLM/audio stub prefix embeddings
    d_model: int = 0


def synth_batch(cfg: TokenDataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (learnable structure so loss decreases)."""
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len
    v = cfg.vocab_size
    # mixture of a repeated motif and noise -> next-token structure exists
    motif_len = 16
    motifs = rng.integers(0, v, size=(b, motif_len))
    reps = int(np.ceil((s + 1) / motif_len))
    seq = np.tile(motifs, (1, reps))[:, :s + 1]
    noise = rng.integers(0, v, size=(b, s + 1))
    noisy = rng.random((b, s + 1)) < 0.1
    seq = np.where(noisy, noise, seq).astype(np.int32)
    batch = {
        "tokens": seq[:, :-1],
        "labels": seq[:, 1:],
        "mask": np.ones((b, s), np.float32),
    }
    if cfg.prefix_len:
        batch["prefix_embed"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


class TokenStream:
    """Prefetching iterator over ``synth_batch`` from ``start_step`` on, as
    tensors on ``device`` (the card unless the caller passes ``"cpu"``).
    ``close()`` stops the thread."""

    def __init__(self, cfg: TokenDataConfig, *, start_step: int = 0,
                 device: DeviceLike = None, prefetch: int = 2):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in synth_batch(self.cfg, step).items()}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _worker(self):
        step, batch = self.step, None
        while not self._stop.is_set():
            if batch is None:
                batch = self._host(step)
            try:
                self._q.put(batch, timeout=0.2)
            except queue.Full:
                continue
            step, batch = step + 1, None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self._q.get()
        self.step += 1
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def close(self):
        self._stop.set()
