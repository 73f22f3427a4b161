#!/usr/bin/env python3
"""Where the ``mp_scatter`` kernel's time goes, on an H100.

    python3 experiments/scatter_breakdown.py     # from the root of a checkout

Builds variants of ``src/repro_torch/kernels/csrc/mp_scatter.cu``, each a
copy of the source with one part taken out or changed (a variant with a
part taken out returns wrong sums by design: these are timing probes, not
kernels), and times each as ``chip_smoke.py::time_ms`` does (device time
of launches queued behind a GPU spin, and one call with its host
dispatch), in turns (each variant twice, the source as it is first and
last), at four shapes: the olmoe-1b-7b MoE dispatch (8,192 bf16 rows of
D = 2048 into 10,240 slots, one a slot), the MoE combine (8,192 f32 rows
into 1,024 tokens, eight a token), GIN at the hep serving bucket (N = 64,
E = 1024, D = 100) and a synthetic N = 1024, E = 4096, D = 100:

  as_is          the committed kernel
  no_fold        the owner buckets alone: phase 4 (the fold and the
                 writes) skipped
  barriers_only  the launch and the grid form's four grid barriers: the
                 grid form's phases 0-3 replaced by four bare barriers,
                 no phase 4 (the block-local form still buckets)
  grid_form      the grid form at every size (no block-local buckets)

Prints one line per variant and shape, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernel's source: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_scatter_breakdown.py checks on the CPU that each still
applies.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SRC = build.CSRC / "mp_scatter.cu"
OUT = REPO / "build" / "scatter_breakdown"

FOLD = "      for (int k = 0; k < here; ++k) {"
BUCKETS = ("  if constexpr (kGrid) buckets::bucket_edges<true>(g, b);   "
           "// phases 0-3")
LOCAL = "constexpr int kLocalEdges = 4096;"


def variants(src: str) -> dict:
    """{name: source}; each edit must apply."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"the source changed: {old[:40]!r} not found")
        return text.replace(old, new)
    no_fold = sub(src, FOLD, "      for (int k = 0; k < here && p.n < 0; ++k) {")
    return {
        "as_is": src,
        "no_fold": no_fold,
        "barriers_only": sub(no_fold, BUCKETS, (
            "  if constexpr (kGrid) {\n"
            "    for (int k = 0; k < 4; ++k) "
            "cooperative_groups::this_grid().sync();\n  }")),
        "grid_form": sub(src, LOCAL, "constexpr int kLocalEdges = -1;"),
    }


def shapes():
    """{name: (msg, receivers, edge_mask, num_nodes)} on the card, from
    ``default_rng(0)``."""
    r = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(a).cuda()
    e, d, n = 8192, 2048, 10240
    slot = np.full(e, n, np.int64)
    own = r.random(e) < 0.96
    slot[own] = r.permutation(n)[:int(own.sum())]
    t = 1024
    tokens = np.repeat(np.arange(t), 8)[r.permutation(e)].astype(np.int64)
    out = {
        "moe_dispatch_bf16": (
            dev(r.normal(size=(e, d)).astype(np.float32)).to(torch.bfloat16),
            dev(slot), dev(own), n),
        "moe_combine_f32": (dev(r.normal(size=(e, d)).astype(np.float32)),
                            dev(tokens), dev(r.random(e) < 0.96), t),
    }
    for name, (n, e) in (("gin_hep_n64_e1024", (64, 1024)),
                         ("n1024_e4096", (1024, 4096))):
        out[name] = (dev(r.normal(size=(e, 100)).astype(np.float32)),
                     dev(r.integers(0, n, e).astype(np.int64)),
                     dev(r.random(e) < 0.8), n)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_breakdown: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(SRC.read_text()).items():
        src = OUT / f"{name}.cu"
        header = build.CSRC / "edge_buckets.cuh"
        src.write_text(text.replace('#include "edge_buckets.cuh"',
                                    f'#include "{header}"'))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
               str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {name} variant")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).mp_scatter_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (msg, rcv, mask, n) in shapes().items():
        e, d = msg.shape
        out = torch.empty((n, d), dtype=msg.dtype, device="cuda")
        scratch = [torch.empty(size, dtype=torch.int32, device="cuda")
                   for size in (n, n + 1, e)]
        args = (msg.data_ptr(), rcv.data_ptr(), mask.data_ptr(),
                out.data_ptr(), n, e, d, 0, int(msg.dtype == torch.bfloat16),
                *(t.data_ptr() for t in scratch), stream)
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            err = fns[name](*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            times[name].append(time_ms(lambda: fns[name](*args)))
        for name, ts in times.items():
            print(f"{shape} {name}: device {ts[0][0] * 1e3:.2f} / "
                  f"{ts[1][0] * 1e3:.2f} us, one call with host dispatch "
                  f"{ts[0][1] * 1e3:.2f} / {ts[1][1] * 1e3:.2f} us (two "
                  f"turns)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
