#!/usr/bin/env python3
"""Where the bf16 ``flash_attention`` kernel's time goes, on an H100.

    python3 experiments/flash_breakdown.py        # from the root of a checkout

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each a copy of the source with one part taken out (the results are wrong
by design: these are timing probes, not kernels), and times each at
llama3-8b's prefill shape (B=2, H=32, S=2048, D=128, bf16), causal and
not, between CUDA events, in turns (each variant twice, the source as it
is first and last):

  as_is        the committed kernel
  one_p_term   P.V with P_hi alone (what the split of P into two bf16
               terms costs)
  no_products  neither wgmma stage (the softmax, masks and loads alone)
  loads_only   only the TMA ring (no products, no softmax)
  fast_exp     __expf for expf (what the accurate exponential costs)
  fused_passes scale, softcap and mask in one loop with the branches
               inside (the form the kernel left behind)
  heads_first  blocks start with every head's last q tile (kHeadGroup = 64)
  head_by_head one head's q tiles after another's (kHeadGroup = 1)

Prints one line per variant and the card's ``nvidia-smi`` name and power
limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernel's source: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_flash_breakdown.py checks on the CPU that each still
applies.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import bind_launch  # noqa: E402

SRC = build.CSRC / "flash_attention.cu"
OUT = REPO / "build" / "flash_breakdown"

PRODUCT_S = ("      wgmma_ss<BK>(s, kmajor<D>(qwg, kBlockQ, kk), "
             "kmajor<D>(kt, BK, kk),\n                   kk > 0);")
PRODUCT_PV = """      wgmma_rs<D>(o, hi[kk], vd);
      wgmma_rs<D>(o, lo[kk], vd);"""
GROUP = "constexpr int kHeadGroup = 8;"
SOFTMAX_FROM = "    // scale, softcap and mask, each a pass of its own"
SOFTMAX_TO = "    // release the stage:"
PASSES_FROM = ("#pragma unroll\n"
               "    for (int i = 0; i < BK / 2; ++i) s[i] *= p.scale;")
PASSES_TO = "    float alpha[2], sum[2] = {0.f, 0.f};"
FUSED_PASSES = """    const bool whole = kb + BK <= p.sk &&
                       (!p.causal || kb + BK - 1 <= wg_lo) &&
                       (!p.has_window || kb > wg_lo + 63 - p.window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i / 2) % 2;
      float x = s[i] * p.scale;
      if (p.has_softcap) x = __fmul_rn(p.softcap, tanhf(x / p.softcap));
      if (!whole) {
        const int k_pos = kb + 8 * (i / 4) + c0 + i % 2;
        const bool ok = k_pos < p.sk && (!p.causal || k_pos <= qp[h]) &&
                        (!p.has_window || k_pos > qp[h] - p.window);
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
"""


def cut(src: str, start: str, end: str, keep_end=True) -> str:
    """``src`` without the text from ``start`` up to ``end``."""
    i, j = src.index(start), src.index(end)
    return src[:i] + (src[j:] if keep_end else src[j + len(end):])


def variants(src: str) -> dict:
    """{name: source}; each edit must apply."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"the source changed: {old[:40]!r} not found")
        return text.replace(old, new)
    no_products = sub(sub(src, PRODUCT_S, ""), PRODUCT_PV, "")
    i = src.index(PASSES_FROM)
    j = src.index(PASSES_TO)
    return {
        "as_is": src,
        "one_p_term": sub(src, PRODUCT_PV,
                          "      wgmma_rs<D>(o, hi[kk], vd);"),
        "no_products": no_products,
        "loads_only": cut(cut(no_products, SOFTMAX_FROM, SOFTMAX_TO),
                          "    // S = Q K^T on the raw bf16 q", SOFTMAX_TO),
        "fast_exp": sub(sub(src, "= expf(s[i]", "= __expf(s[i]"),
                        "= expf(s[i + 1]", "= __expf(s[i + 1]"),
        "fused_passes": src[:i] + FUSED_PASSES + src[j:],
        "heads_first": sub(src, GROUP, "constexpr int kHeadGroup = 64;"),
        "head_by_head": sub(src, GROUP, "constexpr int kHeadGroup = 1;"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(SRC.read_text()).items():
        src = OUT / f"{name}.cu"
        header = build.CSRC / "hopper.cuh"
        src.write_text(text.replace('#include "hopper.cuh"',
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
        fns[name] = bind_launch(ctypes.CDLL(str(OUT / f"{name}.so")))
    b, h, s, d = 2, 32, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for causal in (1, 0):
        times = {name: [] for name in fns}
        order = list(fns) + list(fns)[::-1]
        for name in order:
            def call():
                err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), None, b * h, s, s, d, 1,
                                causal, 0,
                                0, 0, 0.0, 1 / math.sqrt(d), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            for _ in range(3):
                call()
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 20 * 1e3)
        for name, ts in times.items():
            runs = ", ".join(f"{t:.1f}" for t in ts)
            print(f"flash_breakdown causal={causal} {name}: "
                  f"{min(ts):.1f} us (runs {runs})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
