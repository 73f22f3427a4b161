#!/usr/bin/env python3
"""Where the ``flash_attention`` kernels' time goes, on an H100.

    python3 experiments/flash_breakdown.py [--parent DIR]
                                          # from the root of a checkout

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each a copy of the source with one part changed or taken out (the results
of most are wrong by design: these are timing probes, not kernels), and
times them between CUDA events, in turns (each variant twice, the source as
it is first and last). The bf16 variants at llama3-8b's prefill shape
(B=2, H=32, S=2048, D=128, bf16), causal and not:

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

The float32 kernel (``x3``: each operand in three bf16 terms on wgmma),
``as_is`` and its variants, at llama3-8b's prefill at B=1 (H=32, S=2048,
D=128, causal) and gemma2-27b's local layer (H=32, S=8192, window 4096,
softcap 50, q scaled by 50), float32:

  two_terms_f32   two bf16 terms of each operand (three products a
                  product, not six: what the third term costs)
  no_fold_f32     P.V straight into O on the tensor cores, no fresh sum a
                  kv tile folded by FMAs (what the fold costs)
  split_only_f32  no products: the loads, the split into planes, the
                  softmax and the stores alone

With ``--parent DIR`` (a ``git archive`` of another commit, e.g. the parent
under ``build/``), DIR's ``flash_attention.cu`` is built too and timed in
the same turns as ``parent`` in both groups (its float32 body before this
design was an FMA one). Prints one line per variant and shape, each
float32 line with its largest difference from ``as_is``, and the card's
``nvidia-smi`` name and power limit. Needs nvcc and one CUDA device;
imports nothing of JAX.

The variants are exact-text edits of the kernel's source: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_flash_breakdown.py checks on the CPU that each still
applies.
"""

from __future__ import annotations

import argparse
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


TERMS_F32 = "constexpr int kTermsUsed = 3;"
FRESH_F32 = "constexpr bool kFresh = true;"
PRODUCTS_F32 = "constexpr bool kProducts = true;"
F32 = ("two_terms_f32", "no_fold_f32", "split_only_f32")


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
        "two_terms_f32": sub(src, TERMS_F32,
                             "constexpr int kTermsUsed = 2;"),
        "no_fold_f32": sub(src, FRESH_F32, "constexpr bool kFresh = false;"),
        "split_only_f32": sub(src, PRODUCTS_F32,
                              "constexpr bool kProducts = false;"),
    }


def build_variants(parent=None) -> dict:
    """{name: the variant's bound launch}, all nvcc runs at once; with
    ``parent`` (a checkout's root) its source too, as ``parent``."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants(SRC.read_text()).items():
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(text)
    if parent is not None:
        sources["parent"] = (parent / SRC.relative_to(REPO)).resolve()
    procs = {}
    for name, src in sources.items():
        # the source's own directory first, then this checkout's headers
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
               "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {name} variant")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "spill stores" in line and not line.strip().startswith("0 "):
                print(f"flash_breakdown {name}: ptxas {entry}: "
                      f"{line.strip()}")
        fns[name] = bind_launch(ctypes.CDLL(str(OUT / f"{name}.so")))
    return fns


def time_group(fns, names, args, label, reps=20):
    """Each of ``names`` timed twice in turns on the same inputs; one line
    each (float32: with its largest difference from as_is)."""
    q, k, v, causal, window, cap = args
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def call(name):
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None, b * h, s, s, d,
                        int(q.dtype == torch.bfloat16), int(causal),
                        int(window is not None), window or 0,
                        int(cap is not None), float(cap or 0.0),
                        1 / math.sqrt(d), stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    outs = {}
    for name in names:
        call(name)
        outs[name] = out.clone()
    times = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        for _ in range(3):
            call(name)
        start.record()
        for _ in range(reps):
            call(name)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / reps * 1e3)
    for name, ts in times.items():
        diff = ""
        if q.dtype == torch.float32:
            diff = (f"; max |out - as_is| "
                    f"{float((outs[name] - outs['as_is']).abs().max()):.3e}")
        runs = ", ".join(f"{t:.1f}" for t in ts)
        print(f"flash_breakdown {label} {name}: {min(ts):.1f} us "
              f"(runs {runs}){diff}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose flash_attention.cu is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants(args.parent)
    extra = ["parent"] if args.parent is not None else []
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = 2, 32, 2048, 128
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    bf16 = [n for n in fns if n not in F32 and n != "parent"] + extra
    for causal in (1, 0):
        time_group(fns, bf16, (q, k, v, causal, None, None),
                   f"causal={causal}")
    del q, k, v
    f32 = ["as_is", *F32, *extra]
    for label, (h, s, window, cap, q_scale, reps) in {
            "f32 llama3-8b B=1": (32, 2048, None, None, 1.0, 20),
            "f32 gemma2-27b local": (32, 8192, 4096, 50.0, 50.0, 3)}.items():
        q = torch.randn(1, h, s, d, generator=g, device="cuda") * q_scale
        k, v = (torch.randn(1, h, s, d, generator=g, device="cuda")
                for _ in range(2))
        time_group(fns, f32, (q, k, v, 1, window, cap), label, reps)
        del q, k, v
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
