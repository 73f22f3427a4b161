#!/usr/bin/env python3
"""Where the ``flash_attention_bwd`` kernels' time goes, on an H100.

    python3 experiments/flash_bwd_breakdown.py [--parent DIR]   # times
    python3 experiments/flash_bwd_breakdown.py accuracy  # one term or two

from the root of a checkout.

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``,
each a copy of the source with one part changed, and times each call (both
launches) at the training shapes of ``chip_smoke.py``'s phase 10 between
CUDA events, in turns (each variant twice, the source as it is first and
last):

  as_is         the committed kernels
  split_d128    at D = 128 too, both warpgroups own the same rows or keys
                and each accumulates half the columns (the scores run twice;
                fewer registers)
  two_stages    a ring of two stages at every width (the refill waits for
                the other warpgroup's release of the tile just finished)
  lag0          three stages, but the refill is the stage just finished
  head_by_head  one head's tiles after another's (kHeadGroup = 1)
  two_terms     P and dS as two bf16 terms each, hi + lo, as the forward
                splits P (what a second term would cost, and buy)
  accurate_exp  expf for the exponential by ex2.approx (what the fast one
                saves; its gradients differ in the last bits)
  no_rs         without the register-A products dV, dK, dQ (a probe)
  no_ss         without the shared-memory products S and dP (a probe)

The first four compute the same function in the same order: each prints
whether its gradients equal the source's bit for bit.

The float32 kernels (``x3``: each operand in three bf16 terms on wgmma),
``as_is`` and its variants, at phase 10's float32 training shapes at B=1
(qwen1.5-0.5b, llama3-8b, gemma2-27b's and recurrentgemma-2b's local
layers), each line with its worst gradient's largest difference from
``as_is`` as a share of the gradient's scale:

  two_terms_f32    two bf16 terms of each operand (three products a
                   product, not six: what the third term costs)
  no_fold_f32      dQ, dK and dV straight into their accumulators on the
                   tensor cores, no fresh sum a tile added in float32
  split_only_f32   no products: the loads, the split into planes, the
                   softmax's gradients and the stores alone
  f32_d128_one_wg  at D = 128 one warpgroup owns 64 rows or keys, on
                   32-row tiles (the kernels' choice: two own the same 64,
                   each half the columns, on 64-row tiles)
  f32_d128_two_wg  at D = 128 two warpgroups own 64 rows or keys each, on
                   16-row tiles

With ``--parent DIR`` (a ``git archive`` of another commit, e.g. the parent
under ``build/``), DIR's ``flash_attention_bwd.cu`` is built too and timed
in the same turns as ``parent`` in both groups (its float32 body before
this design was an FMA one). Prints one line per variant and shape, each
variant's ptxas spills, and the card's ``nvidia-smi`` name and power limit.

``accuracy`` builds ``as_is`` and ``two_terms`` alone and holds both against
the plain ``flash_attention_bwd_ref`` on the card: at every bf16 case of
``chip_smoke.py``'s phase 10 (seed 5 gives phase 10's own inputs; 6 and 7
the same draws from other seeds), and at the small cases of
tests/test_torch_flash_bwd_rounding.py (its numpy inputs, seeds 0-7). Each
line gives the worst gradient's error as a share of its scale beside the
2^-7 tolerance (``FLASH_BWD_TOL``).

Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernel's source: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_flash_bwd_breakdown.py checks on the CPU that each still
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _forward_with_lse, bind_bwd_launch, flash_attention_bwd_ref)

SRC = build.CSRC / "flash_attention_bwd.cu"
OUT = REPO / "build" / "flash_bwd_breakdown"

SPLIT = "static constexpr bool kSplit = D == 256;"
STAGES = "static constexpr int kStages = kSplit ? 2 : 3;"
LAG = "static constexpr int kLag = kStages >= 3 ? 1 : 0;"
GROUP = "constexpr int kHeadGroup = 8;     // heads whose tiles start together"
TERMS = "constexpr int kTerms = 1;"
RS = "      wgmma_rs<Cfg<D>::kCols>(d, a[n][kk], b);\n"
EXP = "    s[i] = exp2_approx((s[i] - lse(i)) * kLog2e);"
SS = "      wgmma_ss<64>("
# (B, H, S, D, window, softcap, q scale): phase 10's bf16 training shapes
SHAPES = {
    "qwen1.5-0.5b": (8, 16, 2048, 64, None, None, 1.0),
    "llama3-8b": (1, 32, 2048, 128, None, None, 1.0),
    "gemma2-27b_local": (1, 8, 4096, 128, 4096, 50.0, 50.0),
    "recurrentgemma-2b_local": (1, 10, 4096, 256, 2048, None, 1.0),
}
EXACT = ("as_is", "split_d128", "two_stages", "lag0", "head_by_head")
# the float32 kernels' switches and tiling
TERMS_F32 = "constexpr int kTermsUsed = 3;"
FRESH_F32 = "constexpr bool kFresh = true;"
PRODUCTS_F32 = "constexpr bool kProducts = true;"
WG_F32 = "static constexpr int kWarpgroups = 2;"
SPLIT_F32 = "static constexpr bool kSplit = D >= 128;"
TILE_F32 = "static constexpr int kTile = D == 256 ? 16 : 64;"
F32 = ("two_terms_f32", "no_fold_f32", "split_only_f32", "f32_d128_one_wg",
       "f32_d128_two_wg")
# (B, H, S, D, window, softcap, q scale): phase 10's float32 shapes, B=1
SHAPES_F32 = {
    "qwen1.5-0.5b f32": (1, 16, 2048, 64, None, None, 1.0),
    "llama3-8b f32": (1, 32, 2048, 128, None, None, 1.0),
    "gemma2-27b_local f32": (1, 8, 4096, 128, 4096, 50.0, 50.0),
    "recurrentgemma-2b_local f32": (1, 10, 4096, 256, 2048, None, 1.0),
}


def variants(src: str) -> dict:
    """{name: source}; each edit must apply."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"the source changed: {old[:40]!r} not found")
        return text.replace(old, new)
    return {
        "as_is": src,
        "split_d128": sub(src, SPLIT,
                          "static constexpr bool kSplit = D >= 128;"),
        "two_stages": sub(src, STAGES,
                          "static constexpr int kStages = 2;"),
        "lag0": sub(src, LAG, "static constexpr int kLag = 0;"),
        "head_by_head": sub(src, GROUP, "constexpr int kHeadGroup = 1;"),
        "two_terms": sub(src, TERMS, "constexpr int kTerms = 2;"),
        "accurate_exp": sub(src, EXP, "    s[i] = expf(s[i] - lse(i));"),
        "no_rs": sub(src, RS, ""),
        "no_ss": sub(src, SS, "      if (false) wgmma_ss<64>("),
        "two_terms_f32": sub(src, TERMS_F32,
                             "constexpr int kTermsUsed = 2;"),
        "no_fold_f32": sub(src, FRESH_F32, "constexpr bool kFresh = false;"),
        "split_only_f32": sub(src, PRODUCTS_F32,
                              "constexpr bool kProducts = false;"),
        "f32_d128_one_wg": sub(sub(sub(src, WG_F32, "static constexpr int "
                                       "kWarpgroups = D == 128 ? 1 : 2;"),
                                   SPLIT_F32, "static constexpr bool kSplit "
                                   "= D > 128;"), TILE_F32,
                               "static constexpr int kTile = D == 256 ? 16 "
                               ": D == 128 ? 32 : 64;"),
        "f32_d128_two_wg": sub(sub(src, SPLIT_F32, "static constexpr bool "
                                   "kSplit = D > 128;"), TILE_F32,
                               "static constexpr int kTile = D >= 128 ? 16 "
                               ": 64;"),
    }


def build_variants(only=None, parent=None) -> dict:
    """{name: the variant's bound launch} (the names in ``only``, or all),
    all nvcc runs at once; with ``parent`` (a checkout's root) its source
    too, as ``parent``."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in variants(SRC.read_text()).items():
        if only is not None and name not in only:
            continue
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
                print(f"flash_bwd_breakdown {name}: ptxas {entry}: "
                      f"{line.strip()}")
        fns[name] = bind_bwd_launch(ctypes.CDLL(str(OUT / f"{name}.so")))
    return fns


def launch(fn, q, k, v, out, lse, dout, causal, window, cap):
    """(dq, dk, dv) of one call of a variant's launcher."""
    b, h, sq, d = q.shape
    stats = torch.empty((b * h, 2, -(-sq // 64) * 64), device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq,
             k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
             int(window is not None),
             window or 0, int(cap is not None), float(cap or 0.0),
             1 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return dq, dk, dv


def accuracy() -> None:
    """``as_is`` and ``two_terms`` against the plain backward: one line per
    case, seed and variant."""
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    from chip_smoke import FLASH_BWD_CASES, FLASH_BWD_TOL, flash_bwd_close
    import test_torch_flash_bwd_rounding as rounding
    fns = build_variants(("as_is", "two_terms"))
    tol = FLASH_BWD_TOL["bfloat16"]
    worst = {name: 0.0 for name in fns}

    def report(case, seed, args, kw):
        want = flash_attention_bwd_ref(*args, **kw)
        for name, fn in fns.items():
            got = launch(fn, *args, kw["causal"], kw["window"],
                         kw["softcap"])
            _, rel, ok = flash_bwd_close(got, want, "bfloat16")
            worst[name] = max(worst[name], rel)
            print(f"flash_bwd_breakdown accuracy {case} seed {seed} {name}: "
                  f"{rel:.3e} of scale, {rel / tol:.3f} of the tolerance "
                  f"{tol:g}; {'ok' if ok else 'FAIL'}", flush=True)

    for seed in (5, 6, 7):
        # phase 10's draws, in its order (the float32 case's too)
        g = torch.Generator(device="cuda").manual_seed(seed)
        for case, (b, h, sq, sk, d, causal, window, cap, q_scale, dtype,
                   _) in FLASH_BWD_CASES.items():
            q = (torch.randn(b, h, sq, d, generator=g, device="cuda")
                 * q_scale).to(torch.bfloat16)
            k, v, dout = (torch.randn(b, h, n, d, generator=g,
                                      device="cuda").to(torch.bfloat16)
                          for n in (sk, sk, sq))
            if dtype != "bfloat16":
                continue
            out, lse = _forward_with_lse(q, k, v, causal, window, cap)
            report(case, seed, (q, k, v, out, lse, dout),
                   dict(causal=causal, window=window, softcap=cap))
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
    for case in sorted(rounding.CASES):
        for seed in range(8):
            args, kw = rounding._case(case, seed)
            report(f"small_{case}", seed,
                   tuple(t.cuda().contiguous() for t in args), kw)
    for name, rel in worst.items():
        print(f"flash_bwd_breakdown accuracy worst {name}: {rel:.3e} of "
              f"scale, {rel / tol:.3f} of the tolerance")


def time_shape(fns, names, shape, dtype, exact):
    """Each of ``names`` timed twice in turns at one shape; one line each,
    with whether its gradients equal as_is's (``exact``) or, float32, the
    largest difference from them as a share of each gradient's scale."""
    b, h, s, d, window, cap, q_scale = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn(b, h, s, d, generator=g, device="cuda")
         * q_scale).to(dtype)
    k, v, dout = (torch.randn(b, h, s, d, generator=g, device="cuda")
                  .to(dtype) for _ in range(3))
    out, lse = _forward_with_lse(q, k, v, True, window, cap)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def call(name):
        return launch(fns[name], q, k, v, out, lse, dout, True, window, cap)

    grads = {name: call(name) for name in names}
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        for _ in range(2):
            call(name)
        start.record()
        for _ in range(10):
            call(name)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / 10 * 1e3)
    for name, ts in times.items():
        same = ""
        if name in exact:
            same = ("; bitwise as_is" if all(
                torch.equal(x, y) for x, y in
                zip(grads[name], grads["as_is"])) else "; NOT bitwise")
        elif dtype == torch.float32:
            rel = max(float((x - y).abs().max())
                      / max(1e-30, float(y.abs().max()))
                      for x, y in zip(grads[name], grads["as_is"]))
            same = f"; {rel:.2e} of scale from as_is"
        print(f"flash_bwd_breakdown {name}: {min(ts):.1f} us "
              f"(runs {', '.join(f'{t:.1f}' for t in ts)}){same}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_breakdown: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["accuracy"]:
        accuracy()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose flash_attention_bwd.cu is timed "
                         "too")
    args = ap.parse_args()
    fns = build_variants(parent=args.parent)
    extra = ["parent"] if args.parent is not None else []
    bf16 = [n for n in fns if n not in F32 and n != "parent"] + extra
    for shape, dims in SHAPES.items():
        print(f"flash_bwd_breakdown {shape} bf16:", flush=True)
        time_shape(fns, bf16, dims, torch.bfloat16, EXACT)
    for shape, dims in SHAPES_F32.items():
        print(f"flash_bwd_breakdown {shape}:", flush=True)
        time_shape(fns, ["as_is", *F32, *extra], dims, torch.float32, ())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
