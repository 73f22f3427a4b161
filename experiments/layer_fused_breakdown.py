#!/usr/bin/env python3
"""Where the ``layer_fused`` kernel's time goes, on an H100.

    python3 experiments/layer_fused_breakdown.py              # this checkout
    python3 experiments/layer_fused_breakdown.py --parent DIR # and another

Builds variants of ``src/repro_torch/kernels/csrc/layer_fused.cu``, each a
copy of the source with one part taken out or moved (a variant with a part
taken out returns wrong numbers by design: these are timing probes, not
kernels), and times each as ``chip_smoke.py::time_ms`` does (device time of
launches queued behind a GPU spin), in turns (each variant twice, the
source as it is first and last), at four shapes, each built by
``chip_smoke.py``'s case builders from a seed:

  gin_hep    GIN's self form at the hep serving bucket: N=64, E=1024,
             D=100, MLP 100->200->100
  pna_hep    PNA's scalers form at the hep bucket: D=80, three scalers,
             w1 1040->80
  dgn_hep    DGN's field form at the hep bucket: D=200 (stacked), w1 300->100
  gin_n1024  GIN's self form at N=1024, E=4096

The variants of the staged design (this checkout's source):

  as_is          the committed kernel
  no_dense       the dense layers' arithmetic taken out (the weights are
                 still staged and waited for, the outputs still written)
  no_edges       the edge sweep taken out
  no_copies      the weight copies and their waits taken out (the dense
                 layers run on whatever shared memory holds)
  unstaged       the weight copies issued after the edge sweep instead of at
                 entry (what overlapping them with the sweep saves)
  sweep_only     the edge sweep alone: no copies, no dense arithmetic
  copies_only    the weight copies alone: no sweep, no dense arithmetic
  classify_only  the sweep's classify, scan and list alone (no phi loads,
                 no accumulation), no copies, no dense arithmetic
  empty          no sweep, no copies, no dense arithmetic: launch, set-up
                 and the epilogue's passes

The variants of the earlier design, whose dense layers read the weights
from L2 (another checkout's source, with ``--parent``):
``as_is``, ``no_dense`` (the dense layers' k loops taken out),
``no_edges``, ``empty`` (both) and ``weights_const`` (each weight load from
device memory replaced by a constant: the arithmetic without the loads).

Then the committed kernel alone at 1, 2, 4, 8 and 16 rows per block and
at its own choice, at ``gin_hep``, ``pna_hep`` and ``gin_n1024`` (how
the rows per block were chosen).

Prints one line per variant and shape, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernel's source: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_layer_fused_breakdown.py checks on the CPU that each
variant of this checkout's source still applies.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import layer_fused as lf  # noqa: E402

SRC = build.CSRC / "layer_fused.cu"
OUT = REPO / "build" / "layer_fused_breakdown"
CSRC_REL = Path("src/repro_torch/kernels/csrc")

# the staged design (this checkout)
STAGED_MARK = "bulk_load"
FIRST_COPIES = "  issue_first(p, tid);   // land while the edges are swept\n"
SWEEP_OFF = [("  for (int base = 0; base < p.e; base += kEdgeTile) {",
              "  for (int base = 0; base < 0; base += kEdgeTile) {")]
FMA_OFF = [("      for (int r0 = 0; r0 < rows_here;) {",
            "      for (int r0 = 0; r0 < rows_here && p.n < 0;) {")]
COPIES_OFF = [
    (FIRST_COPIES, ""),
    ("    mbar_wait(&bars[slot], phase);\n", ""),
    ("  mbar_wait(&bars[p.slots + layer], 0);   // the bias\n", ""),
    ("    if (c + p.slots < total) {   // the block is done with this slot",
     "    if (p.n < 0) {")]
ACCUMULATE_OFF = [(
    "    if (group >= groups || (one_row && group >= rows_here)) return;",
    "    if (p.n >= 0) return;")]
STAGED_EDITS = {
    "no_dense": FMA_OFF,
    "no_edges": SWEEP_OFF,
    "no_copies": COPIES_OFF,
    "unstaged": [
        (FIRST_COPIES, ""),
        ("  // 4. the first dense layer's input row",
         "  issue_first(p, tid);\n  // 4. the first dense layer's input row")],
    "sweep_only": COPIES_OFF + FMA_OFF,
    "copies_only": SWEEP_OFF + FMA_OFF,
    "classify_only": COPIES_OFF + FMA_OFF + ACCUMULATE_OFF,
    "empty": SWEEP_OFF + COPIES_OFF + FMA_OFF,
}

# the earlier design: dense layers reading the weights from L2
L2_EDITS = {
    "no_dense": [(
        "      for (int k = 0; k < k_dim; ++k) {",
        "      for (int k = 0; k < 0; ++k) {")],
    "no_edges": [(
        "  for (int base = 0; base < p.e; base += kEdgeTile) {",
        "  for (int base = 0; base < 0; base += kEdgeTile) {")],
    "weights_const": [(
        "        const float wk = w[(size_t)k * n_dim + j];",
        "        const float wk = 0.5f;")],
}
L2_EDITS["empty"] = L2_EDITS["no_edges"] + L2_EDITS["no_dense"]


def variants(src: str) -> dict:
    """{name: source} for the design ``src`` is written in; each edit must
    apply."""
    edits = STAGED_EDITS if STAGED_MARK in src else L2_EDITS
    out = {"as_is": src}
    for name, subs in edits.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"the source changed: {old[:50]!r} not "
                                   f"found ({name})")
            text = text.replace(old, new)
        out[name] = text
    return out


def shapes():
    """{name: keyword args of one layer_fused call} on the card."""
    return {name: cs.on_device(kw, "cuda") for name, kw in (
        ("gin_hep", cs.lf_case(11, 64, 1024, 100, 200, 100)),
        ("pna_hep", cs.lf_scalers_case(12, 64, 1024, 80)),
        ("dgn_hep", cs.lf_field_case(13, 64, 1024, 100)),
        ("gin_n1024", cs.lf_case(14, 1024, 4096, 100, 200, 100)))}


def build_variants(tag: str, src_path: Path) -> dict:
    """Build every variant of ``src_path`` at once; {name: launch fn}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src_path.read_text()).items():
        src = OUT / f"{tag}_{name}.cu"
        for header in src_path.parent.glob("*.cuh"):
            text = text.replace(f'#include "{header.name}"',
                                f'#include "{header}"')
        src.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
               str(OUT / f"{tag}_{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {tag} {name} variant")
        fn = ctypes.CDLL(str(OUT / f"{tag}_{name}.so")).layer_fused_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[f"{tag} {name}"] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose layer_fused.cu is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("layer_fused_breakdown: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants("this", SRC)
    if args.parent is not None:
        fns.update(build_variants("parent",
                                  args.parent / CSRC_REL / "layer_fused.cu"))
    real = lf._kernel
    for shape, kw in shapes().items():
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            lf._kernel = lambda fn=fns[name]: fn
            try:
                cs.call(lf.layer_fused, kw)
                torch.cuda.synchronize()
                times[name].append(cs.time_ms(
                    lambda: cs.call(lf.layer_fused, kw))[0])
            finally:
                lf._kernel = real
        for name, ts in times.items():
            print(f"{shape} {name}: device {ts[0] * 1e3:.2f} / "
                  f"{ts[1] * 1e3:.2f} us (two turns)", flush=True)
    for shape, kw in shapes().items():
        if shape == "dgn_hep":
            continue
        for rows in (None, 1, 2, 4, 8, 16):
            ms = cs.time_ms(lambda: cs.call(lf.layer_fused, kw,
                                            rows_per_block=rows))[0]
            print(f"{shape} as_is rows_per_block={rows or 'own'}: device "
                  f"{ms * 1e3:.2f} us", flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
