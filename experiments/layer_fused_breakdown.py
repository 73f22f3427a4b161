#!/usr/bin/env python3
"""Where the ``layer_fused`` kernel's time goes, on an H100.

    python3 experiments/layer_fused_breakdown.py              # this checkout
    python3 experiments/layer_fused_breakdown.py --parent DIR # and another

Builds variants of ``src/repro_torch/kernels/csrc/layer_fused.cu`` and of
the dense tile it includes (``csrc/dense_tile.cuh``: the weight staging
and the split-k dense layers), each a copy of the sources with one part
taken out or moved (a variant with a part taken out returns wrong numbers
by design: these are timing probes, not kernels), and times each as ``chip_smoke.py::time_ms`` does (device time of
launches queued behind a GPU spin), in turns (each variant twice, the
source as it is first and last), at four shapes, each built by
``chip_smoke.py``'s case builders from a seed:

  gin_hep    GIN's self form at the hep serving bucket: N=64, E=1024,
             D=100, MLP 100->200->100
  pna_hep    PNA's scalers form at the hep bucket: D=80, three scalers,
             w1 1040->80
  dgn_hep    DGN's field form at the hep bucket: D=200 (stacked), w1 300->100
  gin_n1024  GIN's self form at N=1024, E=4096

The variants of the staged design (this checkout's sources):

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

The same variants of the staged design written in one file, before the
dense tile moved to its header (another checkout's source, with
``--parent``, e.g. a ``git archive`` of the parent commit under
``build/``).

Then the committed kernel alone at 1, 2, 4, 8 and 16 rows per block and
at its own choice, at ``gin_hep``, ``pna_hep`` and ``gin_n1024`` (how
the rows per block were chosen). With ``--parent``, last, both ``as_is``
kernels on every layer_fused case of ``chip_smoke.py``'s phase 3 (its
synthetic cases and what the six models' paths hand the kernel at both
buckets), each output's sha256, and whether the two are bitwise equal.

Prints one line per variant and shape, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernel's sources, each applied
to whichever of ``layer_fused.cu`` and ``dense_tile.cuh`` holds its text:
an edit to the lines they name makes ``variants()`` raise, and
tests/test_torch_layer_fused_breakdown.py checks on the CPU that each
variant of this checkout's sources still applies.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
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

OUT = REPO / "build" / "layer_fused_breakdown"
CSRC_REL = Path("src/repro_torch/kernels/csrc")
# the files the variants edit: the kernel and, once it exists, its dense tile
FILES = ("layer_fused.cu", "dense_tile.cuh")

FIRST_COPIES = "  issue_first(p, tid);   // land while the edges are swept\n"
SWEEP_OFF = [("  for (int base = 0; base < p.e; base += kEdgeTile) {",
              "  for (int base = 0; base < 0; base += kEdgeTile) {")]
ACCUMULATE_OFF = [(
    "    if (group >= groups || (one_row && group >= rows_here)) return;",
    "    if (p.n >= 0) return;")]


def staged_edits(off: str) -> dict:
    """The variants' edits, ``off`` a condition false at run time in the
    dense layers' scope (``p.n < 0`` where they share the kernel's Args,
    ``p.rows < 0`` in the header's Tile)."""
    fma_off = [("      for (int r0 = 0; r0 < rows_here;) {",
                f"      for (int r0 = 0; r0 < rows_here && {off};) {{")]
    copies_off = [
        (FIRST_COPIES, ""),
        ("    mbar_wait(&bars[slot], phase);\n", ""),
        ("  mbar_wait(&bars[p.slots + layer], 0);   // the bias\n", ""),
        ("    if (c + p.slots < total) {   // the block is done with this slot",
         f"    if ({off}) {{")]
    return {
        "no_dense": fma_off,
        "no_edges": SWEEP_OFF,
        "no_copies": copies_off,
        "unstaged": [
            (FIRST_COPIES, ""),
            ("  // 4. the first dense layer's input row",
             "  issue_first(p, tid);\n  // 4. the first dense layer's input "
             "row")],
        "sweep_only": copies_off + fma_off,
        "copies_only": SWEEP_OFF + fma_off,
        "classify_only": copies_off + fma_off + ACCUMULATE_OFF,
        "empty": SWEEP_OFF + copies_off + fma_off,
    }


def sources(csrc: Path) -> dict:
    """{file: text} of the edited files that ``csrc`` holds."""
    return {name: (csrc / name).read_text() for name in FILES
            if (csrc / name).exists()}


def variants(srcs: dict) -> dict:
    """{name: {file: text}}; each edit must apply to one of the files."""
    edits = staged_edits("p.rows < 0" if "dense_tile.cuh" in srcs
                         else "p.n < 0")
    out = {"as_is": dict(srcs)}
    for name, subs in edits.items():
        texts = dict(srcs)
        for old, new in subs:
            where = [f for f, text in texts.items() if old in text]
            if not where:
                raise RuntimeError(f"the source changed: {old[:50]!r} not "
                                   f"found ({name})")
            texts[where[0]] = texts[where[0]].replace(old, new)
        out[name] = texts
    return out


def shapes():
    """{name: keyword args of one layer_fused call} on the card."""
    return {name: cs.on_device(kw, "cuda") for name, kw in (
        ("gin_hep", cs.lf_case(11, 64, 1024, 100, 200, 100)),
        ("pna_hep", cs.lf_scalers_case(12, 64, 1024, 80)),
        ("dgn_hep", cs.lf_field_case(13, 64, 1024, 100)),
        ("gin_n1024", cs.lf_case(14, 1024, 4096, 100, 200, 100)))}


def build_variants(tag: str, csrc: Path) -> dict:
    """Build every variant of the sources in ``csrc`` at once; {name: launch
    fn}. Each variant builds in a directory of its own that holds the
    sources and headers it includes."""
    procs = {}
    for name, texts in variants(sources(csrc)).items():
        where = OUT / tag / name
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(csrc, where)
        for file, text in texts.items():
            (where / file).write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
               str(where / "variant.so"), str(where / "layer_fused.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {tag} {name} variant")
        fn = ctypes.CDLL(str(OUT / tag / name / "variant.so")
                         ).layer_fused_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[f"{tag} {name}"] = fn
    return fns


def compare_outputs(this, parent):
    """Both kernels on every layer_fused case of chip_smoke.py's phase 3;
    prints each output's sha256; returns (cases bitwise equal, cases)."""
    cases = cs.lf_cases()
    for name, kw in cs.record_main_inputs()[0]["layer_fused"].items():
        cases[name] = cs.to_numpy(kw)
    real = lf._kernel
    same = 0
    for name, kw_np in cases.items():
        kw = cs.lf_on_device(name, kw_np)
        outs = []
        for fn in (this, parent):
            lf._kernel = lambda fn=fn: fn
            try:
                outs.append(cs.call(lf.layer_fused, kw))
            finally:
                lf._kernel = real
        torch.cuda.synchronize()
        digest = [hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()
                  for o in outs]
        same += torch.equal(*outs)
        print(f"{name}: sha256 this {digest[0]} parent {digest[1]}"
              f"{'' if torch.equal(*outs) else ' DIFFER'}", flush=True)
    return same, len(cases)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose layer_fused.cu is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("layer_fused_breakdown: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants("this", build.CSRC)
    if args.parent is not None:
        fns.update(build_variants("parent", args.parent / CSRC_REL))
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
    if args.parent is not None:
        same = compare_outputs(fns["this as_is"], fns["parent as_is"])
        print(f"this and parent as_is bitwise equal on {same[0]} of "
              f"{same[1]} phase-3 cases", flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
