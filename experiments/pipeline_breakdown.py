#!/usr/bin/env python3
"""Where the ``mp_pipeline`` and ``seg_softmax`` kernels' time goes, on an
H100.

    python3 experiments/pipeline_breakdown.py              # this checkout
    python3 experiments/pipeline_breakdown.py --parent DIR # and another

Builds variants of ``src/repro_torch/kernels/csrc/mp_pipeline.cuh`` (the
edge phase's kernel, built through its C entry point ``mp_pipeline.cu``)
and of ``csrc/seg_softmax.cu``, each a copy of the source with one part
taken out (a variant with a part taken out returns wrong numbers by
design: these are timing probes, not kernels), and times each as
``chip_smoke.py::time_ms`` does (device time of launches queued behind a
GPU spin), in turns (each variant twice, the source as it is first and
last), at these shapes, each built by ``chip_smoke.py``'s case builders
from a seed:

  gat_hep     GAT's attention at the hep serving bucket: N=64, E=1024,
              D=64, H=4, the sum alone
  gat_molhiv  the same at the molhiv bucket: N=32, E=64
  gat_n1024   the same at N=1024, E=4096
  gin_hep     GIN's pipeline edge phase at hep: D=100, edge term + relu
  pna_hep     PNA's: D=80, edge term + bias + relu, sum, sumsq, max, min
  dgn_hep     DGN's: D=200, full (E, 200) src_weight, the sum
  ss_hep      seg_softmax of GAT's (E, 4) logits at hep: N=64, E=1024
  ss_n1024    the same at N=1024, E=4096

The variants, for either design of either kernel:

  as_is          the committed kernel
  no_exp         the attention's (seg_softmax's) exponentials replaced by
                 their arguments: the fold without them
  classify_only  the edges classified (compacted, or bucketed by owner) but
                 not folded
  empty          nothing classified or folded: launch, set-up and the
                 writes
and for one design alone:
  no_att_pass    mp_pipeline's attention pass (logits, max, exponentials)
                 taken out, the fold kept (the bucketed design)
  stats_only     seg_softmax's first launch alone (the earlier design's
                 statistics launch; the one-launch design has no second)

Then each committed kernel alone at 1, 2, 4, 8 and 16 rows per block and
at its own choice, at ``gat_hep``, ``gin_hep``, ``gat_n1024``, ``ss_hep``
and ``ss_n1024``.

Prints one line per variant and shape, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the kernels' sources: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_pipeline_breakdown.py checks on the CPU that each variant
of this checkout's sources still applies.
"""

from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import mp_pipeline as mp  # noqa: E402
from repro_torch.kernels import seg_softmax as ss  # noqa: E402

OUT = REPO / "build" / "pipeline_breakdown"
CSRC_REL = Path("src/repro_torch/kernels/csrc")
# kernel: (the file the variants edit, the C entry point built, its symbol)
SOURCES = {"mp_pipeline": ("mp_pipeline.cuh", "mp_pipeline.cu",
                           "mp_pipeline_launch"),
           "seg_softmax": ("seg_softmax.cu", "seg_softmax.cu",
                           "seg_softmax_launch")}
ARGTYPES = {
    "mp_pipeline": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "seg_softmax": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p],
}
MODULES = {"mp_pipeline": mp, "seg_softmax": ss}

# The bucketed design (this checkout): each block buckets its rows' edges
# and folds each row's segment.
BUCKET_MARK = "bucket_edges"
BUCKET_EDITS = {
    "mp_pipeline": {
        "no_exp": [("      const float pe = expf(__fsub_rn(lg, m_h));",
                    "      const float pe = __fsub_rn(lg, m_h);")],
        "no_att_pass": [("    attention_weights(p, row0, rows_here);\n",
                         "")],
        "classify_only": [(
            "    fold_tile<F>(p, base, row0, rows_here, base == 0, "
            "base + p.tile >= p.e);\n", "")],
        "empty": [(
            "  for (int base = 0; base == 0 || base < p.e; base += p.tile) {",
            "  for (int base = 0; base < 0; base += p.tile) {")],
    },
    "seg_softmax": {
        "no_exp": [("      const float pe = expf(__fsub_rn(l[u], m));",
                    "      const float pe = __fsub_rn(l[u], m);")],
        "classify_only": [
            ("    for (int r = warp; r < rows_here; r += kWarps) "
             "row_stats(p, base, r);\n", ""),
            ("    for (int r = warp; r < rows_here; r += kWarps) "
             "row_weights(p, base, r);\n", "")],
        "empty": [("  for (int base = 0; base < p.e; base += kTileEdges) {",
                   "  for (int base = 0; base < 0; base += kTileEdges) {")],
    },
}
# The earlier design (another checkout, with --parent): each owner block
# compacts the whole stream, tile by tile, and every lane walks the list.
SWEEP_LOOP = "  for (int base = 0; base < p.e; base += kEdgeTile) {"
SWEEP_EDITS = {
    "mp_pipeline": {
        "no_exp": [
            ("              const float corr = expf(__fsub_rn(m_old, m_new));",
             "              const float corr = __fsub_rn(m_old, m_new);"),
            ("              const float pe = "
             "expf(__fsub_rn(logit[u], m_new));",
             "              const float pe = __fsub_rn(logit[u], m_new);")],
        "classify_only": [(
            "    if (group < groups) {\n      for (int dd = lane0;",
            "    if (p.n < 0) {\n      for (int dd = lane0;")],
        "empty": [(SWEEP_LOOP,
                   "  for (int base = 0; base < 0; base += kEdgeTile) {")],
    },
    "seg_softmax": {
        "no_exp": [
            ("              m_old == -INFINITY ? 0.f : "
             "expf(__fsub_rn(m_old, m_new));",
             "              m_old == -INFINITY ? 0.f : "
             "__fsub_rn(m_old, m_new);"),
            ("          const float pe = l == -INFINITY ? 0.f : "
             "expf(__fsub_rn(l, m_new));",
             "          const float pe = l == -INFINITY ? 0.f : "
             "__fsub_rn(l, m_new);")],
        "classify_only": [(
            "    if (group < groups) {\n      for (int hh = lane0;",
            "    if (p.n < 0) {\n      for (int hh = lane0;")],
        "empty": [(SWEEP_LOOP,
                   "  for (int base = 0; base < 0; base += kEdgeTile) {")],
        "stats_only": [(
            "  seg_softmax_norm_kernel<<<blocks, kThreads, 0, st>>>(p);\n",
            "")],
    },
}


def variants(kernel: str, src: str) -> dict:
    """{name: source} of ``kernel`` for the design ``src`` is written in;
    each edit must apply."""
    edits = (BUCKET_EDITS if BUCKET_MARK in src else SWEEP_EDITS)[kernel]
    out = {"as_is": src}
    for name, subs in edits.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"the source changed: {old[:50]!r} not "
                                   f"found ({kernel} {name})")
            text = text.replace(old, new)
        out[name] = text
    return out


def shapes():
    """{name: (kernel, keyword args of one call)} on the card."""
    gat = dict(stats=("sum",), heads=4)
    cases = {
        "gat_hep": ("mp_pipeline", cs.mp_case(41, 64, 1024, 64, **gat)),
        "gat_molhiv": ("mp_pipeline", cs.mp_case(42, 32, 64, 64, **gat)),
        "gat_n1024": ("mp_pipeline", cs.mp_case(43, 1024, 4096, 64, **gat)),
        "gin_hep": ("mp_pipeline", cs.mp_case(
            44, 64, 1024, 100, stats=("sum",), edge_term=True, relu=True)),
        "pna_hep": ("mp_pipeline", cs.mp_case(
            45, 64, 1024, 80, stats=("sum", "sumsq", "max", "min"),
            edge_term=True, bias=True, relu=True)),
        "dgn_hep": ("mp_pipeline", cs.mp_case(46, 64, 1024, 200,
                                              stats=("sum",), sw="full")),
        "ss_hep": ("seg_softmax", cs.scatter_case(47, 64, 1024, 4,
                                                  kernel="seg_softmax")),
        "ss_n1024": ("seg_softmax", cs.scatter_case(48, 1024, 4096, 4,
                                                    kernel="seg_softmax")),
    }
    return {name: (k, cs.on_device(kw, "cuda"))
            for name, (k, kw) in cases.items()}


def run(kernel, kw, **extra):
    return cs.call(MODULES[kernel].__dict__[kernel], kw,
                   cs.KERNEL_POSITIONAL[kernel], **extra)


def build_variants(tag: str, csrc: Path) -> dict:
    """Build every variant of both kernels in ``csrc`` at once; {kernel:
    {name: launch fn}}. Each variant builds in a directory of its own that
    holds the sources and headers it includes."""
    procs = {}
    for kernel, (edited, entry, _) in SOURCES.items():
        for name, text in variants(kernel, (csrc / edited).read_text()
                                   ).items():
            where = OUT / tag / kernel / name
            shutil.rmtree(where, ignore_errors=True)
            shutil.copytree(csrc, where)
            (where / edited).write_text(text)
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                   str(where / "variant.so"), str(where / entry)]
            procs[kernel, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns = {kernel: {} for kernel in SOURCES}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {tag} {kernel} {name} "
                               f"variant")
        fn = getattr(ctypes.CDLL(str(OUT / tag / kernel / name /
                                     "variant.so")), SOURCES[kernel][2])
        fn.argtypes = ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        fns[kernel][f"{tag} {name}"] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose two kernels are timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_breakdown: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants("this", build.CSRC)
    if args.parent is not None:
        for kernel, more in build_variants("parent",
                                           args.parent / CSRC_REL).items():
            fns[kernel].update(more)
    for shape, (kernel, kw) in shapes().items():
        mod = MODULES[kernel]
        real = mod._kernel
        names = list(fns[kernel])
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            mod._kernel = lambda fn=fns[kernel][name]: fn
            try:
                run(kernel, kw)
                torch.cuda.synchronize()
                times[name].append(cs.time_ms(lambda: run(kernel, kw))[0])
            finally:
                mod._kernel = real
        for name, ts in times.items():
            print(f"{shape} {name}: device {ts[0] * 1e3:.2f} / "
                  f"{ts[1] * 1e3:.2f} us (two turns)", flush=True)
    for shape, (kernel, kw) in shapes().items():
        if shape not in ("gat_hep", "gin_hep", "gat_n1024", "ss_hep",
                         "ss_n1024"):
            continue
        for rows in (None, 1, 2, 4, 8, 16):
            ms = cs.time_ms(lambda: run(kernel, kw, rows_per_block=rows))[0]
            print(f"{shape} as_is rows_per_block={rows or 'own'}: device "
                  f"{ms * 1e3:.2f} us", flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
