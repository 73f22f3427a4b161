#!/usr/bin/env python3
"""Where the ``nt_mlp`` and ``fused_nt_scatter`` kernels' time goes, on an
H100.

    python3 experiments/nt_breakdown.py              # this checkout
    python3 experiments/nt_breakdown.py --parent DIR # and another

Builds variants of the NT kernels' sources under
``src/repro_torch/kernels/csrc`` (``nt_mlp.cu`` and ``fused_nt_scatter.cu``
with the headers they include), each a copy of the sources with one part
taken out (a variant with a part taken out returns wrong numbers by
design: these are timing probes, not kernels), and times each as
``chip_smoke.py::time_ms`` does (device time of launches queued behind a
GPU spin), in turns (each variant twice, the sources as they are first and
last), at ``chip_smoke.py``'s phase-5 cases (``nt_cases``, the same seeds
and the serving buckets' own edge streams):

  nt_mlp            GIN's MLP 100->200->100 at N=32, 64 and 1024; the
                    standard point's 64->128->64 at N=1024
  fused_nt_scatter  GIN's MLP on the molhiv (N=32, E=64) and hep (N=64,
                    E=1024) buckets' edges; the standard point N=1024,
                    E=4096, 64->128->64

The variants of the staged design (weights staged on chip through
``dense_tile.cuh``, split-k dense layers, the edge phase overlapped by
programmatic dependent launch):

  as_is       the committed kernels
  no_dense    the dense layers' arithmetic taken out (the weights still
              staged and waited for, the outputs still written)
  no_copies   the weight and x copies and their waits taken out (the dense
              layers run on whatever shared memory holds)
  empty       no copies, no dense arithmetic: launch, set-up and the writes
  no_pdl      fused_nt_scatter's second launch without the programmatic
              stream serialization attribute (it starts when the NT launch
              has drained)
  edge_only   fused_nt_scatter without its NT launch: the edge phase alone

The variants of the earlier design, whose tile reads every weight from L2
inside a serial FMA chain (another checkout's sources, with ``--parent``):
``as_is``, ``no_dense`` (the k loop taken out), ``weights_const`` (each
weight load replaced by a constant: the arithmetic without the loads),
``empty`` (no x staging, no k loop) and ``edge_only``.

The tile variants are timed on both kernels, the fused call's own on
``fused_nt_scatter`` alone. Then this checkout's kernels alone at 1-16
rows per block and at their own choice: ``nt_mlp`` at its four cases, the
NT launch inside ``fused_nt_scatter`` at its three (the edge phase at its
own choice).

Prints one line per variant and case, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the sources: an edit to the lines
they name makes ``variants()`` raise, and tests/test_torch_nt_breakdown.py
checks on the CPU that each variant of this checkout's sources still
applies.
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
from repro_torch.kernels import fused_nt_scatter as tfs  # noqa: E402
from repro_torch.kernels import nt_mlp as tnt  # noqa: E402

OUT = REPO / "build" / "nt_breakdown"
CSRC_REL = Path("src/repro_torch/kernels/csrc")
# kernel: (its C entry point's source, its symbol, its wrapper's module)
ENTRIES = {"nt_mlp": ("nt_mlp.cu", "nt_mlp_launch", tnt),
           "fused_nt_scatter": ("fused_nt_scatter.cu",
                                "fused_nt_scatter_launch", tfs)}
# the files the variants may edit
EDITED = ("dense_tile.cuh", "nt_tile.cuh", "fused_nt_scatter.cu",
          "mp_pipeline.cuh")
FUSED_ONLY = ("no_pdl", "edge_only")

# The staged design (this checkout): (file, old, new) edits.
STAGED_MARK = "dense_tile.cuh"
FMA_OFF = [("dense_tile.cuh", "      for (int r0 = 0; r0 < rows_here;) {",
            "      for (int r0 = 0; r0 < rows_here && p.rows < 0;) {")]
COPIES_OFF = [
    ("nt_tile.cuh", "  issue_first<T>(p, tid);   // land while x is staged\n",
     ""),
    ("nt_tile.cuh",
     "  const bool x_bulk = x_by_bulk<T>(p, row0, rows_here, tid);",
     "  const bool x_bulk = true;"),
    ("nt_tile.cuh", "  mbar_wait(&bars[p.slots + 2], 0);   // x's rows\n",
     ""),
    ("dense_tile.cuh", "    mbar_wait(&bars[slot], phase);\n", ""),
    ("dense_tile.cuh",
     "  mbar_wait(&bars[p.slots + layer], 0);   // the bias\n", ""),
    ("dense_tile.cuh",
     "    if (c + p.slots < total) {   // the block is done with this slot",
     "    if (p.rows < 0) {")]
STAGED_EDITS = {
    "no_dense": FMA_OFF,
    "no_copies": COPIES_OFF,
    "empty": COPIES_OFF + FMA_OFF,
    "no_pdl": [("mp_pipeline.cuh",
                "    attr.val.programmaticStreamSerializationAllowed = 1;",
                "    attr.val.programmaticStreamSerializationAllowed = 0;")],
    "edge_only": [("fused_nt_scatter.cu",
                   "  const int err = launch_nt(m, dtype, rows_nt, st);",
                   "  const int err = 0;")],
}

# The earlier design: the tile reading its weights from L2.
L2_EDITS = {
    "no_dense": [("nt_tile.cuh", "    for (int k = 0; k < d_in; ++k) {",
                  "    for (int k = 0; k < 0; ++k) {")],
    "weights_const": [(
        "nt_tile.cuh",
        "      const float wv = __ldg(w + (size_t)k * d_out + j);",
        "      const float wv = 0.5f;")],
    "edge_only": [("fused_nt_scatter.cu",
                   "  const int err = nt::launch_mlp(m, rows_nt, st);",
                   "  const int err = 0;")],
}
L2_EDITS["empty"] = L2_EDITS["no_dense"] + [(
    "nt_tile.cuh",
    "  for (int i = threadIdx.x; i < rows_pad * p.d_in; i += kThreads) {",
    "  for (int i = threadIdx.x; i < 0; i += kThreads) {")]


def sources(csrc: Path) -> dict:
    """{file: text} of the edited files that ``csrc`` holds."""
    return {name: (csrc / name).read_text() for name in EDITED
            if (csrc / name).exists()}


def staged(srcs: dict) -> bool:
    return STAGED_MARK in srcs


def variants(srcs: dict) -> dict:
    """{name: {file: text}} for the design ``srcs`` is written in; each edit
    must apply."""
    out = {"as_is": dict(srcs)}
    for name, subs in (STAGED_EDITS if staged(srcs) else L2_EDITS).items():
        texts = dict(srcs)
        for where, old, new in subs:
            if old not in texts.get(where, ""):
                raise RuntimeError(f"the source changed: {old[:50]!r} not "
                                   f"found in {where} ({name})")
            texts[where] = texts[where].replace(old, new)
        out[name] = texts
    return out


def cases():
    """{name: (kernel, keyword args of one call)} on the card."""
    graphs = {bucket: cs.edge_stream(batch)
              for _, bucket, batch in cs.serving_buckets()}
    return {f"{kernel} {name}": (kernel, cs.on_device(kw, "cuda"))
            for kernel, by_name in cs.nt_cases(graphs).items()
            for name, kw in by_name.items()}


def run(kernel, kw, **extra):
    if kernel == "nt_mlp":
        return cs.call(tnt.nt_mlp, kw, cs.MLP_POSITIONAL, node_tile=1,
                       k_tile=1, **extra)
    return cs.call(tfs.fused_nt_scatter, kw, cs.FUSED_POSITIONAL,
                   node_tile=1, **extra)


def dtype_codes_dropped(kernel, seq):
    """``seq`` (the wrapper's arguments or argtypes) less the dtype codes
    that the earlier design's entry points do not take: nt_mlp's one
    before the rows and the stream, fused_nt_scatter's two before its two
    rows and the stream."""
    keep = 2 if kernel == "nt_mlp" else 3
    drop = 1 if kernel == "nt_mlp" else 2
    return list(seq[:-(keep + drop)]) + list(seq[-keep:])


def build_variants(tag: str, csrc: Path) -> dict:
    """Build every variant of both entry points in ``csrc`` at once;
    {kernel: {name: launch fn}}. Each variant builds in a directory of its
    own that holds the sources and headers it includes."""
    srcs = sources(csrc)
    design_staged = staged(srcs)
    procs = {}
    for name, texts in variants(srcs).items():
        where = OUT / tag / name
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(csrc, where)
        for file, text in texts.items():
            (where / file).write_text(text)
        for kernel, (entry, _, _) in ENTRIES.items():
            if kernel == "nt_mlp" and name in FUSED_ONLY:
                continue
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                   str(where / f"{kernel}.so"), str(where / entry)]
            procs[kernel, name] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns = {kernel: {} for kernel in ENTRIES}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {tag} {kernel} {name} "
                               f"variant")
        fn = getattr(ctypes.CDLL(str(OUT / tag / name / f"{kernel}.so")),
                     ENTRIES[kernel][1])
        # the wrapper's own argtypes, less the dtype codes that the
        # earlier design takes none of
        types = ENTRIES[kernel][2]._kernel().argtypes
        fn.argtypes = (types if design_staged
                       else dtype_codes_dropped(kernel, types))
        fn.restype = ctypes.c_int
        fns[kernel][f"{tag} {name}"] = (
            fn if design_staged else
            (lambda *a, fn=fn, k=kernel: fn(*dtype_codes_dropped(k, a))))
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose NT kernels are timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nt_breakdown: no CUDA device", file=sys.stderr)
        return 2
    fns = build_variants("this", build.CSRC)
    if args.parent is not None:
        for kernel, more in build_variants("parent",
                                           args.parent / CSRC_REL).items():
            fns[kernel].update(more)
    all_cases = cases()
    for case, (kernel, kw) in all_cases.items():
        mod = ENTRIES[kernel][2]
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
            print(f"{case} {name}: device {ts[0] * 1e3:.2f} / "
                  f"{ts[1] * 1e3:.2f} us (two turns)", flush=True)
    rows_sweep = (None, 1, 2, 3, 4, 6, 8, 12, 16)
    for case, (kernel, kw) in all_cases.items():
        for rows in rows_sweep:
            if kernel == "nt_mlp":
                ms = cs.time_ms(lambda: run(kernel, kw,
                                            rows_per_block=rows))[0]
            else:
                # the NT launch's rows alone; the edge phase at its own
                real = tfs._kernel
                fn = real()
                tfs._kernel = lambda: (lambda *a: fn(*a[:-3], rows or 0,
                                                     *a[-2:]))
                try:
                    ms = cs.time_ms(lambda: run(kernel, kw))[0]
                finally:
                    tfs._kernel = real
            print(f"{case} as_is rows_per_block={rows or 'own'}"
                  f"{' (NT launch)' if kernel != 'nt_mlp' else ''}: device "
                  f"{ms * 1e3:.2f} us", flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
