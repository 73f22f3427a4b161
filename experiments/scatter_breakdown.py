#!/usr/bin/env python3
"""Where the ``mp_scatter`` kernel's time goes, on an H100.

    python3 experiments/scatter_breakdown.py               # this checkout
    python3 experiments/scatter_breakdown.py --parent DIR  # and another
    python3 experiments/scatter_breakdown.py --only crossover

Builds variants of ``src/repro_torch/kernels/csrc/mp_scatter.cu`` and of
the ring it includes (``csrc/long_rows.cuh``), each a copy of the sources
with one part taken out or changed (a variant with a part taken out returns
wrong sums by design: these are timing probes, not kernels), and times each
as ``chip_smoke.py::time_ms`` does (device time of launches queued behind a
GPU spin), in turns (each variant twice, the source as it is first and
last), at the shapes of ``shapes()``: the olmoe-1b-7b MoE dispatch and
combine at phase 6's, the served prefill's (2 x 2048 tokens: 32,768
assignments into 40,960 slots, then 4,096 tokens) and decode's sizes, GIN at the molhiv and hep
serving buckets and at N=1024, GAT ``kernel`` at the packed buckets of 8
and 64 graphs, PNA's and DGN's sweeps at hep, and the long rows: a 5,000-
edge hub (f32 D=100, bf16 D=2048, all five statistics), every edge to one
row, a hub at E=4,096 (the block form) and rows of 129 edges throughout
(E=65,536). Each shape runs the form the wrapper picks
(``kernels/mp_scatter.py::launch_form``).

  as_is          the committed kernel
  no_fold        the folds taken out: the grid form's warps fold no item,
                 the ring's owners fold nothing (the copies, barriers and
                 writes stay)
  barriers_only  the grid form's phases 0-3 replaced by four bare grid
                 barriers and nothing after them; the block form as
                 no_fold
  grid_form      the grid form at every size
  no_copies      the ring's copies taken out (its barriers and folds stay,
                 on whatever shared memory holds): what streaming the rows
                 through the ring costs
  sort_only      the grid form's long rows sorted (each unit's bitmap sort)
                 but not streamed or folded
  no_units       the grid form's phase 5 taken out: the bucketing and the
                 short rows alone
  sort_bits_only sort_only without the sort's listing: each unit's bitmap
                 set, counted and scanned, nothing listed

With ``--parent`` (e.g. a ``git archive`` of the parent commit under
``build/``), that checkout's kernel too, as it is, at every shape, in turns
with this one (this, parent, parent, this), and both on every case of
``chip_smoke.py``'s phase 3 for mp_scatter and mp_scatter_multi: whether
the two are bitwise equal. A parent whose launcher takes no form (the
cooperative launch with block-local buckets of PR 18) gets the arguments it
had. Also with ``--parent``: the machine code (``cuobjdump -sass``) of the
other kernels that include ``csrc/edge_buckets.cuh`` (mp_pipeline,
seg_softmax, layer_fused, fused_nt_scatter), this checkout's against the
parent's, instruction by instruction: identical code computes the same
bits in the same time. Then, with ``--only crossover`` or by default, the
committed kernel in each form at N = 256, 1,024, 2,048, 4,096 and 8,192
(E = 2N, D = 100 f32 and D = 64), at its own rows per block and at 1, 3, 8
and 16 (the block form where it applies: E <= 4,096).

Prints one line per variant and shape, and the card's ``nvidia-smi`` name
and power limit. Needs nvcc and one CUDA device; imports nothing of JAX.

The variants are exact-text edits of the sources, each applied to whichever
of ``mp_scatter.cu`` and ``long_rows.cuh`` holds its text: an edit to the
lines they name makes ``variants()`` raise, and
tests/test_torch_scatter_breakdown.py checks on the CPU that each still
applies.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import mp_scatter as ms  # noqa: E402

OUT = REPO / "build" / "scatter_breakdown"
CSRC_REL = Path("src/repro_torch/kernels/csrc")
FILES = ("mp_scatter.cu", "long_rows.cuh")

FOLD_OFF = [("        for (int k = 0; k < here; ++k) {",
             "        for (int k = 0; k < here && p.n < 0; ++k) {"),
            ("if (!owns) return;", "if (owns || !owns) return;"),
            ("              if (owns) {\n"
             "                long_rows::fold_range(",
             "              if (owns && p.n < 0) {\n"
             "                long_rows::fold_range(")]
BARRIERS = [(
    "    buckets::bucket_edges(g, b, [&](int row, int start, int len) {\n",
    "    for (int k = 0; k < 4; ++k) cooperative_groups::this_grid().sync();\n"
    "    if (p.n > 0) return;\n"
    "    buckets::bucket_edges(g, b, [&](int row, int start, int len) {\n")]
GRID_FORM = [("  if (p.n <= 0) return 0;\n  if (form == 1) {",
              "  if (p.n <= 0) return 0;\n  form = 1;\n  if (form == 1) {")]
COPIES_OFF = [
    ("  const int bytes = c.cw * c.es;\n",
     "  if (c.d > 0) return;\n  const int bytes = c.cw * c.es;\n"),
    ("      if (mine < fit) {", "      if (mine < fit && c.d < 0) {")]
NO_UNITS = [("    for (long long u = blockIdx.x; u < units; u += gridDim.x) {",
             "    for (long long u = blockIdx.x; u < units && p.n < 0;"
             " u += gridDim.x) {")]
SORT_ONLY = [("        long_rows::stream<kStage, kSlots>(\n"
              "            c, ids, cnt,",
              "        if (p.n < 0) long_rows::stream<kStage, kSlots>(\n"
              "            c, ids, cnt,")]
SORT_BITS = SORT_ONLY + [
    ("    for (int p0 = 0; p0 < total; p0 += kList) {",
     "    for (int p0 = 0; p0 < total && len < 0; p0 += kList) {")]


def sources(csrc: Path) -> dict:
    return {f: (csrc / f).read_text() for f in FILES if (csrc / f).exists()}


def variants(srcs: dict) -> dict:
    """{name: {file: source}}; each edit must apply to one of the files."""
    def edited(edits):
        out = dict(srcs)
        for old, new in edits:
            hits = [f for f, text in out.items() if old in text]
            if not hits:
                raise RuntimeError(f"the source changed: {old[:40]!r} not "
                                   f"found")
            out[hits[0]] = out[hits[0]].replace(old, new)
        return out
    return {
        "as_is": dict(srcs),
        "no_fold": edited(FOLD_OFF),
        "barriers_only": edited(FOLD_OFF + BARRIERS),
        "grid_form": edited(GRID_FORM),
        "no_copies": edited(COPIES_OFF),
        "sort_only": edited(SORT_ONLY),
        "no_units": edited(NO_UNITS),
        "sort_bits_only": edited(SORT_BITS),
    }


class Kernel:
    """One build's mp_scatter_launch / mp_scatter_multi_launch. ``forms``:
    whether its launchers take the form and one scratch pointer (this
    design) or three scratch pointers and no form (PR 18's)."""

    def __init__(self, lib: Path, forms: bool):
        self.lib = ctypes.CDLL(str(lib))
        self.forms = forms
        tail = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 2 if forms
                else [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
        for name, outs in (("mp_scatter_launch", 1),
                           ("mp_scatter_multi_launch", 5)):
            fn = getattr(self.lib, name)
            fn.argtypes = [ctypes.c_void_p] * (3 + outs) + tail
            fn.restype = ctypes.c_int

    def __call__(self, case, rows=None, form=None):
        """Launch on ``case`` (shape()'s dict) on the current stream."""
        msg, rcv, mask, n = case["msg"], case["rcv"], case["mask"], case["n"]
        e, d = msg.shape
        bf16 = int(msg.dtype == torch.bfloat16)
        multi = case["stats"] is not None
        stream = torch.cuda.current_stream().cuda_stream
        outs = ([case["out"].get(s) for s in ms.MULTI_STATS] if multi
                else [case["out"]["sum"]])
        ptrs = [msg.data_ptr(), rcv.data_ptr(), mask.data_ptr()] + [
            None if o is None else o.data_ptr() for o in outs]
        fn = (self.lib.mp_scatter_multi_launch if multi
              else self.lib.mp_scatter_launch)
        scratch = case["scratch"].data_ptr()
        if self.forms:
            form = form or form_of(case, rows)
            r = (ms.block_rows(n, d, msg.dtype, rows, sms())
                 if form == "block" else rows or 0)
            err = fn(*ptrs, n, e, d, r, bf16, int(form == "grid"),
                     scratch, stream)
        else:
            err = fn(*ptrs, n, e, d, rows or 0, bf16, scratch,
                     scratch + 4 * n, scratch + 4 * (2 * n + 1), stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return case["out"]


def sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def form_of(case, rows=None) -> str:
    msg = case["msg"]
    return ms.launch_form(case["n"], msg.shape[0], msg.shape[1], msg.dtype,
                          case["stats"] is not None, rows, sms())


def build_kernels(tag: str, csrc: Path, names) -> dict:
    """Build the named variants of the sources in ``csrc`` at once, each in
    a directory of its own holding every source and header; {"tag name":
    Kernel}."""
    srcs = sources(csrc)
    forms = "long_rows.cuh" in srcs
    todo = ({"as_is": srcs} if tuple(names) == ("as_is",)
            else {k: v for k, v in variants(srcs).items() if k in names})
    procs = {}
    for name, texts in todo.items():
        where = OUT / tag / name
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(csrc, where)
        for file, text in texts.items():
            (where / file).write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
               str(where / "variant.so"), str(where / "mp_scatter.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / tag / name / "ptxas.log").write_text(log)
        if proc.returncode:
            print(log, file=sys.stderr)
            raise RuntimeError(f"nvcc failed on the {tag} {name} variant")
        fns[f"{tag} {name}"] = Kernel(OUT / tag / name / "variant.so", forms)
    return fns


def on_card(kw, stats=None, dtype="float32", scratch_for=None):
    """A case on the card from a numpy dict of ``chip_smoke.scatter_case``'s
    keys: messages as ``dtype``, outputs and a scratch large enough for
    either design and form."""
    msg = torch.from_numpy(kw["msg"]).cuda().to(getattr(torch, dtype))
    n = kw["num_nodes"]
    e, d = msg.shape
    widths = {"sum": d, "sumsq": d, "count": 1, "max": d, "min": d}
    if stats is None:
        out = {"sum": torch.empty((n, d), dtype=msg.dtype, device="cuda")}
    else:
        out = {s: torch.empty((n, widths[s]), device="cuda") for s in stats}
    return {"msg": msg, "rcv": torch.from_numpy(kw["receivers"]).cuda(),
            "mask": torch.from_numpy(kw["edge_mask"]).cuda(), "n": n,
            "stats": stats, "out": out,
            "scratch": torch.empty(ms.scratch_ints(n, e, "grid"),
                                   dtype=torch.int32, device="cuda")}


def moe(seed, e, d, slots, per_token):
    """The MoE dispatch (``per_token`` 0: each of ``slots`` slots takes at
    most one row, 4% dropped past the buffer) or combine (each of ``slots``
    tokens takes ``per_token`` rows, 4% masked)."""
    r = np.random.default_rng(seed)
    msg = r.normal(size=(e, d)).astype(np.float32)
    if per_token == 0:
        rcv = np.full(e, slots, np.int64)
        own = r.random(e) < 0.96
        rcv[own] = r.permutation(slots)[:int(own.sum())]
        mask = own
    else:
        rcv = np.repeat(np.arange(slots), per_token)[r.permutation(e)]
        mask = r.random(e) < 0.96
    return {"msg": msg, "receivers": rcv.astype(np.int64), "edge_mask": mask,
            "num_nodes": slots}


def rows_of(seed, e, d, length):
    """Every row ``length`` owned edges (the last row the rest), in random
    stream order."""
    r = np.random.default_rng(seed)
    rcv = (np.arange(e) // length)[r.permutation(e)].astype(np.int64)
    return {"msg": r.normal(size=(e, d)).astype(np.float32),
            "receivers": rcv, "edge_mask": np.ones(e, bool),
            "num_nodes": -(-e // length)}


def shapes() -> dict:
    """{name: case on the card}, each from its own seed."""
    sc = cs.scatter_case
    all5 = cs.ALL_STATS
    return {
        "moe_dispatch_bf16": on_card(moe(0, 8192, 2048, 10240, 0),
                                     dtype="bfloat16"),
        "moe_combine_f32": on_card(moe(1, 8192, 2048, 1024, 8)),
        "prefill_dispatch_bf16": on_card(moe(17, 32768, 2048, 40960, 0),
                                         dtype="bfloat16"),
        "prefill_combine_f32": on_card(moe(18, 32768, 2048, 4096, 8)),
        "decode_dispatch_bf16": on_card(moe(2, 128, 2048, 512, 0),
                                        dtype="bfloat16"),
        "decode_combine_f32": on_card(moe(3, 128, 2048, 2, 64)),
        "gin_molhiv_n32_e64": on_card(sc(4, 32, 64, 100, kernel="x")),
        "gin_hep_n64_e1024": on_card(sc(5, 64, 1024, 100, kernel="x")),
        "gin_n1024_e4096": on_card(sc(6, 1024, 4096, 100, kernel="x")),
        "gat_packed_n256_e512": on_card(sc(7, 256, 512, 64, kernel="x")),
        "gat_packed_n2048_e4096": on_card(sc(8, 2048, 4096, 64, kernel="x")),
        "pna_hep_four_stats": on_card(sc(9, 64, 1024, 80, kernel="x"),
                                      stats=("sum", "sumsq", "max", "min")),
        "dgn_hep_sum": on_card(sc(10, 64, 1024, 200, kernel="x"),
                               stats=("sum",)),
        "hub_f32_d100": on_card(sc(11, 1024, 8192, 100, kernel="x",
                                   mask_p=1.0, hub=5000)),
        "hub_bf16_d2048": on_card(sc(12, 1024, 8192, 2048, kernel="x",
                                     mask_p=1.0, hub=5000),
                                  dtype="bfloat16"),
        "multi_hub_all5_d100": on_card(sc(13, 1024, 8192, 100, kernel="x",
                                          mask_p=1.0, hub=5000), stats=all5),
        "one_row_n64_e4096": on_card(sc(14, 64, 4096, 100, kernel="x",
                                        hub=4096)),
        "hub_block_e4096": on_card(sc(15, 1024, 4096, 100, kernel="x",
                                      mask_p=1.0, hub=2500)),
        "rows_of_129_e65536": on_card(rows_of(16, 65536, 100, 129)),
    }


def timed_in_turns(fns: dict, case, **kw) -> dict:
    """{name: [device us, device us]}: each fn twice, in turns (the list,
    then the list reversed)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fns[name](case, **kw)
        times[name].append(cs.time_ms(lambda: fns[name](case, **kw))[0]
                           * 1e3)
    return times


def same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def compare_phase3(this, parent) -> tuple:
    """Both as_is kernels on every mp_scatter / mp_scatter_multi case of
    chip_smoke.py's phase 3 (its synthetic cases): (bitwise equal, cases)."""
    equal, total = 0, 0
    for kernel in ("mp_scatter", "mp_scatter_multi"):
        for i, (name, spec) in enumerate(cs.SCATTER_CASES[kernel].items()):
            spec = dict(spec)
            offset = spec.pop("offset", 0)
            dtype = spec.get("dtype", "float32")
            kw = cs.scatter_case(11 + i, kernel=kernel, **spec)
            case = on_card(kw, cs.stats_of(kw) if kernel != "mp_scatter"
                           else None, dtype)
            case["msg"] = cs.placed(case["msg"], dtype, offset)
            outs = []
            for fn in (this, parent):
                got = fn(case)
                outs.append({k: v.clone() for k, v in got.items()})
            torch.cuda.synchronize()
            ok = same(*outs)
            equal += ok
            total += 1
            print(f"{kernel} {name}: this and parent "
                  f"{'bitwise equal' if ok else 'DIFFER'}", flush=True)
    return equal, total


# the other sources that include edge_buckets.cuh
SHARED_USERS = ("mp_pipeline", "seg_softmax", "layer_fused",
                "fused_nt_scatter")


def sass(csrc: Path, name: str, where: Path) -> list:
    """The instructions of ``csrc/<name>.cu``'s device code for sm_90a, in
    order, without addresses, encodings or symbol names (which carry the
    source path's hash)."""
    import re
    where.mkdir(parents=True, exist_ok=True)
    cubin = where / f"{name}.cubin"
    arch = [f for f in build.NVCC_FLAGS if f.startswith("arch=")]
    subprocess.run([build.nvcc_path(), "-cubin", "-gencode", arch[0],
                    "-std=c++17", "-O3", "-o", str(cubin),
                    str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;", line)
        if m:
            out.append(re.sub(r"_ZN\w+|\w*GLOBAL__N\w*", "<sym>", m.group(1)))
    return out


def compare_shared_users(parent: Path) -> None:
    """The other kernels on edge_buckets.cuh: this checkout's machine code
    against the parent's."""
    for name in SHARED_USERS:
        a = sass(build.CSRC, name, OUT / "sass" / "this")
        b = sass(parent / CSRC_REL, name, OUT / "sass" / "parent")
        same = a == b
        print(f"{name}.cu: {len(a)} instructions this, {len(b)} parent; "
              f"{'identical machine code' if same else 'CODE DIFFERS'}",
              flush=True)


def crossover(this) -> None:
    """The committed kernel in each form at N = 256 ... 8,192, E = 2N."""
    r = np.random.default_rng(17)
    for d in (100, 64):
        for n in (256, 1024, 2048, 4096, 8192):
            e = 2 * n
            case = on_card({
                "msg": r.normal(size=(e, d)).astype(np.float32),
                "receivers": r.integers(0, n, e).astype(np.int64),
                "edge_mask": r.random(e) < 0.8, "num_nodes": n})
            for rows in (None, 1, 3, 8, 16):
                forms = {"grid": lambda c, f=this: f(c, rows=rows,
                                                     form="grid")}
                if e <= ms.LOCAL_EDGES:
                    forms["block"] = lambda c, f=this: f(c, rows=rows,
                                                         form="block")
                t = timed_in_turns(forms, case)
                picked = form_of(case, rows)
                print(f"crossover D={d} N={n} E={e} rows "
                      f"{rows or 'own'}: " + ", ".join(
                          f"{k} {v[0]:.2f} / {v[1]:.2f} us"
                          for k, v in t.items())
                      + f"; launch_form picks {picked}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose mp_scatter.cu is timed too")
    ap.add_argument("--only", choices=("variants", "crossover"),
                    default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatter_breakdown: no CUDA device", file=sys.stderr)
        return 2
    names = (("as_is",) if args.only == "crossover"
             else tuple(variants(sources(build.CSRC))))
    fns = build_kernels("this", build.CSRC, names)
    if args.parent is not None:
        fns.update(build_kernels("parent", args.parent / CSRC_REL,
                                 ("as_is",)))
    if args.only != "crossover":
        for shape, case in shapes().items():
            times = timed_in_turns(fns, case)
            plan = ms.launch_plan(case["n"], case["msg"].shape[0],
                                  case["msg"].shape[1], case["msg"].dtype,
                                  multi=case["stats"] is not None)
            for name, ts in times.items():
                print(f"{shape} {name}: device {ts[0]:.2f} / {ts[1]:.2f} us "
                      f"(two turns; this tree's plan {plan})", flush=True)
            if args.parent is not None:
                a = {k: v.clone() for k, v in
                     fns["this as_is"](case).items()}
                b = fns["parent as_is"](case)
                torch.cuda.synchronize()
                print(f"{shape}: this and parent "
                      f"{'bitwise equal' if same(a, b) else 'DIFFER'}",
                      flush=True)
        if args.parent is not None:
            eq, total = compare_phase3(fns["this as_is"],
                                       fns["parent as_is"])
            print(f"phase 3 scatter cases bitwise equal this vs parent: "
                  f"{eq} of {total}", flush=True)
            compare_shared_users(args.parent)
    if args.only != "variants":
        crossover(fns["this as_is"])
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
