"""Multi-pod dry run: count every (arch x shape x mesh) cell on meta
positions.

The twin of ``repro/launch/dryrun.py``. The port's lowering is one run of
the real step on the production mesh's ``meta`` positions under a counter
(``repro_torch/counter.py``), so no hardware is needed. For each cell this
records:

  * the per-device bytes: arguments, outputs, donated, the live-bytes peak
    (proves the config fits the card's 80 GB);
  * the per-device FLOPs and bytes for the roofline, extrapolated from one
    and two layer groups (``launch/hlo_cost.py``);
  * the collectives each position runs (kind, count, bytes, group);
  * the three roofline terms, the bottleneck and the useful-FLOPs share
    (``launch/roofline.py``).

The pod mesh (16, 16) gives costs and memory, both extrapolated (a
full-depth pass over 256 meta positions is out of reach for a sweep). The
multipod mesh (2, 16, 16) gives the memory of one layer group and the
collective kinds seen: it proves the 'pod' axis shards.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json. A
cell that fails is an error, and the run exits 1.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.archs import ARCHS, shape_applicable
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.launch.hlo_cost import (_analysis_cfg, _measure,
                                         measured_costs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import memory_report, roofline_report

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    n_dev = mesh.size
    t0 = time.perf_counter()
    try:
        if mesh_kind == "pod":
            measured = measured_costs(cfg, shape, mesh, TrainConfig())
            one = measured.get("_c1", measured)
            mem = memory_report(measured)
            mem["peak_is_estimate"] = "_c1" in measured
        else:
            measured = None
            one = _measure(_analysis_cfg(cfg, 1), shape, mesh,
                           TrainConfig())
            mem = memory_report(one)
            mem["depth"] = "one layer group"
        roof = roofline_report(one, n_dev, cfg, shape, measured=measured)
        rec.update(status="ok", n_devices=n_dev,
                   count_s=time.perf_counter() - t0, memory=mem,
                   roofline=roof,
                   measured=None if measured is None else {
                       k: v for k, v in measured.items()
                       if not k.startswith("_") and k != "collectives"})
        if verbose:
            print(f"[{arch} | {shape_name} | {mesh_kind}] "
                  f"count={rec['count_s']:.1f}s "
                  f"peak/dev={mem['peak_estimate_bytes'] / 2**30:.2f}GiB "
                  f"bottleneck={roof['bottleneck']} "
                  f"roofline_frac={roof.get('roofline_fraction', 0):.3f}",
                  flush=True)
    except Exception as e:  # a failing cell is a bug to fix, not to hide
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{arch} | {shape_name} | {mesh_kind}] FAILED: {e}",
                  flush=True)
    return rec


def save(rec: dict) -> Path:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    p = OUT_DIR / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    p.write_text(json.dumps(rec, indent=2, default=str))
    return p


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if args.arch is None else [args.arch]
    shapes = sorted(SHAPES) if args.shape is None else [args.shape]
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("pass --arch and --shape, or --all")

    n_fail = 0
    for m in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, m)
                save(rec)
                n_fail += rec["status"] == "error"
    print(f"done; {n_fail} failed cells")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
