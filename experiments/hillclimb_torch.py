"""Perf hillclimb for the port: count a (arch x shape) cell on the
production mesh's meta positions with config overrides and log the three
roofline terms per iteration.

The twin of ``experiments/hillclimb.py``; its records go to
``experiments/perf_torch/``, which ``repro_torch.launch.report``'s perf
table reads.

  PYTHONPATH=src python experiments/hillclimb_torch.py qwen1.5-0.5b train_4k iter1 sharding_profile=dp_only
"""

import json
import sys
from pathlib import Path

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.launch.hlo_cost import measured_costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import memory_report, roofline_report

OUT = Path(__file__).parent / "perf_torch"


def measure(arch, shape_name, tag, overrides):
    cfg = ARCHS[arch]
    for kv in overrides:
        k, v = kv.split("=")
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                continue
        if v in ("True", "False"):
            v = v == "True"
        cfg = cfg.replace(**{k: v})
    shape = SHAPES[shape_name]
    mesh = make_production_mesh()
    measured = measured_costs(cfg, shape, mesh, TrainConfig())
    mem = memory_report(measured)
    roof = roofline_report(measured.get("_c1", measured), mesh.size, cfg,
                           shape, measured=measured)
    rec = {"arch": arch, "shape": shape_name, "tag": tag,
           "overrides": overrides, "memory": mem, "roofline": roof,
           "measured": {k: v for k, v in measured.items()
                        if not k.startswith("_") and k != "collectives"}}
    OUT.mkdir(parents=True, exist_ok=True)
    p = OUT / f"{arch}__{shape_name}__{tag}.json"
    p.write_text(json.dumps(rec, indent=2, default=str))
    print(f"[{arch} | {shape_name} | {tag}] "
          f"compute={roof['compute_s']:.3f}s "
          f"memory={roof['memory_s']:.3f}s "
          f"collective={roof['collective_s']:.3f}s "
          f"bottleneck={roof['bottleneck']} "
          f"fraction={roof.get('roofline_fraction', 0):.3f} "
          f"peak={mem['peak_estimate_bytes']/2**30:.1f}GiB")
    return rec


if __name__ == "__main__":
    arch, shape_name, tag = sys.argv[1:4]
    measure(arch, shape_name, tag, sys.argv[4:])
