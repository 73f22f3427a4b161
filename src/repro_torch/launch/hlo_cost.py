"""A step's per-device costs by two-point layer extrapolation.

The twin of ``repro/launch/hlo_cost.py``, with the same arithmetic. The
reference extrapolates because XLA's cost analysis counts a while loop's
body once; the port extrapolates because a full-depth run on the
production mesh's 256 meta positions costs tens of seconds a layer. So:

  1. run the cell once on meta positions under the counter
     (``repro_torch/counter.py``) at 1 and at 2 layer groups (+ the pattern's
     remainder), every layer in the Python loop (``scan_layers=False``,
     ``unroll_scans=True``, as the reference lowers it);
  2. per-group cost = cost(2g) - cost(1g), which holds the remat
     recompute, the optimizer's update and the collectives of a group;
  3. full-model cost = cost(1g) + (num_groups - 1) * per-group.

This is exact for layer-homogeneous models (every group does the same
work) for the FLOPs, the bytes, the kernels' work and the collectives. The
port extrapolates the argument, output and donated bytes the same way
(exact, they are sums over the layers' leaves) and the live-bytes peak,
which is an estimate: it assumes the peak grows by the same step a group
(the layers' weights and the activations remat keeps), which
``chip_smoke.py``'s roofline phase holds against the card. Attention
chunk sizes are coarsened as the reference coarsens them; the port's
attention is one kernel whatever they are.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.roofline import collective_bytes

_PATTERN_LEN = {"global": 1, "local_global": 2, "griffin": 3, "ssm": 1}


def _analysis_cfg(cfg: ModelConfig, n_groups: int) -> ModelConfig:
    g = _PATTERN_LEN[cfg.layer_pattern]
    rem = cfg.num_layers % g
    kw = dict(num_layers=n_groups * g + rem, scan_layers=False,
              unroll_scans=True)
    if cfg.attn_q_chunk < 2048:
        kw.update(attn_q_chunk=2048, attn_kv_chunk=4096)
    return cfg.replace(**kw)


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               tcfg: Optional[TrainConfig]) -> Dict:
    """One run of ``cfg``'s ``shape`` step on ``mesh`` under a counter:
    position 0's record (``Record.as_dict``; every position does the same
    work where the splits are even), with the run's wall seconds as
    'count_s'."""
    from repro_torch.counter import Counter
    from repro_torch.launch.steps import lowering_bundle
    t0 = time.perf_counter()
    step, args = lowering_bundle(cfg, shape, mesh, tcfg=tcfg)
    with Counter() as c:
        step(*args)
    rec = c.records[mesh.positions()[0]].as_dict()
    rec["count_s"] = time.perf_counter() - t0
    return rec


def _measure(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
             tcfg: Optional[TrainConfig]) -> Dict:
    """One counted run's figures, the numbers ``measured_costs``
    extrapolates and the raw collective records."""
    rec = count_step(cfg, shape, mesh, tcfg)
    colls = collective_bytes(rec["collectives"])
    out = {
        "flops": float(rec["flops"]),
        "product_flops": float(rec["product_flops"]),
        "kernel_flops": float(rec["kernel_flops"]),
        "bytes": float(rec["bytes"]),
        "kernel_bytes": float(rec["kernel_bytes"]),
        "coll_bytes": sum(v["bytes"] for v in colls.values()),
        "argument_bytes": float(rec["argument_bytes"]),
        "output_bytes": float(rec["output_bytes"]),
        "alias_bytes": float(rec["alias_bytes"]),
        "peak_bytes": float(rec["peak_bytes"]),
        "count_s": rec["count_s"],
        "collectives": rec["collectives"],
    }
    for k, v in colls.items():
        out[f"coll_{k}_bytes"] = v["bytes"]
        out[f"coll_{k}_count"] = v["count"]
    return out


def measured_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                   tcfg: Optional[TrainConfig] = None) -> Dict[str, float]:
    """Extrapolated per-device costs for the FULL model ('count_s' is the
    two runs' wall seconds together)."""
    g = _PATTERN_LEN[cfg.layer_pattern]
    num_groups = cfg.num_layers // g
    c1 = _measure(_analysis_cfg(cfg, 1), shape, mesh, tcfg)
    if num_groups == 1:
        return dict(c1)
    c2 = _measure(_analysis_cfg(cfg, 2), shape, mesh, tcfg)
    keys = set(c1) | set(c2)
    out = {}
    for k in keys - {"collectives"}:
        a, b = c1.get(k, 0.0), c2.get(k, 0.0)
        out[k] = a + (num_groups - 1) * (b - a)
    out["count_s"] = c1["count_s"] + c2["count_s"]
    out["_c1"] = c1
    out["_c2"] = c2
    out["_num_groups"] = num_groups
    return out


__all__ = ["count_step", "measured_costs"]
