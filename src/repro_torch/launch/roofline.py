"""Roofline terms of a counted step (no hardware needed).

The twin of ``repro/launch/roofline.py``:

    compute term    = FLOPs_per_device / peak FLOP/s
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

The counts are a position's record (``repro_torch/counter.py``): what one
device does in the step, so the reference's "/ chips" is applied already.
The report takes position 0's (``hlo_cost.py::count_step``): where the
splits are even every position's products, kernels, collectives and
arguments are the same, and its op bytes and peak within 1% (a MoE token
shard sums the counts of the shards before it; the position holding the
new token writes it into a sequence-split cache).
FLOPs are the products' (``torch.utils.flop_counter``) plus the kernels'
declared work (``kernels/cost.py``); bytes the eager op stream's traffic
plus the kernels'; collective bytes the records' result bytes weighed as
the reference weighs the partitioned HLO's: all-reduce twice (a ring
all-reduce moves about twice the payload), reduce-scatter times the group
(the result is the small side), all-gather, all-to-all and
collective-permute once.

The reference's HLO text parsers (``_shape_bytes``, ``_group_size``) and
its XLA:CPU artifact estimate (``cpu_f32_artifact_bytes``) have no
counterpart: the port has no HLO text, and no XLA:CPU f32 upcast inflates
its buffers. The collectives record their own kind, group and bytes.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional

# NVIDIA H100 SXM5 (NVIDIA's H100 data sheet), at its 700 W power limit
PEAK_FLOPS = 989e12        # bf16 FLOP/s, dense, on the tensor cores
PEAK_FP32_FLOPS = 67e12    # float32 FLOP/s, outside the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
HBM_BYTES = 80e9           # bytes of HBM3 a card
POWER_LIMIT_W = 700.0      # the limit the peaks assume
# one direction of NVLink 4's 900 GB/s a card (the data sheet). That holds
# within one 8-card node (NVSwitch); a (16, 16) or (2, 16, 16) mesh spans
# nodes, whose network is slower, so the collective term is a lower bound
LINK_BW = 450e9            # bytes/s

# how many times its result bytes a collective moves (roofline.py:56)
_WEIGHT = {"all-reduce": 2.0}


def collective_bytes(records: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """Per collective kind: {'bytes': weighted bytes, 'count': n,
    'group_size': the largest group}, from a record's collectives (each
    {'kind', 'group_size', 'count', 'result_bytes'}): all-reduce result
    bytes x2, reduce-scatter result bytes x the group, the others x1."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"bytes": 0.0, "count": 0, "group_size": 0})
    for r in records:
        kind, group = r["kind"], r["group_size"]
        mult = float(group) if kind == "reduce-scatter" else \
            _WEIGHT.get(kind, 1.0)
        c = out[kind]
        c["bytes"] += r["result_bytes"] * mult
        c["count"] += r["count"]
        c["group_size"] = max(c["group_size"], group)
    return dict(out)


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params."""
    from repro_torch.distributed.sharding import param_count
    from repro_torch.models.lm import lm_param_defs
    n_total = param_count(lm_param_defs(cfg))
    n_active = n_total
    if cfg.num_experts:
        per_expert = cfg.d_model * cfg.moe_d_ff * 3
        n_layers_moe = cfg.num_layers
        inactive = (cfg.num_experts - cfg.num_experts_per_tok) * per_expert \
            * n_layers_moe
        n_active = n_total - inactive
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch           # one step
    return 2.0 * n_active * tokens


def roofline_report(record: Dict, n_devices: int, cfg=None, shape=None,
                    measured: Optional[Dict] = None) -> Dict:
    """The three terms, the bottleneck and the useful share of one
    device's step. ``record`` is a counted run's record (``Record.
    as_dict``); ``measured`` the full model's costs extrapolated from one
    and two layer groups (``launch/hlo_cost.py``), preferred where given.
    The counted run's own figures stay as 'raw_*' fields."""
    raw_flops = float(record["flops"])
    raw_bytes = float(record["bytes"])
    colls = collective_bytes(record["collectives"])
    if measured is not None:
        flops = measured["flops"]
        bytes_accessed = measured["bytes"]
        coll_bytes = measured["coll_bytes"]
    else:
        flops = raw_flops
        bytes_accessed = raw_bytes
        coll_bytes = sum(v["bytes"] for v in colls.values())

    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)

    rep = {
        "per_device_flops": flops,
        "per_device_bytes": bytes_accessed,
        "per_device_collective_bytes": coll_bytes,
        "raw_cost_analysis_flops": raw_flops,
        "raw_cost_analysis_bytes": raw_bytes,
        "collectives": colls,
        **terms,
        "bottleneck": bottleneck,
        "step_time_lower_bound_s": max(terms.values()),
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        rep["model_flops_total"] = mf
        rep["model_flops_per_device"] = mf / n_devices
        # the share means something only for the full model's costs
        if measured is not None:
            if flops > 0:
                rep["useful_flops_ratio"] = (mf / n_devices) / flops
            peak_time = (mf / n_devices) / PEAK_FLOPS
            rep["roofline_fraction"] = (peak_time / max(terms.values())
                                        if max(terms.values()) > 0 else 0.0)
    return rep


def memory_report(record: Dict) -> Dict[str, float]:
    """One device's bytes, with the reference's keys: the arguments, the
    outputs, the temporaries (the live peak above the arguments), the
    donated outputs and the peak. ``record`` is a counted run's record or
    the extrapolated costs (whose 'peak_bytes' is then an estimate)."""
    arg = float(record["argument_bytes"])
    peak = float(record["peak_bytes"])
    return {
        "argument_bytes": arg,
        "output_bytes": float(record["output_bytes"]),
        "temp_bytes": peak - arg,
        "alias_bytes": float(record["alias_bytes"]),
        "peak_estimate_bytes": peak,
    }


__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS", "POWER_LIMIT_W",
           "collective_bytes", "memory_report", "model_flops",
           "roofline_report"]
