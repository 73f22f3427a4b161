#!/usr/bin/env python3
"""Drive the PyTorch port of FlowGNN on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

  1. device  — a CUDA device must be present; prints ``nvidia-smi``'s name
               and power limit; TF32 off for every fp32 product.
  2. build   — builds every CUDA kernel of the path from ``src/repro_torch/
               kernels/csrc`` with nvcc (all sources at once).
  3. kernels — each kernel against its plain PyTorch version on the card,
               at stated tolerances, bitwise across runs and launch shapes;
               kernel, plain and bound times.
  4. slice   — GIN at the paper's width served end to end through
               ``GraphStreamEngine.process`` (impl='fused_layer'): launch
               counts, passes over the edges, agreement with the plain
               ``impl='fused'`` path on the card and with the CPU; then
               16 graphs again under ``torch.profiler``: device-busy share,
               top device and host ops, and the host's batch build alone.
  5. result  — one JSON line with every kernel's numbers, the card's
               ``nvidia-smi`` line, then ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA's data sheet) at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# kernel vs plain version on the card: both fp32, sums in another order
# (atomics in index_add_, blocked products in cuBLAS), so agreement to a
# few hundred ulp of the output's scale
RTOL = 1e-4
ATOL_OF_SCALE = 1e-4
# the served prediction vs the plain impl='fused' path: five layers of
# those differences, compounded
SLICE_RTOL = 1e-4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def close(a, b):
    """Max abs error, max error relative to max(1, max|b|) (the scale), and
    whether |a - b| <= ATOL_OF_SCALE*scale + RTOL*|b| with ``a`` finite."""
    import torch
    diff = (a - b).abs()
    scale = max(1.0, float(b.abs().max()))
    ok = bool((diff <= ATOL_OF_SCALE * scale + RTOL * b.abs()).all())
    return float(diff.max()), float(diff.max()) / scale, ok and bool(
        torch.isfinite(a).all())


def time_ms(fn, reps: int = 21, inner: int = 20):
    """(device ms, call ms) of one call of ``fn``, medians over ``reps``.

    Device ms: ``inner`` calls queued behind a GPU spin long enough to
    cover their host dispatch, between two CUDA events, so the card runs
    them back to back and only its own time is counted. Call ms: one call
    at a time between two events, the host's dispatch included (what a
    caller at batch 1 waits).
    """
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the spin: torch.cuda._sleep runs ~1.5-2 cycles per ns; ask for 3x
    # the enqueue time at 1 cycle per ns so the queue never drains
    spin = int(3 * enqueue_s * 1e9) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, call = [], []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / inner)
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(call)


# ---------------------------------------------------------------------------
# layer_fused cases
# ---------------------------------------------------------------------------

def glorot(r, d_in, d_out):
    return (r.normal(size=(d_in, d_out)) * np.sqrt(2.0 / (d_in + d_out))
            ).astype(np.float32)


def lf_case(seed, n, e, d, d_ff, d_out=None, *, self_coeff="scalar",
            sw=None, edge_term=True, phi_bias=False, relu_phi=True,
            out_relu=False, empty_tail=0, mask_p=0.8):
    """Numpy inputs of one layer_fused call (a dict of keyword args)."""
    r = np.random.default_rng(seed)
    kw = {
        "x": r.normal(size=(n, d)).astype(np.float32),
        "senders": r.integers(0, n, size=e).astype(np.int64),
        # the last ``empty_tail`` destinations receive no edge
        "receivers": r.integers(0, n - empty_tail, size=e).astype(np.int64),
        "edge_mask": r.random(e) < mask_p,
        "num_nodes": n,
        "w1": glorot(r, d, d_ff),
        "b1": (0.1 * r.normal(size=(d_ff,))).astype(np.float32),
        "phi_activation": "relu" if relu_phi else "none",
        "out_activation": "relu" if out_relu else "none",
    }
    if d_out is not None:
        kw["w2"] = glorot(r, d_ff, d_out)
        kw["b2"] = (0.1 * r.normal(size=(d_out,))).astype(np.float32)
    if self_coeff == "scalar":
        kw["self_coeff"] = np.array([1.1], np.float32)
    elif self_coeff == "node":
        kw["self_coeff"] = r.random(n).astype(np.float32)
    if sw == "scalar":
        kw["src_weight"] = r.normal(size=(e,)).astype(np.float32)
    elif sw == "full":
        kw["src_weight"] = r.normal(size=(e, d)).astype(np.float32)
    elif sw == "head":
        kw["src_weight"] = r.normal(size=(e, 4)).astype(np.float32)
    if edge_term:
        kw["edge_term"] = r.normal(size=(e, d)).astype(np.float32)
    if phi_bias:
        kw["phi_bias"] = r.normal(size=(d,)).astype(np.float32)
    return kw


def on_device(kw, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in kw.items()}


def lf_call(fn, kw, **extra):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("x", "senders", "receivers", "edge_mask",
                                "num_nodes")]
    return fn(*args, **kw, **extra)


# layer_fused's per-edge streams: a masked edge contributes nothing, so the
# function needs these only for the edges whose mask is set
LF_EDGE_STREAMS = ("senders", "receivers", "src_weight", "edge_term")


def lf_bound(kw):
    """The least time (ms) the card could take for this call, the larger of
    two. Bytes at the memory rate: the edge mask once, the per-edge streams
    of the unmasked edges once, every node-side input and weight once, the
    output written once. Operations at the fp32 rate: those this run's
    data needs (the unmasked edges' phi, then the epilogue)."""
    n, d = kw["x"].shape
    e = kw["senders"].shape[0]
    valid = int(kw["edge_mask"].sum())
    d_ff = kw["w1"].shape[1]
    two = "w2" in kw
    d_out = kw["w2"].shape[1] if two else d_ff
    nbytes = n * d_out * 4                                    # the output
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            nbytes += (v.nbytes // e * valid if k in LF_EDGE_STREAMS
                       else v.nbytes)
    per_edge = 1 + ("src_weight" in kw) + ("edge_term" in kw) + (
        "phi_bias" in kw) + (kw["phi_activation"] == "relu")
    flops = valid * d * per_edge
    flops += 2 * n * d if "self_coeff" in kw else 0
    flops += 2 * n * d * d_ff + n * d_ff
    if two:
        flops += n * d_ff + 2 * n * d_ff * d_out + n * d_out
    flops += n * d_out if kw["out_activation"] == "relu" else 0
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def gin_layer_inputs(cfg, params, graph):
    """layer_fused's inputs for GIN's first layer on one padded graph: what
    the main path hands the kernel in that bucket."""
    import torch
    from repro_torch.core.models import _dense
    p = params["layers"][0]
    m0, m1 = p["mlp"]
    x = torch.relu(_dense(params["node_enc"], graph.node_feat))
    return {
        "x": x, "senders": graph.senders, "receivers": graph.receivers,
        "edge_mask": graph.edge_mask, "num_nodes": graph.n_node_pad,
        "w1": m0["w"], "b1": m0["b"], "w2": m1["w"], "b2": m1["b"],
        "edge_term": _dense(p["edge_enc"], graph.edge_feat),
        "phi_activation": "relu", "out_activation": "none",
        "self_coeff": (1.0 + p["eps"]).reshape(1),
    }


def to_numpy(kw):
    import torch
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in kw.items()}


def kernel_phase(card: str, main_inputs):
    """Phase 3: layer_fused against layer_fused_ref on the card."""
    import torch
    from repro_torch.kernels.layer_fused import layer_fused, layer_fused_ref
    cases = {
        "a_gin_paper_width": lf_case(1, 1024, 4096, 100, 200, 100,
                                     empty_tail=64),
        "b_gcn_form": lf_case(2, 1024, 4096, 9, 100, self_coeff="node",
                              sw="scalar", edge_term=False, relu_phi=False,
                              out_relu=True, empty_tail=32),
        "c_full_src_weight_bias_no_self": lf_case(
            3, 1024, 4096, 100, 100, self_coeff=None, sw="full",
            phi_bias=True, relu_phi=False),
        "d_ragged_head_src_weight": lf_case(4, 997, 3001, 100, 200, 100,
                                            sw="head", empty_tail=5),
    }
    for name, kw in main_inputs.items():
        cases[name] = to_numpy(kw)
    rows = {}
    for name, kw_np in cases.items():
        kw = on_device(kw_np, "cuda")
        out = lf_call(layer_fused, kw)
        plain = lf_call(layer_fused_ref, kw)
        torch.cuda.synchronize()
        err, rel, ok = close(out, plain)
        tol = f"|k-p| <= {ATOL_OF_SCALE:g}*max(1,max|p|) + {RTOL:g}*|p|"
        log("kernels", f"layer_fused {name}: N={kw_np['x'].shape[0]} "
            f"E={kw_np['senders'].shape[0]} D={kw_np['x'].shape[1]} "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} tol: {tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"layer_fused {name} disagrees with its "
                                 f"plain version")
        if name.startswith("a_"):
            runs = [out, lf_call(layer_fused, kw),
                    lf_call(layer_fused, kw, rows_per_block=3),
                    lf_call(layer_fused, kw, rows_per_block=16)]
            torch.cuda.synchronize()
            if not all(torch.equal(r, out) for r in runs[1:]):
                raise AssertionError("layer_fused is not bitwise stable "
                                     "across runs and rows-per-block")
            log("kernels", f"layer_fused {name}: bitwise equal across 2 runs "
                f"at the kernel's own rows/block and at 3 and 16 rows/block")
        bound, bound_by, nbytes, flops = lf_bound(kw_np)
        ms, call_ms = time_ms(lambda: lf_call(layer_fused, kw))
        plain_ms, plain_call_ms = time_ms(lambda: lf_call(layer_fused_ref,
                                                          kw))
        rows[name] = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                      "plain_ms": plain_ms, "call_ms": call_ms,
                      "plain_call_ms": plain_call_ms, "bound_ms": bound,
                      "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        log("kernels", f"layer_fused {name}: device time kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; one call "
            f"with host dispatch kernel {call_ms * 1e3:.1f} us, plain "
            f"{plain_call_ms * 1e3:.1f} us; bound {bound * 1e3:.2f} us "
            f"({bound_by}: {nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP) "
            f"on {card}")
    return rows


# ---------------------------------------------------------------------------
# the slice, end to end
# ---------------------------------------------------------------------------

def slice_phase(card: str):
    import torch
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import PAPER_GNN_CONFIGS, gin_init
    from repro_torch.data.graphs import hep_like, molhiv_like
    from repro_torch.kernels.layer_fused import layer_fused

    cfg = PAPER_GNN_CONFIGS["gin"]
    params = gin_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    graphs = (list(molhiv_like(seed=0, n_graphs=64))
              + list(hep_like(seed=2, n_graphs=8)))
    warm = [graphs[0], graphs[-1]]             # one graph per kind of bucket

    def args(g):
        return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos

    engine = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                               device="cuda")
    layer_fused.launches = 0
    for g in warm:
        engine.warmup(*args(g))
    t0 = time.perf_counter()
    preds = [engine.process(*args(g)) for g in graphs]
    wall = time.perf_counter() - t0
    launches = layer_fused.launches
    served = len(graphs) + len(warm)
    log("slice", f"served {len(graphs)} graphs (+{len(warm)} warmup) in "
        f"{wall:.3f} s; layer_fused launches {launches} "
        f"(expected {cfg.num_layers} x {served} = {cfg.num_layers * served})")
    if launches != cfg.num_layers * served:
        raise AssertionError("the main path did not run one layer_fused "
                             "launch per GIN layer")
    log("slice", f"edge passes per bucket: {engine.edge_passes}")
    if set(engine.edge_passes.values()) != {cfg.num_layers}:
        raise AssertionError("expected one pass over the edges per layer")

    plain = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused"),
                              device="cuda")
    ref = [plain.process(*args(g)) for g in graphs]
    cpu = GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                            device="cpu")
    worst = 0.0
    for i, (p, r) in enumerate(zip(preds, ref)):
        if p.shape != (cfg.out_dim,) or not np.isfinite(p).all():
            raise AssertionError(f"graph {i}: bad prediction {p}")
        worst = max(worst, float(np.abs(p - r).max()
                                 / max(1.0, float(np.abs(r).max()))))
        if i % 9 == 0:                         # a sample against the CPU
            c = cpu.process(*args(graphs[i]))
            np.testing.assert_allclose(p, c, rtol=SLICE_RTOL,
                                       atol=SLICE_RTOL * max(1.0, float(
                                           np.abs(c).max())))
    log("slice", f"predictions finite, shape ({cfg.out_dim},); worst error "
        f"vs impl='fused' on the card {worst:.3e} relative to max(1, |ref|) "
        f"(tol {SLICE_RTOL:g}); a sample of 8 matches the CPU path")
    if worst > SLICE_RTOL:
        raise AssertionError("served predictions disagree with the plain "
                             "path")
    summary = engine.stats.summary()
    log("slice", "GIN paper config, fused_layer, batch 1: p50 "
        f"{summary['p50_ms']:.3f} ms, p90 {summary['p90_ms']:.3f} ms, p99 "
        f"{summary['p99_ms']:.3f} ms; forward span (CUDA events around the "
        f"forward, host launch gaps included) {summary['device_mean_ms']:.3f} "
        f"ms/graph, {summary['throughput_gps']:.1f} graphs/s of forward "
        f"span; {len(graphs) / wall:.1f} graphs/s wall, on {card}")
    plain_summary = plain.stats.summary()
    log("slice", "same graphs, impl='fused' (plain PyTorch): p50 "
        f"{plain_summary['p50_ms']:.3f} ms, forward span "
        f"{plain_summary['device_mean_ms']:.3f} ms/graph, on {card}")
    result = {"launches": launches, "summary": summary,
              "plain_summary": plain_summary, "wall_s": wall,
              "edge_passes": {str(k): v for k, v in
                              engine.edge_passes.items()}}
    result["profile"] = profile_serving(engine, graphs[:16], args, card)
    return result


def profile_serving(engine, graphs, args, card: str):
    """Device-busy share, the top device and host ops while serving
    ``graphs``, and the host's batch build (padding + copies) alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.graph import build_graph_batch, pad_bucket
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in graphs:
        build_graph_batch(
            g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
            node_pos=g.node_pos,
            node_pad=pad_bucket(g.node_feat.shape[0], engine.buckets),
            edge_pad=pad_bucket(g.senders.shape[0], engine.buckets),
            device=engine.device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3 / len(graphs)
    log("profile", f"build_graph_batch alone (pad + copies to the card): "
        f"{build_ms:.3f} ms/graph on {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for g in graphs:
            engine.process(*args(g), record=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_device, on_host = {}, {}
    for ev in prof.events():
        cuda = ev.device_type == torch.autograd.DeviceType.CUDA
        table = on_device if cuda else on_host
        us = (ev.time_range.elapsed_us() if cuda
              else ev.self_cpu_time_total)
        t, c = table.get(ev.name, (0.0, 0))
        table[ev.name] = (t + us, c + 1)
    busy_us = sum(t for t, _ in on_device.values())

    def top(table, k):
        return [{"name": name[:70], "us": t, "count": c} for name, (t, c) in
                sorted(table.items(), key=lambda kv: -kv[1][0])[:k]]

    out = {"graphs": len(graphs), "wall_ms": wall * 1e3,
           "build_ms_per_graph": build_ms, "device_busy_us": busy_us,
           "device_busy_share": busy_us / (wall * 1e6),
           # graphs per second of the card's own busy time: what one card
           # would serve if the host kept it fed
           "busy_throughput_gps": len(graphs) / (busy_us * 1e-6),
           "host_self_us": sum(t for t, _ in on_host.values()),
           "top_device": top(on_device, 10), "top_host": top(on_host, 10)}
    log("profile", f"{len(graphs)} graphs in {wall * 1e3:.2f} ms wall "
        f"(profiler on); device busy {busy_us:.1f} us "
        f"({out['device_busy_share']:.1%} of wall), "
        f"{busy_us / len(graphs):.1f} us/graph, "
        f"{out['busy_throughput_gps']:.1f} graphs/s of device-busy time, "
        f"on {card}")
    for side in ("top_device", "top_host"):
        for row in out[side]:
            log("profile", f"  {side[4:]:6} {row['us']:10.1f} us "
                f"x{row['count']:<5} {row['name']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))

    # 1. device
    smi = gpu_line()
    card = f"{smi} (nvidia-smi name, power.limit)"
    log("device", f"{torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}; {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(["layer_fused"])
    log("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", line.strip())

    # 4 needs phase 3's main-path inputs first: build them from the slice's
    # own model and buckets
    from repro_torch.core.graph import build_graph_batch, pad_bucket
    from repro_torch.core.models import PAPER_GNN_CONFIGS, gin_init
    from repro_torch.data.graphs import hep_like, molhiv_like
    cfg = PAPER_GNN_CONFIGS["gin"]
    params = gin_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    main_inputs = {}
    for name, g in (("e_main_path_molhiv_bucket",
                     next(molhiv_like(seed=0, n_graphs=1))),
                    ("f_main_path_hep_bucket",
                     next(hep_like(seed=2, n_graphs=1)))):
        batch = build_graph_batch(
            g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
            node_pos=g.node_pos, node_pad=pad_bucket(g.node_feat.shape[0]),
            edge_pad=pad_bucket(g.senders.shape[0]), device="cuda")
        with torch.inference_mode():
            main_inputs[name] = gin_layer_inputs(cfg, params, batch)

    # 3. kernels against their plain versions
    rows = kernel_phase(card, main_inputs)

    # 4. the slice end to end
    slice_result = slice_phase(card)

    # 5. result
    main_row = rows["f_main_path_hep_bucket"]
    kernels = [{
        "name": "layer_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/layer_fused.cu",
        "replaces": "src/repro/kernels/layer_fused.py:203",
        "launches": slice_result["launches"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "call_ms": main_row["call_ms"],
        "plain_call_ms": main_row["plain_call_ms"],
        "shape": "GIN layer at the hep bucket: N=64, E=1024, D=100, "
                 "D_ff=200",
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
