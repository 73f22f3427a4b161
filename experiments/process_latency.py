#!/usr/bin/env python3
"""Batch-1 latency through ``GraphStreamEngine.process`` on one NVIDIA GPU,
for this tree's package and another tree's, in turns.

    python3 experiments/process_latency.py [--parent DIR] [--rounds N]

DIR is another checkout of the repository (e.g. a ``git archive`` of the
parent commit unpacked under ``build/``). Each turn is a fresh process that
imports one tree's ``repro_torch`` and serves phase 4's 72 graphs of
``chip_smoke.py`` (64 ``molhiv_like(seed=0)``, 8 ``hep_like(seed=2)``) one
at a time through ``process`` for GIN, GAT and PNA under ``fused_layer``
and GAT under ``kernel`` (the paper configs, random weights from seed 0),
after one unrecorded graph per bucket, and prints one JSON line: p50 / p99
ms per path, with the card's name and power limit as ``nvidia-smi`` gives
them. The turns run parent, this, this, parent (``--rounds`` times).
For a tree whose engine runs executor threads (``core/executor.py``), a
turn also splits each graph's time into its hand-offs, medians in us:
``submit`` to the placer handing the batch to the executor, to the
dispatch thread starting its ``enqueue``, the enqueue itself (pad, upload,
replay, copy-out), to the complete thread starting its ``wait``, the wait
(the card's work and the copy-out), to the future's result, to the caller
holding it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PATHS = (("gin", "fused_layer"), ("gat", "fused_layer"),
         ("pna", "fused_layer"), ("gat", "kernel"))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def turn(src: str) -> dict:
    """One tree's latencies, in this process (``src``: its ``src`` dir)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.graph import pad_bucket
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
    from repro_torch.data.graphs import hep_like, molhiv_like
    if not torch.cuda.is_available():
        raise SystemExit("process_latency: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graphs = (list(molhiv_like(seed=0, n_graphs=64))
              + list(hep_like(seed=2, n_graphs=8)))
    out = {"src": src, "card": card_line()}
    for name, impl in PATHS:
        cfg = PAPER_GNN_CONFIGS[name]
        params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                    device="cuda")
        engine = GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                                   device="cuda")
        first = {}
        for g in graphs:
            first.setdefault((pad_bucket(g.node_feat.shape[0],
                                         engine.buckets),
                              pad_bucket(g.senders.shape[0],
                                         engine.buckets)), g)
        args = [(g.node_feat, g.senders, g.receivers, g.edge_feat,
                 g.node_pos) for g in graphs]
        for g in first.values():
            engine.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                           g.node_pos, record=False)
        marks = _marks(engine)
        lat, steps = [], []
        for a in args:
            marks.clear()
            t0 = time.perf_counter()
            engine.process(*a, record=False)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if marks:
                steps.append(np.diff([t0] + [marks[k] for k in STEPS]
                                     + [t1]))
        engine.close()
        row = {"p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p99_ms": float(np.percentile(lat, 99) * 1e3)}
        if steps:
            row["steps_us"] = dict(zip(
                STEPS + ("caller",),
                (np.median(np.array(steps), axis=0) * 1e6).tolist()))
        out[f"{name}_{impl}"] = row
    return out


# the hand-offs of one graph through the engine's threads, in order
STEPS = ("placed", "dispatch_wake", "enqueue", "complete_wake", "wait",
         "resolved")


def _marks(engine) -> dict:
    """Record, per served graph, when each step of ``STEPS`` ended (host
    clock), by wrapping the executor's and the programs' methods (the
    class's once, whatever the engine); empty for an engine without
    executor threads."""
    marks: dict = {}
    if not hasattr(engine, "_executors"):
        return marks
    from repro_torch.core import engine as tengine

    def wrap(obj, attr, before=None, after=None):
        real = getattr(obj, attr)

        def wrapped(*a, **k):
            if before:
                marks[before] = time.perf_counter()
            out = real(*a, **k)
            if after:
                marks[after] = time.perf_counter()
            return out
        setattr(obj, attr, wrapped)

    for ex in engine._executors:
        wrap(ex, "submit", before="placed")
        wrap(ex, "_on_complete", after="resolved")
    prog = tengine.CapturedProgram
    prog.enqueue, prog.wait = prog.__dict__.get(
        "_untimed", (prog.enqueue, prog.wait))
    prog._untimed = (prog.enqueue, prog.wait)
    wrap(prog, "enqueue", before="dispatch_wake", after="enqueue")
    wrap(prog, "wait", before="complete_wake", after="wait")
    return marks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return 0
    trees = [("this", str(REPO / "src"))]
    if args.parent:
        parent = ("parent", str(Path(args.parent).resolve() / "src"))
        trees = [parent, trees[0], trees[0], parent]
    rows = []
    for _ in range(args.rounds):
        for label, src in trees:
            r = subprocess.run([sys.executable, __file__, "--turn", src],
                               capture_output=True, text=True, timeout=1200,
                               cwd=str(Path(src).parent))
            if r.returncode != 0:
                print(r.stdout, r.stderr, file=sys.stderr)
                return r.returncode
            row = json.loads(r.stdout.strip().splitlines()[-1])
            row["tree"] = label
            rows.append(row)
            print(f"[process] {label}: " + ", ".join(
                f"{k} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
                for k, v in row.items() if isinstance(v, dict))
                + f"; on {row['card']}", flush=True)
            for k, v in row.items():
                if isinstance(v, dict) and "steps_us" in v:
                    print(f"[process] {label} {k}: median us a graph by "
                          f"step: " + ", ".join(
                              f"{s} {t:.1f}"
                              for s, t in v["steps_us"].items()), flush=True)
    print(json.dumps({"process_latency": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
