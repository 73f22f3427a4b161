#!/usr/bin/env python3
"""The card's memory across re-captures of evicted programs, on one NVIDIA
GPU.

    python3 experiments/capture_memory.py [--cycles N] [--cap K]

GIN ``fused_layer`` at the paper config (random weights from seed 0) is
served at max_batch 1 through ``process`` on one graph in each of four
buckets (``sized_stream`` at 10, 60, 200 and 400 nodes), ``--cycles`` times
over, by an engine that holds at most ``--cap`` programs (``--cap`` below 4:
every visit evicts a program and captures one). Each run is a fresh
process, in two modes: ``warm_stream``, the engine as it is (each
capture's warm-up run on its executor's one side stream), and
``fresh_stream``, a new side stream for each capture's warm-up run (as
the engine had it before the executor kept one). After each cycle it prints one
JSON line: the mode, the cycle, ``torch.cuda.memory_reserved()`` and
``memory_allocated()`` (bytes), the allocator's segments and the
evictions so far, with the card's name and power limit as ``nvidia-smi``
gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SIZES = (10, 60, 200, 400)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def run(mode: str, cycles: int, cap: int) -> None:
    sys.path.insert(0, str(REPO / "src"))
    import torch
    from repro_torch.core import engine as tengine
    from repro_torch.core.engine import GraphStreamEngine
    from repro_torch.core.message_passing import DataflowConfig
    from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
    from repro_torch.data.graphs import sized_stream
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = PAPER_GNN_CONFIGS["gin"]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cuda")
    graphs = [next(sized_stream(seed=n, n_graphs=1, n_mean=n, n_std=0))
              for n in SIZES]
    with GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                           device="cuda", max_batch=1,
                           max_cached_programs=cap) as eng:
        if mode == "fresh_stream":
            real = tengine.CapturedProgram.__init__

            def fresh(self, *a, warm_stream, **kw):
                real(self, *a, warm_stream=torch.cuda.Stream(), **kw)
            tengine.CapturedProgram.__init__ = fresh
        for cycle in range(cycles):
            for g in graphs:
                eng.process(g.node_feat, g.senders, g.receivers,
                            g.edge_feat, g.node_pos)
            torch.cuda.synchronize()
            stats = torch.cuda.memory_stats()
            print(json.dumps({
                "mode": mode, "cap": cap, "cycle": cycle,
                "reserved": torch.cuda.memory_reserved(),
                "allocated": torch.cuda.memory_allocated(),
                "segments": stats.get("segment.all.current"),
                "evictions": eng.stats.program_evictions,
                "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--cap", type=int, default=2)
    ap.add_argument("--mode", choices=("warm_stream", "fresh_stream"))
    args = ap.parse_args()
    if args.mode is not None:
        run(args.mode, args.cycles, args.cap)
        return 0
    for mode in ("fresh_stream", "warm_stream"):
        subprocess.run([sys.executable, __file__, "--mode", mode,
                        "--cycles", str(args.cycles), "--cap",
                        str(args.cap)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
