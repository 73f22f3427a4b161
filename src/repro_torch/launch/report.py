"""The roofline tables from the dry run's JSONs.

The twin of ``repro/launch/report.py``, reading the port's records
(``experiments/dryrun_torch/``, ``experiments/perf_torch/``):

  PYTHONPATH=src python -m repro_torch.launch.report
"""

from __future__ import annotations

import glob
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3] / "experiments"


def load(pattern):
    recs = []
    for f in sorted(glob.glob(str(ROOT / pattern))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def roofline_table() -> str:
    rows = ["| arch | shape | compute (s) | memory (s) | collective (s) "
            "| bottleneck | useful FLOPs | roofline frac | peak GiB "
            "| count (s) |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in load("dryrun_torch/*__pod.json"):
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"{r['reason']} | — | — | — | — |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"error: {r['error'][:60]} | — | — | — | — |")
            continue
        ro, m = r["roofline"], r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.4f} "
            f"| {ro['memory_s']:.4f} | {ro['collective_s']:.4f} "
            f"| {ro['bottleneck'].replace('_s', '')} "
            f"| {ro.get('useful_flops_ratio', 0):.2f} "
            f"| {ro.get('roofline_fraction', 0):.3f} "
            f"| {m['peak_estimate_bytes'] / 2**30:.1f} "
            f"| {r['count_s']:.0f} |")
    return "\n".join(rows)


def multipod_table() -> str:
    rows = ["| arch | shape | status | count (s) | peak GiB/dev (one "
            "layer group) | collectives seen |",
            "|---|---|---|---|---|---|"]
    for r in load("dryrun_torch/*__multipod.json"):
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skipped "
                        f"(long-context) | — | — | — |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | error | — | — "
                        f"| — |")
            continue
        kinds = ", ".join(sorted(r["roofline"]["collectives"]))
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['count_s']:.0f} "
            f"| {r['memory']['peak_estimate_bytes'] / 2**30:.1f} "
            f"| {kinds} |")
    return "\n".join(rows)


def perf_table() -> str:
    rows = ["| cell | iteration | compute (s) | memory (s) | collective (s) "
            "| fraction | peak GiB |",
            "|---|---|---|---|---|---|---|"]
    for r in load("perf_torch/*.json"):
        ro, m = r["roofline"], r["memory"]
        rows.append(
            f"| {r['arch']} x {r['shape']} | {r['tag']} "
            f"| {ro['compute_s']:.3f} | {ro['memory_s']:.3f} "
            f"| {ro['collective_s']:.3f} "
            f"| {ro.get('roofline_fraction', 0):.3f} "
            f"| {m['peak_estimate_bytes'] / 2**30:.1f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print("## Roofline (single pod, 16x16)\n")
    print(roofline_table())
    print("\n## Multi-pod (2x16x16)\n")
    print(multipod_table())
    print("\n## Perf iterations\n")
    print(perf_table())
