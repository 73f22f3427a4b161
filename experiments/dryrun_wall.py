"""Wall seconds of one dry-run step on the production mesh's meta positions.

Builds ``arch``'s ``shape`` step with ``launch/steps.py::lowering_bundle``
on the (16, 16) mesh of meta positions at each given depth (every layer in
the Python loop, as ``launch/hlo_cost.py`` runs it) and times one call of
it, with no counter unless ``--counter``. The depths run in the order
given, in one process, so the first call carries the process's warm-up;
a least-squares line through the walls splits them into a fixed cost and
a cost a layer:

  PYTHONPATH=src python experiments/dryrun_wall.py llama3-8b decode_32k 1 1 2 3 1 2 3
"""

import argparse
import time

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.counter import Counter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import lowering_bundle


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", choices=sorted(ARCHS))
    ap.add_argument("shape", choices=sorted(SHAPES))
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--counter", action="store_true")
    args = ap.parse_args()
    mesh = make_production_mesh()
    walls = []
    for layers in args.layers:
        cfg = ARCHS[args.arch].replace(num_layers=layers, scan_layers=False,
                                       unroll_scans=True)
        step, inputs = lowering_bundle(cfg, SHAPES[args.shape], mesh)
        t0 = time.perf_counter()
        if args.counter:
            with Counter():
                step(*inputs)
        else:
            step(*inputs)
        wall = time.perf_counter() - t0
        walls.append(wall)
        print(f"layers={layers} counter={int(args.counter)} "
              f"step={wall:.2f}s", flush=True)
    if len(set(args.layers)) > 1:
        n = len(walls)
        mx, my = sum(args.layers) / n, sum(walls) / n
        slope = (sum((x - mx) * (y - my) for x, y in zip(args.layers, walls))
                 / sum((x - mx) ** 2 for x in args.layers))
        print(f"fixed={my - slope * mx:.2f}s per_layer={slope:.2f}s "
              f"(least squares over {n} calls)", flush=True)


if __name__ == "__main__":
    main()
