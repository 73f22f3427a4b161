"""Serving entry points.

The twin of ``repro/launch/serve.py``. Two modes, matching the two halves
of the repo:

  * ``gnn``: raw COO graphs streamed at batch size 1 through the port's
    ``GraphStreamEngine``; reports per-graph latency percentiles and
    throughput.
  * ``lm``: prefill then greedy decode with the layer-stacked KV cache, the
    reduced config by default (as the reference) or, with ``--full``, the
    published one at full width and depth.

Both run on the GPU unless ``--device cpu`` is given. Usage (from the root
of a checkout):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode gnn --model gin --graphs 200
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch llama3-8b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch llama3-8b --full
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.archs import ARCHS, REDUCED
from repro_torch.core.engine import GraphStreamEngine
from repro_torch.core.message_passing import DEFAULT_DATAFLOW, DataflowConfig
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
from repro_torch.data.graphs import hep_like, molhiv_like
from repro_torch.models import lm


def serve_gnn(model: str, n_graphs: int, dataset: str = "molhiv",
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              device: DeviceLike = None) -> dict:
    """Serve ``n_graphs`` graphs (after one warmup graph) with the paper
    config of ``model`` and weights from ``torch.Generator().manual_seed(0)``;
    returns the engine's latency and throughput summary."""
    cfg = PAPER_GNN_CONFIGS[model]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    engine = GraphStreamEngine(cfg, params, dataflow, device=device)
    gen = {"molhiv": molhiv_like, "hep": hep_like}[dataset]
    graphs = list(gen(seed=0, n_graphs=n_graphs + 1))
    g0 = graphs[0]
    engine.warmup(g0.node_feat, g0.senders, g0.receivers, g0.edge_feat,
                  g0.node_pos)
    for g in graphs[1:]:
        engine.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                       g.node_pos)
    stats = engine.stats.summary()
    print(f"[gnn:{model}:{dataset}] {stats}")
    return stats


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch: str, gen_tokens: int, batch: int = 2,
             prompt_len: int = 32, max_len: int = 128, full: bool = False,
             device: DeviceLike = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (from
    ``numpy.random.default_rng(0)``), then decode greedily to
    ``gen_tokens`` tokens each (the first from the prefill's logits).
    ``REDUCED[arch]`` by default, ``ARCHS[arch]`` with ``full``; random
    weights from a ``torch.Generator`` on the device seeded with 0.

    Returns the prefill's wall seconds, the decode steps' seconds and
    tokens per second (host clock, the card synchronised before each
    read), the generated tokens (B, gen_tokens) and the prefill's
    last-position logits.
    """
    dev = resolve_device(device)
    cfg = (ARCHS if full else REDUCED)[arch]
    if prompt_len + gen_tokens - 1 > max_len:
        raise ValueError(f"max_len {max_len} cannot hold {prompt_len} prompt "
                         f"and {gen_tokens - 1} decoded tokens")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    caches = lm.init_caches(cfg, batch, max_len, dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    pe = (torch.from_numpy(rng.normal(
        size=(batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)).to(dev)
          if cfg.prefix_len else None)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, prompt, caches, cfg, prefix_embed=pe)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        step_logits, caches = lm.decode_step(params, tok, caches, cfg,
                                             position=prompt_len + i)
        tok = torch.argmax(step_logits[:, :cfg.vocab_size], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    stats = {
        "arch": cfg.name, "full": full, "device": str(dev),
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "generated": tokens.shape,
    }
    print(f"[lm:{arch}] {stats}")
    return {**stats, "tokens": tokens, "last_logits": logits}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("gnn", "lm"), default="gnn")
    ap.add_argument("--model", default="gin",
                    choices=sorted(PAPER_GNN_CONFIGS))
    ap.add_argument("--dataset", default="molhiv", choices=("molhiv", "hep"))
    ap.add_argument("--graphs", type=int, default=100)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, which must exist)")
    args = ap.parse_args()
    if args.mode == "gnn":
        serve_gnn(args.model, args.graphs, args.dataset, device=args.device)
    else:
        serve_lm(args.arch, args.tokens, full=args.full, device=args.device)


if __name__ == "__main__":
    main()
