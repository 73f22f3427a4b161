"""The MoE router's load, the port against the JAX package, layer by layer.

For each MoE layer of a forward the same statistics are read on both
sides, from the router input each side computed: the share of the
assignments dropped past capacity, the aux loss, the share of the router
inputs' squared norm along their mean direction, the share the layer
would drop with that mean taken out of its inputs, and the share of what
is left (the inputs' variance) in its 8 leading principal directions.
Each side's own aux loss is recorded too. The weights are the JAX
``init_params(PRNGKey(0), ...)`` moved across by ``lm_params_from_jax``.

The test runs reduced olmoe-1b-7b in float32. Run as a script, the file
reads olmoe-1b-7b at full width (``--depth`` layers, bf16 as served,
``--batch`` prompts of ``--tokens`` tokens from ``default_rng(0)``); that
takes a few GB of host memory and a few minutes on a CPU:

    PYTHONPATH=src python tests/test_torch_moe_load.py --depth 2 --tokens 256
"""

import argparse
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.checkpoint.convert import lm_params_from_jax  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402


def load_stats(xg, rw, k: int, capacity: int) -> dict:
    """One token group's load under router ``rw`` (d, E): the share of
    its T*k assignments past ``capacity`` in their expert, the aux loss
    (E * sum of each expert's assignment share times its mean
    probability), the share of the inputs' squared norm along their mean,
    the drop share with that mean taken out of the inputs, and the share
    of the inputs' variance in their 8 leading principal directions."""
    x = np.asarray(xg, np.float64)
    w = np.asarray(rw, np.float64)
    t, e = x.shape[0], w.shape[1]

    def route(x):
        logits = x @ w
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        top = np.argpartition(-p, k - 1, axis=-1)[:, :k]
        counts = np.bincount(top.ravel(), minlength=e)
        dropped = np.maximum(counts - capacity, 0).sum() / (t * k)
        return float(dropped), float(e * np.sum(counts / t * p.mean(0)))

    dropped, aux = route(x)
    mean = x.mean(0)
    shared = float(t * mean @ mean / np.sum(x * x))
    sv = np.linalg.svd(x - mean, compute_uv=False) ** 2
    return {"dropped": dropped, "aux": aux, "shared": shared,
            "dropped_centered": route(x - mean)[0],
            "top8_variance": float(sv[:8].sum() / sv.sum())}


def both_sides(arch_cfgs, batch: int, tokens: int, depth=None):
    """Run the JAX package's and the port's ``forward_hidden`` on the same
    tokens and weights; per MoE layer, in order, each side's router input
    and ``load_stats`` and its own aux."""
    jcfg, tcfg = arch_cfgs
    if depth is not None:
        jcfg = jcfg.replace(num_layers=depth)
        tcfg = tcfg.replace(num_layers=depth)
    jparams = jinit(jax.random.PRNGKey(0), jlm.lm_param_defs(jcfg))
    tparams = lm_params_from_jax(jparams, tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (batch, tokens))
    jside, tside = [], []

    real_j = jmoe._dispatch_compute_combine

    def j_tapped(xg, **kw):
        out, aux = real_j(xg, **kw)
        jax.debug.callback(
            lambda x, r, a: jside.append((np.asarray(x, np.float32),
                                          np.asarray(r), float(a),
                                          kw["k"], kw["capacity"])),
            xg, kw["rw"], aux)
        return out, aux

    real_route, real_aux = tmoe.route, tmoe.aux_loss

    def t_route(xg, rw, *, k, capacity):
        tside.append([xg.float().numpy(), rw.numpy(), None, k, capacity])
        return real_route(xg, rw, k=k, capacity=capacity)

    def t_aux(r, e_total):
        aux = real_aux(r, e_total)
        tside[-1][2] = float(aux)
        return aux

    jmoe._dispatch_compute_combine = j_tapped
    tmoe.route, tmoe.aux_loss = t_route, t_aux
    try:
        _, _, jaux = jlm.forward_hidden(jparams, jnp.asarray(toks, jnp.int32),
                                        jcfg)
        jax.effects_barrier()
        with torch.no_grad():
            _, _, taux = tlm.forward_hidden(tparams, torch.from_numpy(toks),
                                            tcfg)
    finally:
        jmoe._dispatch_compute_combine = real_j
        tmoe.route, tmoe.aux_loss = real_route, real_aux
    rows = []
    for (jx, jr, ja, k, cap), (tx, tr, ta, tk, tcap) in zip(jside, tside):
        assert (k, cap) == (tk, tcap)
        rows.append({"x_max_abs_diff": float(np.abs(jx - tx).max()),
                     "x_scale": float(np.abs(jx).max()),
                     "jax": {**load_stats(jx, jr, k, cap), "own_aux": ja},
                     "port": {**load_stats(tx, tr, k, cap), "own_aux": ta},
                     "capacity": cap, "assignments": jx.shape[0] * k})
    assert len(rows) == len(jside) == len(tside)
    return rows, float(jaux), float(taux)


def test_router_load_matches_the_reference_layer_by_layer():
    """Reduced olmoe-1b-7b in float32: the router inputs agree at 1e-5,
    and so does every statistic of the load, layer by layer."""
    cfgs = (jarchs.REDUCED["olmoe-1b-7b"], tarchs.REDUCED["olmoe-1b-7b"])
    rows, jaux, taux = both_sides(cfgs, batch=2, tokens=24)
    assert len(rows) == cfgs[0].num_layers
    for row in rows:
        assert row["x_max_abs_diff"] <= 1e-5 * max(1.0, row["x_scale"])
        for key in ("dropped", "dropped_centered"):
            assert row["port"][key] == row["jax"][key]
        for key in ("aux", "shared", "own_aux", "top8_variance"):
            np.testing.assert_allclose(row["port"][key], row["jax"][key],
                                       rtol=1e-5, atol=1e-5)
        # a side's own aux is the statistic read from its router input
        np.testing.assert_allclose(row["port"]["own_aux"],
                                   row["port"]["aux"], rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, sum(r["port"]["own_aux"] for r in rows),
                               rtol=1e-5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=256)
    args = ap.parse_args()
    cfgs = (jarchs.ARCHS["olmoe-1b-7b"], tarchs.ARCHS["olmoe-1b-7b"])
    rows, jaux, taux = both_sides(cfgs, args.batch, args.tokens, args.depth)
    c = cfgs[0]
    print(f"olmoe-1b-7b at full width, depth {args.depth}, "
          f"{np.dtype(c.dtype).name}, {args.batch} prompts of {args.tokens} "
          f"tokens: T={args.batch * args.tokens} a group, "
          f"top-{c.num_experts_per_tok} of {c.num_experts}, capacity "
          f"{rows[0]['capacity']} (factor {c.capacity_factor}); perfect "
          f"balance gives aux {c.num_experts_per_tok} a layer")
    print("layer  side  dropped   aux       own aux   shared    dropped "
          "with the mean out  top-8 variance")
    for i, row in enumerate(rows):
        for side in ("jax", "port"):
            s = row[side]
            print(f"{i:5d}  {side:4s}  {s['dropped']:.4%}  {s['aux']:8.4f}  "
                  f"{s['own_aux']:8.4f}  {s['shared']:.4f}    "
                  f"{s['dropped_centered']:.4%}            "
                  f"{s['top8_variance']:.4f}")
        print(f"       router inputs: max |jax - port| "
              f"{row['x_max_abs_diff']:.4e} of scale {row['x_scale']:.4e}")
    print(f"aux summed over layers: jax {jaux:.6f}, port {taux:.6f}")
    assert all(math.isfinite(r["port"]["aux"]) for r in rows)


if __name__ == "__main__":
    main()
