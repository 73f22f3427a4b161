"""The port's ``twopass``, ``unfused`` and ``banked`` impls and
``banked_segment_sum`` against the JAX package's, on the CPU.

``twopass`` and ``unfused`` are the plain gather / phi / aggregation /
update sequence (PyTorch materialises the message under every impl);
``banked`` sums through ``banked_segment_sum``, the dest-banked layout.
Both sides get the same numpy-seeded messages, the same graphs (the JAX
generators through each side's ``build_graph_batch``) and the same weights
(the JAX ``init``, moved across through ``params_from_numpy``); the
reference runs unrolled (``scan_layers=False``). Tolerance: atol = rtol =
1e-5, what the reference holds between its own eager and compiled
forwards. Passes over the edges must be equal on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import message_passing as jmp  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.graph import concat_raw_graphs  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core import message_passing as tmpass  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.message_passing import (AGG_KINDS,  # noqa: E402
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _graphs(packed):
    gs = list(molhiv_like(seed=3, n_graphs=3 if packed else 1))
    pads = (128, 256) if packed else (64, 128)
    raw = concat_raw_graphs(gs)
    kw = dict(edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
              graph_offsets=raw["graph_offsets"], node_pad=pads[0],
              edge_pad=pads[1], graph_pad=len(gs))
    args = (raw["node_feat"], raw["senders"], raw["receivers"])
    return jbuild(*args, **kw), tbuild(*args, device="cpu", **kw)


def _small(cfgs, name):
    return cfgs[name].replace(num_layers=3, hidden_dim=16)


def _jax_params(cfg, seed=0):
    params = jmake(cfg).init(jax.random.PRNGKey(seed), cfg)
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _messages(e=128, d=8, n=32, seed=0):
    """Numpy messages and a COO stream: the last 3 destinations receive no
    edge and about a fifth of the edges are masked."""
    r = np.random.default_rng(seed)
    msg = r.normal(size=(e, d)).astype(np.float32)
    rcv = r.integers(0, n - 3, size=e).astype(np.int64)
    mask = r.random(e) < 0.8
    return ((torch.from_numpy(msg), torch.from_numpy(rcv),
             torch.from_numpy(mask)),
            (jnp.asarray(msg), jnp.asarray(rcv, jnp.int32),
             jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# banked_segment_sum and the banked aggregation arms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("one_d", [False, True])
@pytest.mark.parametrize("banks", [1, 2, 4])
def test_banked_segment_sum_matches_reference(banks, one_d):
    (tm, tr, tk), (jm, jr, jk) = _messages(seed=banks)
    if one_d:
        tm, jm = tm[:, 0], jm[:, 0]
    ours = tmpass.banked_segment_sum(tm, tr, 32, num_banks=banks,
                                     edge_mask=tk)
    ref = jmp.banked_segment_sum(jm, jr, 32, num_banks=banks, edge_mask=jk)
    assert ours.shape == ((32,) if one_d else (32, 8))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert (ours.numpy()[29:] == 0.0).all()


def test_banked_segment_sum_rejects_what_the_reference_rejects():
    (tm, tr, tk), (jm, jr, jk) = _messages()
    for fn, m, r, k in ((tmpass.banked_segment_sum, tm, tr, tk),
                        (jmp.banked_segment_sum, jm, jr, jk)):
        with pytest.raises(ValueError):          # 32 rows into 3 banks
            fn(m, r, 32, num_banks=3, edge_mask=k)
        with pytest.raises(ValueError):          # 3-D messages
            fn(m.reshape(128, 2, 4), r, 32, num_banks=4, edge_mask=k)


@pytest.mark.parametrize("kind", AGG_KINDS)
def test_banked_segment_aggregate_every_kind(kind):
    (tm, tr, tk), (jm, jr, jk) = _messages(seed=len(kind))
    with count_edge_passes() as ps:
        ours = tmpass.segment_aggregate(
            tm, tr, 32, kind=kind, edge_mask=tk,
            dataflow=DataflowConfig(impl="banked"))
    with jmp.count_edge_passes() as pj:
        ref = jmp.segment_aggregate(
            jm, jr, 32, kind=kind, edge_mask=jk,
            dataflow=jmp.DataflowConfig(impl="banked"))
    assert ps.passes == pj.passes
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kinds", [
    ("mean", "std", "max", "min"),
    ("sum", "mean"),
    ("sum", "var", "max"),
    AGG_KINDS,
])
def test_banked_segment_multi_aggregate(kinds, with_degrees):
    (tm, tr, tk), (jm, jr, jk) = _messages(seed=len(kinds))
    dt = dj = None
    if with_degrees:
        deg = np.bincount(tr.numpy()[tk.numpy()], minlength=32)
        dt, dj = (torch.from_numpy(deg.astype(np.float32)),
                  jnp.asarray(deg, jnp.float32))
    with count_edge_passes() as ps:
        ours = tmpass.segment_multi_aggregate(
            tm, tr, 32, kinds=kinds, edge_mask=tk,
            dataflow=DataflowConfig(impl="banked", num_banks=2), degrees=dt)
    with jmp.count_edge_passes() as pj:
        ref = jmp.segment_multi_aggregate(
            jm, jr, 32, kinds=kinds, edge_mask=jk,
            dataflow=jmp.DataflowConfig(impl="banked", num_banks=2),
            degrees=dj)
    assert ps.passes == pj.passes
    for k in kinds:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the models (each model under each impl: test_torch_plain_impl_models.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pna", "dgn"])
def test_ladder_floor_matches_reference(name):
    """The reference engine's ladder floor, ``unfused`` with
    ``single_pass=False``: one sweep family per kind."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=8)
    jg, tg = _graphs(packed=True)
    with count_edge_passes() as ps:
        ours = tmake(tcfg).apply(
            tp, tg, tcfg,
            DataflowConfig(impl="unfused", single_pass=False)).numpy()
    with jmp.count_edge_passes() as pj:
        ref = np.asarray(jmake(jcfg).apply(
            jp, jg, jcfg, jmp.DataflowConfig(impl="unfused",
                                             single_pass=False,
                                             scan_layers=False)))
    assert ps.passes == pj.passes
    np.testing.assert_allclose(ours, ref, **TOL)


def test_banked_model_rejects_indivisible_banks_like_the_reference():
    """64 padded nodes do not divide into 3 banks: ValueError on both
    sides."""
    jcfg, tcfg = _small(JCFG, "gin"), _small(TCFG, "gin")
    jp, tp = _jax_params(jcfg)
    jg, tg = _graphs(packed=False)
    with pytest.raises(ValueError):
        tmake(tcfg).apply(tp, tg, tcfg,
                          DataflowConfig(impl="banked", num_banks=3))
    with pytest.raises(ValueError):
        jmake(jcfg).apply(jp, jg, jcfg,
                          jmp.DataflowConfig(impl="banked", num_banks=3,
                                             scan_layers=False))
