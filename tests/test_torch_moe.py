"""The port's MoE feed-forward (``repro_torch/nn/moe.py``) against the JAX
package's ``repro/nn/moe.py::moe_ffn``.

The same numpy-made tokens and the JAX ``init_params`` weights (moved
across by ``params_from_numpy``) go through both: reduced olmoe-1b-7b and
arctic-480b, k in {1, 2, 4}, with capacity to spare and with a small
capacity factor that drops assignments (the drop depends on the stable
binning order), several token groups, the decode size T = 2 (capacity's
floor of 8), and the aux loss each time. float32 at atol = rtol = 1e-5.
The port dispatches and combines through ``moe_dispatch`` /
``moe_combine`` (on the CPU the plain versions of ``mp_scatter`` and
``gather_rows``); the reference through XLA scatters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: the reference adds a token's k weighted contributions in bf16
# (``out.at[st].add(contrib.astype(bf16))``: a rounding at every add), the
# port in float32, rounded once; and the experts' elementwise gate rounds
# to bf16 at other points in XLA's fusion than in eager PyTorch. Each is a
# few bf16 units (2^-8 relative); 2^-5 of max(1, |ref|) holds them with a
# margin, and the float32 cases above hold the arithmetic itself at 1e-5.
BF16_ATOL_OF_SCALE = 2.0 ** -5


def _cfgs(arch, **kw):
    return (jarchs.REDUCED[arch].replace(**kw),
            tarchs.REDUCED[arch].replace(**kw))


def _params(jcfg, tcfg, seed=0):
    jp = jinit(jax.random.PRNGKey(seed), jmoe.moe_param_defs(jcfg))
    # widened to float32 on the way (exact for bf16), then each leaf in
    # its definition's dtype
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), "cpu")
    return jp, {k: v.to(tmoe.moe_param_defs(tcfg)[k].dtype)
                for k, v in tp.items()}


def _tokens(seed, b, s, d, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(dtype)


def _both(arch, x, group_size=8192, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, tcfg, seed)
    ref, ref_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                                group_size=group_size)
    out, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg,
                            group_size=group_size)
    return out, aux, np.asarray(ref), float(ref_aux)


def _drop_share(arch, x, **kw):
    """The share of assignments past capacity, from the port's router."""
    jcfg, tcfg = _cfgs(arch, **kw)
    _, tp = _params(jcfg, tcfg)
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    cap = tmoe._capacity(xt.shape[0], tcfg.num_experts_per_tok,
                         tcfg.num_experts, tcfg.capacity_factor)
    r = tmoe.route(xt, tp["router"], k=tcfg.num_experts_per_tok,
                   capacity=cap)
    return float((~r["own"]).float().mean())


@pytest.mark.parametrize("cf", [64.0, 0.5], ids=["no_drops", "drops"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_ffn_matches_the_reference(arch, k, cf):
    x = _tokens(k, 2, 24, 64)
    out, aux, ref, ref_aux = _both(arch, x, num_experts_per_tok=k,
                                   capacity_factor=cf)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(float(aux), ref_aux, **TOL)
    dropped = _drop_share(arch, x, num_experts_per_tok=k,
                          capacity_factor=cf)
    assert (dropped > 0) == (cf < 1), dropped


def test_capacity_drops_follow_the_stable_binning_order():
    """Routing arrays equal the reference's jnp binning (stable argsort by
    expert, rank from searchsorted, trash slot E*C) on many ties."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    _, tp = _params(jcfg, tcfg, seed=3)
    x = _tokens(3, 1, 40, 64)[0]
    k, e = tcfg.num_experts_per_tok, tcfg.num_experts
    cap = 8
    r = tmoe.route(torch.from_numpy(x), tp["router"], k=k, capacity=cap)
    rw = jnp.asarray(tp["router"].numpy())
    probs = jax.nn.softmax(jnp.asarray(x) @ rw, axis=-1)
    top_w, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = jnp.repeat(jnp.arange(40), k)[order]
    starts = jnp.searchsorted(se, jnp.arange(e), side="left")
    rank = jnp.arange(40 * k) - starts[se]
    own = rank < cap
    slot = jnp.where(own, se * cap + rank, e * cap)
    assert not bool(own.all())
    for name, want in (("token_ids", st), ("slot", slot), ("own", own)):
        np.testing.assert_array_equal(r[name].numpy(), np.asarray(want),
                                      err_msg=name)
    np.testing.assert_allclose(r["weights"].numpy(),
                               np.asarray(top_w.reshape(-1)[order]), **TOL)


@pytest.mark.parametrize("t,group_size", [(48, 16), (50, 16), (60, 7)])
def test_several_token_groups(t, group_size):
    """Groups of at least ceil(T / group_size), raised until they divide
    T (48 -> 3, 50 -> 5, 60 -> 10), each with its own capacity; the aux is
    their mean."""
    x = _tokens(t, 1, t, 64)
    out, aux, ref, ref_aux = _both("olmoe-1b-7b", x, group_size=group_size,
                                   capacity_factor=1.0)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(float(aux), ref_aux, **TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_decode_size_two_tokens(arch):
    """T = B = 2, one token each: the capacity's floor of 8 slots."""
    x = _tokens(7, 2, 1, 64)
    out, aux, ref, ref_aux = _both(arch, x)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(float(aux), ref_aux, **TOL)


def test_bf16_model_within_bf16_rounding():
    x = _tokens(11, 2, 24, 64)
    jcfg = jarchs.REDUCED["olmoe-1b-7b"].replace(dtype=jnp.bfloat16,
                                                  capacity_factor=0.75)
    tcfg = tarchs.REDUCED["olmoe-1b-7b"].replace(dtype=torch.bfloat16,
                                                  capacity_factor=0.75)
    jp, tp = _params(jcfg, tcfg)
    assert tp["router"].dtype == torch.float32
    assert tp["wg"].dtype == torch.bfloat16
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, ref_aux = jmoe.moe_ffn(jp, xb, jcfg)
    xt = torch.from_numpy(np.array(xb, np.float32)).to(torch.bfloat16)
    out, aux = tmoe.moe_ffn(tp, xt, tcfg)
    assert out.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    scale = max(1.0, float(np.abs(ref32).max()))
    np.testing.assert_allclose(out.float().numpy(), ref32, rtol=0,
                               atol=BF16_ATOL_OF_SCALE * scale)
    # the router and the aux are float32 on both sides
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)


@pytest.mark.parametrize("s", [48, 128, 200])
def test_padded_assignments_dispatch_and_combine_as_unpadded(s):
    """``pad_assignments`` brings any stream to the wrappers' index tile
    with unowned assignments that add nothing: the buffer and the combine
    equal the same arrays' plain formulas (x[t] into its slot; the sum of
    w * y[slot] per token), and a stream on the tile is left as it is."""
    from repro_torch.kernels.moe_dispatch import (moe_combine, moe_dispatch,
                                                  pad_assignments)
    r = np.random.default_rng(s)
    t, d, n = 40, 6, 256
    # distinct slots, about a fifth past the buffer (not owned)
    slots = r.permutation(n + 64)[:s]
    own = slots < n
    slot = np.where(own, slots, n)
    tok = r.integers(0, t, s)
    w = r.random(s).astype(np.float32)
    x = r.normal(size=(t, d)).astype(np.float32)
    y = r.normal(size=(n, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (tok, slot, own, w)]
    padded = pad_assignments(*args, n)
    assert padded[0].shape[0] == -(-s // 128) * 128
    if s % 128 == 0:
        assert all(p is a for p, a in zip(padded, args))
    assert not bool(padded[2][s:].any()) and bool((padded[1][s:] == n).all())
    buf = moe_dispatch(torch.from_numpy(x), *padded[:3], n)
    want = np.zeros((n, d), np.float32)
    want[slot[own]] = x[tok[own]]
    np.testing.assert_array_equal(buf.numpy(), want)
    out = moe_combine(torch.from_numpy(y), *padded, t)
    want = np.zeros((t, d), np.float64)
    np.add.at(want, tok[own], w[own, None].astype(np.float64)
              * y[slot[own]])
    np.testing.assert_allclose(out.numpy(), want, **TOL)
