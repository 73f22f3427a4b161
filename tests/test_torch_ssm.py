"""The port's Mamba2 SSD mixer (``repro_torch/nn/ssm.py``) against the JAX
package's ``repro/nn/ssm.py``.

``ssd_chunked`` against JAX's ``ssd_chunked`` (and the port's ``ssd_ref``
against JAX's ``ssd_ref``) at S in {1, 7, 16, 37} x chunk in {4, 16}: S
off a multiple of the chunk (padded with dt = 0) and S under it, with and
without an initial state; float32 at atol = rtol = 1e-5. The chunked form
against the recurrence holds at the reference's own 2e-4
(``tests/test_ssm.py``): they sum in another order. Then ``mamba_mixer``'s
prefill and decode steps on the JAX weights, and the reference's property
that decoding token by token matches the whole sequence.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
FORMS_TOL = dict(atol=2e-4, rtol=2e-4)     # chunked vs recurrence


def _inputs(seed, b, s, h, p, n):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, h, p)).astype(np.float32),
            (r.random((b, s, h)) * 0.5 + 0.05).astype(np.float32),
            (r.normal(size=(h,)) * 0.3).astype(np.float32),
            r.normal(size=(b, s, n)).astype(np.float32),
            r.normal(size=(b, s, n)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("s", [1, 7, 16, 37])
def test_ssd_chunked_matches_the_reference(s, chunk):
    args = _inputs(s * 10 + chunk, 2, s, 3, 4, 5)
    y, final = tssm.ssd_chunked(*_t(args), chunk)
    ry, rfinal = jssm.ssd_chunked(*_j(args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(rfinal), **TOL)
    ref = tssm.ssd_ref(*_t(args))
    np.testing.assert_allclose(ref.numpy(),
                               np.asarray(jssm.ssd_ref(*_j(args))), **TOL)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **FORMS_TOL)


@pytest.mark.parametrize("s,chunk", [(16, 4), (37, 16)])
def test_ssd_chunked_with_an_initial_state(s, chunk):
    args = _inputs(s, 2, s, 3, 4, 5)
    h0 = np.random.default_rng(99).normal(size=(2, 3, 4, 5)).astype(
        np.float32)
    y, final = tssm.ssd_chunked(*_t(args), chunk,
                                init_state=torch.from_numpy(h0))
    ry, rfinal = jssm.ssd_chunked(*_j(args), chunk,
                                  init_state=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(rfinal), **TOL)


def test_ssd_gradients_stay_finite_where_a_chunks_decay_overflows():
    """A chunk of 64 steps whose decays sum past float32's exp range (dt
    up to 3, |a| up to 3.5: |cs| reaches ~500). The reference's masked
    ``exp`` of the upper triangle is inf there and its gradient NaN; the
    port's chunked form has the recurrence's values and its finite
    gradients, at the forms' 2e-4 of each gradient's scale."""
    r = np.random.default_rng(7)
    b, s, h, p, n = 1, 64, 2, 4, 3
    args = [r.normal(size=(b, s, h, p)), r.random((b, s, h)) * 3.0,
            np.full((h,), 1.25), r.normal(size=(b, s, n)),
            r.normal(size=(b, s, n))]
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in args]
    w = torch.from_numpy(r.normal(size=(b, s, h, p)).astype(np.float32))
    ja = [jnp.asarray(a, jnp.float32) for a in args]
    jy, _ = jssm.ssd_chunked(*ja, s)
    jg = jax.grad(lambda dt: jnp.sum(jssm.ssd_chunked(
        ja[0], dt, *ja[2:], s)[0] * w.numpy()))(ja[1])
    assert not np.all(np.isfinite(np.asarray(jg)))     # the reference's NaN
    y, _ = tssm.ssd_chunked(*ts, s)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    got = torch.autograd.grad((y * w).sum(), ts)
    want = torch.autograd.grad((tssm.ssd_ref(*ts) * w).sum(), ts)
    for g, v in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(v.abs().max())
        assert float((g - v).abs().max()) <= 2e-4 * scale


@pytest.fixture(scope="module")
def mixer():
    jcfg, tcfg = jarchs.REDUCED["mamba2-2.7b"], tarchs.REDUCED["mamba2-2.7b"]
    jp = jinit(jax.random.PRNGKey(0), jssm.mamba_param_defs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _caches(jcfg, tcfg, b):
    conv = (b, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)
    state = (b, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    jc = jssm.MambaCache(jnp.zeros(state), jnp.zeros(conv),
                         jnp.asarray(0, jnp.int32))
    tc = tssm.MambaCache(torch.zeros(state), torch.zeros(conv), 0)
    return jc, tc


@pytest.mark.parametrize("s", [3, 20])
def test_mamba_mixer_prefill_then_decode_match(mixer, s):
    """Prefill (S = ssm_conv - 1, the shortest prompt that fills the conv
    window, and S = 20), then three decode steps; the cache written in
    place equals the reference's."""
    jcfg, tcfg, jp, tp = mixer
    b = 2
    x = np.random.default_rng(s).normal(
        size=(b, s + 3, tcfg.d_model)).astype(np.float32)
    jc, tc = _caches(jcfg, tcfg, b)
    state, conv = tc.state, tc.conv
    ry, jc = jssm.mamba_mixer(jp, jnp.asarray(x[:, :s]), jcfg, cache=jc)
    y, tc = tssm.mamba_mixer(tp, torch.from_numpy(x[:, :s]), tcfg, cache=tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    for i in range(3):
        xi = x[:, s + i:s + i + 1]
        ry, jc = jssm.mamba_mixer(jp, jnp.asarray(xi), jcfg, cache=jc)
        y, tc = tssm.mamba_mixer(tp, torch.from_numpy(xi), tcfg, cache=tc)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL,
                                   err_msg=f"decode step {i}")
    assert tc.state is state and tc.conv is conv and tc.length == s + 3
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state), **TOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(jc.conv), **TOL)


def test_a_prompt_shorter_than_the_conv_window_raises(mixer):
    """The reference slices such a prompt's window from a negative start
    (ROADMAP §3); the port refuses it at the prefill."""
    jcfg, tcfg, jp, tp = mixer
    _, tc = _caches(jcfg, tcfg, 1)
    x = torch.zeros((1, tcfg.ssm_conv - 2, tcfg.d_model))
    with pytest.raises(ValueError, match="prefill at least"):
        tssm.mamba_mixer(tp, x, tcfg, cache=tc)


def test_mamba_decode_matches_sequence(mixer):
    """Prefill + decode token by token == the whole sequence at once
    (the reference's own property, at its tolerances)."""
    jcfg, tcfg, jp, tp = mixer
    b, s = 2, 20
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, s + 3, tcfg.d_model)).astype(np.float32))
    ref, _ = tssm.mamba_mixer(tp, x, tcfg)
    _, tc = _caches(jcfg, tcfg, b)
    out, tc = tssm.mamba_mixer(tp, x[:, :s], tcfg, cache=tc)
    np.testing.assert_allclose(out.numpy(), ref[:, :s].numpy(), **FORMS_TOL)
    for i in range(3):
        oi, tc = tssm.mamba_mixer(tp, x[:, s + i:s + i + 1], tcfg, cache=tc)
        np.testing.assert_allclose(oi[:, 0].numpy(), ref[:, s + i].numpy(),
                                   atol=3e-4, rtol=3e-4)
