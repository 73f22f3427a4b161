"""The port's Griffin recurrent block (``repro_torch/nn/rglru.py``) against
the JAX package's ``repro/nn/rglru.py``.

``rglru_scan`` (a doubling scan) against JAX's ``associative_scan`` and a
float64 loop, with and without h0: both scans multiply in another order
than the loop, so float32 at atol = rtol = 1e-5, the reference's own
tolerance against its loop (``tests/test_rglru.py``). Then
``recurrent_block``'s prefill and decode steps on the JAX weights, at 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.nn import rglru as jrg  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.nn import rglru as trg  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 17, 64])
def test_rglru_scan_matches_the_reference(s, with_h0):
    r = np.random.default_rng(s)
    b, w = 2, 5
    a = (r.random((b, s, w)) * 0.9 + 0.05).astype(np.float32)
    bb = r.normal(size=(b, s, w)).astype(np.float32)
    h0 = r.normal(size=(b, w)).astype(np.float32) if with_h0 else None
    hs = trg.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb),
                        None if h0 is None else torch.from_numpy(h0))
    ref = jrg.rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                         None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref), **TOL)
    h = np.zeros((b, w)) if h0 is None else h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + bb[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h, **TOL)


@pytest.fixture(scope="module")
def block():
    jcfg = jarchs.REDUCED["recurrentgemma-2b"]
    tcfg = tarchs.REDUCED["recurrentgemma-2b"]
    jp = jinit(jax.random.PRNGKey(0), jrg.rglru_param_defs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_recurrent_block_sequence_matches(block):
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(1).normal(
        size=(2, 19, tcfg.d_model)).astype(np.float32)
    out, cache = trg.recurrent_block(tp, torch.from_numpy(x), tcfg)
    ref, _ = jrg.recurrent_block(jp, jnp.asarray(x), jcfg)
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s", [3, 16])
def test_recurrent_block_prefill_then_decode_match(block, s):
    """Prefill (S = lru_conv - 1 and 16), then two decode steps; the cache
    written in place equals the reference's."""
    jcfg, tcfg, jp, tp = block
    b, w = 2, tcfg.lru_width
    x = np.random.default_rng(4 + s).normal(
        size=(b, s + 2, tcfg.d_model)).astype(np.float32)
    conv = (b, tcfg.lru_conv - 1, w)
    jc = jrg.RecCache(jnp.zeros((b, w)), jnp.zeros(conv),
                      jnp.asarray(0, jnp.int32))
    tc = trg.RecCache(torch.zeros((b, w)), torch.zeros(conv), 0)
    h, cv = tc.h, tc.conv
    ref, jc = jrg.recurrent_block(jp, jnp.asarray(x[:, :s]), jcfg, cache=jc)
    out, tc = trg.recurrent_block(tp, torch.from_numpy(x[:, :s]), tcfg,
                                  cache=tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for i in range(2):
        xi = x[:, s + i:s + i + 1]
        ref, jc = jrg.recurrent_block(jp, jnp.asarray(xi), jcfg, cache=jc)
        out, tc = trg.recurrent_block(tp, torch.from_numpy(xi), tcfg,
                                      cache=tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"decode step {i}")
    assert tc.h is h and tc.conv is cv and tc.length == s + 2
    np.testing.assert_allclose(tc.h.numpy(), np.asarray(jc.h), **TOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(jc.conv), **TOL)
