"""The RG-LRU's repair: its scan can be differentiated.

``repro_torch/nn/rglru.py::rglru_scan`` wrote its inputs' copies in place,
step by step; autograd needs those values for the backward, so
``recurrentgemma-2b``'s ``lm_loss`` raised ``RuntimeError: one of the
variables needed for gradient computation has been modified by an
inplace operation``. Where autograd needs the graph the scan now runs out
of place (serving keeps the in-place scan). Held here against ``jax.grad``
of the reference's recurrence and of ``repro/nn/rglru.py::
recurrent_block``, float32 at 1e-5 of each gradient's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.nn import rglru as jrglru  # noqa: E402
from repro_torch.nn import rglru as trglru  # noqa: E402

TOL = 1e-5


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1e-30, float(np.abs(ref).max()))
    err = float(np.abs(ours.detach().numpy() - ref).max())
    assert err <= TOL * scale, (err, scale)


def test_rglru_scan_is_differentiable_and_matches_jax_grad():
    rng = np.random.default_rng(3)
    b, s, w = 2, 13, 8
    a = rng.uniform(0.3, 0.99, size=(b, s, w)).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    g = rng.normal(size=(b, s, w)).astype(np.float32)
    ta, tx, th = (torch.from_numpy(t).requires_grad_() for t in (a, x, h0))
    hs = trglru.rglru_scan(ta, tx, th)
    (hs * torch.from_numpy(g)).sum().backward()

    def ref(a_, x_, h_):
        h = h_
        out = []
        for t in range(s):
            h = a_[:, t] * h + x_[:, t]
            out.append(h)
        return jnp.sum(jnp.stack(out, 1) * g)
    jg = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(x),
                                          jnp.asarray(h0))
    for t, r in zip((ta, tx, th), jg):
        _close(t.grad, r)
    with torch.no_grad():
        torch.testing.assert_close(trglru.rglru_scan(ta, tx, th), hs,
                                   atol=0, rtol=0)


def test_recurrent_block_gradients_match_jax():
    """The whole recurrent block (conv, gates, scan, output projection) of
    reduced recurrentgemma-2b: every weight's gradient against
    ``jax.grad`` of ``repro/nn/rglru.py::recurrent_block``."""
    from repro.configs import archs as jarchs
    from repro.distributed.sharding import init_params as jinit
    from repro_torch.configs import archs as tarchs
    jcfg = jarchs.REDUCED["recurrentgemma-2b"]
    tcfg = tarchs.REDUCED["recurrentgemma-2b"]
    jp = jinit(jax.random.PRNGKey(2), jrglru.rglru_param_defs(jcfg))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jrglru.recurrent_block(p, xx, jcfg)
        return jnp.sum(out * g)
    jgrads, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = trglru.recurrent_block(tp, tx, tcfg)
    (out * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jgx)
    for k, v in tp.items():
        _close(v.grad, jgrads[k])
