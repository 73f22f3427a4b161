"""The MoE layer's gradients through the port's kernels' backward.

``mp_scatter``'s backward is ``gather_rows`` and ``gather_rows``' is
``mp_scatter`` (``MpScatterFn`` / ``GatherRowsFn``); on the CPU each runs
its plain version. Checked here:

* ``moe_ffn`` of reduced olmoe-1b-7b and arctic-480b (router, experts,
  aux loss; with and without the inner remat) against ``jax.grad`` of the
  reference's ``moe_ffn``, which differentiates ``.at[slot].set`` and
  ``.at[st].add``: float32, 1e-5 of each gradient's scale;
* each dual backward against autograd of the plain ``mp_scatter_ref`` /
  ``gather_rows_ref``, with masked rows and indices outside [0, N).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.kernels import gather_rows as tgr  # noqa: E402
from repro_torch.kernels import mp_scatter as tms  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

TOL = 1e-5


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    scale = max(1e-30, float(np.abs(ref).max()))
    err = float(np.abs(ours.detach().numpy() - ref).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
@pytest.mark.parametrize("inner_remat", [True, False])
def test_moe_ffn_gradients_match_jax_grad(arch, inner_remat):
    jcfg = jarchs.REDUCED[arch].replace(moe_inner_remat=inner_remat)
    tcfg = tarchs.REDUCED[arch].replace(moe_inner_remat=inner_remat)
    jp = jinit(jax.random.PRNGKey(1), jmoe.moe_param_defs(jcfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jcfg, group_size=16)
        return jnp.sum(out * g) + 0.5 * aux
    jval = jloss(jp, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tp, tx, tcfg, group_size=16)
    loss = (out * torch.from_numpy(g)).sum() + 0.5 * aux
    _close(loss, jval)
    loss.backward()
    _close(tx.grad, jgx)
    for k, v in tp.items():
        assert v.grad is not None, k
        _close(v.grad, jgp[k])


def _stream(seed, e=200, n=37, d=6):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(-4, n + 4, e))
    mask = torch.from_numpy(rng.random(e) < 0.7)
    return rng, idx, mask, e, n, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_scatter_backward_is_gather_rows(dtype):
    dt = getattr(torch, dtype)
    rng, idx, mask, e, n, d = _stream(2)
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(dt)
    gout = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dt)
    a = msg.clone().requires_grad_()
    out = tms.mp_scatter(a, idx, mask, n)
    assert out.dtype == dt and out.grad_fn is not None
    out.backward(gout)
    b = msg.clone().requires_grad_()
    tms.mp_scatter_ref(b, idx, mask, n).to(dt).backward(gout)
    assert a.grad.dtype == dt
    torch.testing.assert_close(a.grad, b.grad, atol=0, rtol=0)
    own = mask & (idx >= 0) & (idx < n)
    assert not a.grad[~own].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_backward_is_mp_scatter(dtype):
    dt = getattr(torch, dtype)
    rng, idx, mask, e, n, d = _stream(3)
    y = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dt)
    gout = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    a = y.clone().requires_grad_()
    out = tgr.gather_rows(a, idx, mask, idx_tile=1, num_banks=1)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    out.backward(gout)
    # the plain version's gradient summed in float32 and rounded once, as
    # the scatter sums (autograd of a bf16 gather would add in bf16)
    b = y.float().requires_grad_()
    tgr.gather_rows_ref(b, idx, mask).backward(gout)
    assert a.grad.dtype == dt
    # float32 sums in other orders, then (bf16) one rounding each: one bf16
    # unit of the value apart at most
    rtol = 1e-6 if dt == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(a.grad.float(), b.grad.to(dt).float(),
                               atol=1e-6, rtol=rtol)


def test_kernel_functions_only_under_grad():
    """Serving calls (nothing requires grad, or no_grad) take the direct
    path, with no graph."""
    rng, idx, mask, e, n, d = _stream(4)
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    assert tms.mp_scatter(msg, idx, mask, n).grad_fn is None
    with torch.no_grad():
        leaf = msg.clone().requires_grad_()
        assert tms.mp_scatter(leaf, idx, mask, n).grad_fn is None
        assert tgr.gather_rows(leaf[:n], idx, mask, idx_tile=1,
                               num_banks=1).grad_fn is None
