"""The backward of the port's flash attention against the JAX package's.

``repro/nn/flash.py::flash_mha`` is a custom VJP (``_fwd`` saves (q, k, v,
out, lse), ``_bwd`` recomputes each block's probabilities); the port's twin
is ``repro_torch/nn/flash.py::flash_mha`` over ``FlashAttentionFn``, whose
backward on the CPU is ``flash_attention_bwd_ref``. Both sides get the same
seeded numpy inputs and output gradient; float32 on the CPU, held at
1e-5 of each gradient's scale (sums in other orders). Also: the plain lse
against ``_fwd``'s residual, GQA through both packages'
``chunked_attention`` (autograd of the KV repeat sums the groups back), a
float64 ``gradcheck`` of the Function.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.nn import attention as jattn  # noqa: E402
from repro.nn import flash as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import flash as tflash  # noqa: E402

TOL = 1e-5

# (B, Sq, Sk, H, D, causal, window, softcap, q scale): each form the
# forward takes; the q scale makes the softcap bend the scores
FORMS = {
    "causal": (2, 24, 24, 2, 16, True, None, None, 1.0),
    "window": (1, 32, 32, 2, 16, True, 9, None, 1.0),
    "softcap": (1, 16, 16, 3, 8, True, None, 2.0, 4.0),
    "window_softcap": (2, 24, 24, 2, 16, True, 7, 3.0, 3.0),
    "sq_lt_sk": (1, 8, 24, 2, 16, True, None, None, 1.0),
    "sq_lt_sk_window": (1, 8, 32, 2, 8, True, 12, 5.0, 2.0),
    "not_causal": (1, 16, 24, 2, 8, False, None, None, 1.0),
    "rows_see_no_key": (1, 24, 8, 2, 8, True, None, None, 1.0),
}


def _inputs(b, sq, sk, h, d, q_scale, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32) * q_scale
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    g = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _spec(sq, sk, causal, window, cap):
    return jflash.FlashSpec(causal=causal, window=window, softcap=cap,
                            q_chunk=8, kv_chunk=8, sq_real=sq, sk_real=sk,
                            unroll=True)


def _close(ours, ref):
    ref = np.asarray(ref)
    scale = max(1e-30, float(np.abs(ref).max()))
    err = float(np.abs(ours.detach().numpy() - ref).max())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_flash_mha_backward_matches_jax_vjp(form):
    b, sq, sk, h, d, causal, window, cap, qs = FORMS[form]
    q, k, v, g = _inputs(b, sq, sk, h, d, qs, seed=sq * 7 + sk)
    spec = _spec(sq, sk, causal, window, cap)
    ref_out, vjp = jax.vjp(lambda a, b_, c: jflash.flash_mha(a, b_, c, spec),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_mha(*leaves, spec)
    assert out.grad_fn is not None
    _close(out, ref_out)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        _close(leaf.grad, r)
    if sq > sk and causal:
        assert not leaves[0].grad[:, :sq - sk].any()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_backward_matches_jax_bwd_on_the_same_residuals(form):
    """``flash_attention_bwd_ref`` and the lse of ``flash_attention_ref``
    against ``_fwd`` / ``_bwd`` directly, in the kernels' (B, H, S, D)
    layout."""
    b, sq, sk, h, d, causal, window, cap, qs = FORMS[form]
    q, k, v, g = _inputs(b, sq, sk, h, d, qs, seed=sq + sk)
    spec = _spec(sq, sk, causal, window, cap)
    jout, (_, _, _, _, jlse) = jflash._fwd(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), spec)
    jgrads = jflash._bwd(spec, (jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jout, jlse), jnp.asarray(g))

    def bh(x):
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    out, lse = tfa.flash_attention_ref(bh(q), bh(k), bh(v), causal=causal,
                                       window=window, softcap=cap,
                                       with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    seen = np.asarray(jlse) > -1e29
    np.testing.assert_allclose(lse.numpy()[seen], np.asarray(jlse)[seen],
                               atol=1e-5, rtol=1e-6)
    assert (lse.numpy()[~seen] < -1e29).all()
    grads = tfa.flash_attention_bwd_ref(bh(q), bh(k), bh(v), out, lse, bh(g),
                                        causal=causal, window=window,
                                        softcap=cap)
    for ours, ref in zip(grads, jgrads):
        _close(ours.transpose(1, 2), ref)


@pytest.mark.parametrize("hk,window,cap", [(1, None, None), (2, 6, 3.0)])
def test_gqa_chunked_attention_backward_matches_jax(hk, window, cap):
    """Four query heads over 1 or 2 KV heads: the port repeats the KV heads
    with ``repeat_interleave`` and autograd sums the group gradients back,
    as the reference's ``jnp.repeat`` transposes."""
    rng = np.random.default_rng(hk)
    b, s, h, d = 2, 20, 4, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32) * 2
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    g = rng.normal(size=(b, s, h, d)).astype(np.float32)
    kw = dict(causal=True, window=window, logit_softcap=cap, q_chunk=8,
              kv_chunk=8)
    _, vjp = jax.vjp(lambda a, b_, c: jattn.chunked_attention(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.chunked_attention(*leaves, **kw)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == r.shape
        _close(leaf.grad, r)


@pytest.mark.parametrize("causal,window,cap,sq,sk", [
    (True, None, None, 6, 6), (True, 3, 2.0, 5, 9), (False, None, 1.5, 7, 4),
    (True, None, None, 8, 3)])
def test_function_passes_gradcheck_in_float64(causal, window, cap, sq, sk):
    gen = torch.Generator().manual_seed(sq * sk)
    q, k, v = (torch.randn(1, 2, n, 4, generator=gen, dtype=torch.float64,
                           requires_grad=True) for n in (sq, sk, sk))

    def fn(a, b, c):
        return tfa.flash_attention(a, b, c, causal=causal, window=window,
                                   softcap=cap, q_tile=sq, kv_tile=sk)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_flash_mha_rejects_padded_lengths():
    q = torch.zeros(1, 8, 2, 8)
    spec = tflash.FlashSpec(True, None, None, 8, 8, 6, 8, False)
    with pytest.raises(ValueError, match="unpadded"):
        tflash.flash_mha(q, q, q, spec)


def test_function_saves_for_backward_only_under_grad():
    """No lse and no graph where nothing requires grad or under no_grad: the
    serving call is the plain forward."""
    q = torch.randn(1, 2, 8, 8)
    out = tfa.flash_attention(q, q, q, q_tile=8, kv_tile=8)
    assert out.grad_fn is None
    leaf = q.clone().requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(leaf, q, q, q_tile=8,
                                   kv_tile=8).grad_fn is None
    assert tfa.flash_attention(leaf, q, q, q_tile=8,
                               kv_tile=8).grad_fn is not None
