"""The port's ``flash_attention`` against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel run in interpret mode, on the same
numpy-seeded inputs: in float32 at the reference's own 2e-5
(``tests/test_kernels.py``) over its five shapes; in bfloat16 within one
bf16 unit (``BF16_RTOL``), tighter than the reference's 0.05. The CUDA
kernel is held against the plain version in tests that need the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# bfloat16: every side computes in float32 and rounds the output once, so
# two results round to the same value or, where their float32 values
# (~1e-6 apart, relative) straddle a rounding point, to neighbours one
# unit apart: at most 2^-7 |p| (8 significant bits). The atol covers
# outputs so near 0 that float32's ~1e-7 absolute difference is a large
# share of them
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5

# the reference's sweep (tests/test_kernels.py::test_flash_attention_sweep)
SWEEP = [
    (1, 2, 128, 128, 32, True, None, None),
    (2, 2, 128, 256, 64, True, None, None),     # cross attention
    (1, 4, 256, 256, 32, True, 64, None),       # local window
    (1, 2, 128, 128, 32, True, None, 30.0),     # softcap
    (2, 1, 128, 128, 64, False, None, None),    # bidirectional
]


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _qkv(b, h, sq, sk, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, h, sq, d)).astype(np.float32),
            r.normal(size=(b, h, sk, d)).astype(np.float32),
            r.normal(size=(b, h, sk, d)).astype(np.float32))


def _port(qkv, dtype=torch.float32, device="cpu", fn=tops.flash_attention,
          **kw):
    q, k, v = (torch.from_numpy(a).to(device=device, dtype=dtype)
               for a in qkv)
    return fn(q, k, v, **kw)


def _jax(jops, qkv, dtype=None, **kw):
    import jax.numpy as jnp
    q, k, v = (jnp.asarray(a, dtype=dtype or jnp.float32) for a in qkv)
    return np.asarray(jops.flash_attention(q, k, v, **kw).astype(
        jnp.float32))


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window,cap", SWEEP)
def test_sweep_matches_reference(jops, b, h, sq, sk, d, causal, window, cap):
    qkv = _qkv(b, h, sq, sk, d, seed=sq + sk + d)
    kw = dict(causal=causal, window=window, softcap=cap)
    ours = _port(qkv, q_tile=64, kv_tile=64, **kw)
    kern = _jax(jops, qkv, q_tile=64, kv_tile=64, **kw)
    assert ours.dtype == torch.float32 and ours.shape == (b, h, sq, d)
    np.testing.assert_allclose(ours.numpy(), kern, atol=2e-5, rtol=2e-5)


def test_bf16_matches_reference(jops):
    import jax.numpy as jnp
    qkv = _qkv(1, 2, 128, 128, 32, seed=1)
    ours = _port(qkv, torch.bfloat16, q_tile=64, kv_tile=64)
    kern = _jax(jops, qkv, jnp.bfloat16, q_tile=64, kv_tile=64)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), kern, atol=BF16_ATOL,
                               rtol=BF16_RTOL)


def test_rows_that_see_no_key_are_zero(jops):
    """Causal with Sq > Sk: the first Sq - Sk rows see no key. The kernel
    gives 0 there (its oracle gives NaN); the rest agree at 2e-5."""
    qkv = _qkv(1, 2, 256, 128, 32, seed=2)
    ours = _port(qkv, q_tile=64, kv_tile=64).numpy()
    kern = _jax(jops, qkv, q_tile=64, kv_tile=64)
    assert (ours[:, :, :128] == 0).all() and (kern[:, :, :128] == 0).all()
    np.testing.assert_allclose(ours, kern, atol=2e-5, rtol=2e-5)


def test_untiled_lengths_raise():
    qkv = _qkv(1, 1, 96, 128, 32)
    with pytest.raises(ValueError, match="tile"):
        _port(qkv, q_tile=64, kv_tile=64)
    with pytest.raises(ValueError, match="tile"):
        _port(_qkv(1, 1, 128, 96, 32), q_tile=64, kv_tile=64)
    with pytest.raises(ValueError):                   # H differs (GQA)
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 64, 64, 32))
        tops.flash_attention(q, k[:, :2], v[:, :2], q_tile=64, kv_tile=64)


def test_cpu_path_takes_the_plain_version_and_launches_nothing():
    qkv = _qkv(1, 2, 64, 64, 32, seed=3)
    before = tfa.flash_attention.launches
    ours = _port(qkv, window=16, softcap=20.0, q_tile=64, kv_tile=64)
    plain = _port(qkv, fn=tfa.flash_attention_ref, window=16, softcap=20.0)
    assert torch.equal(ours, plain)
    assert tfa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d,causal,window,cap", SWEEP + [
    (1, 2, 256, 128, 32, True, None, None),     # rows that see no key
    (1, 2, 200, 200, 128, True, 48, 50.0),      # ragged tiles, all options
    (1, 1, 96, 160, 256, False, None, None),
    (2, 4, 40, 40, 16, True, 16, None),         # the reduced configs' D
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(b, h, sq, sk, d, causal, window,
                                           cap, dtype):
    """The CUDA kernel against its plain version on the card: float32 at
    the reference's 2e-5 (sums in another order), bfloat16 within one
    bf16 unit (both compute in float32 and round the output once); bitwise
    equal across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    qkv = _qkv(b, h, sq, sk, d, seed=sq * d)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = tfa.flash_attention.launches
    outs = [_port(qkv, dt, "cuda", q_tile=sq, kv_tile=sk, **kw)
            for _ in range(2)]
    plain = _port(qkv, dt, "cuda", fn=tfa.flash_attention_ref, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 2
    assert outs[0].dtype == dt and torch.equal(outs[0], outs[1])
    rtol, atol = (2e-5, 2e-5) if dt == torch.float32 else (BF16_RTOL,
                                                           BF16_ATOL)
    torch.testing.assert_close(outs[0].float(), plain.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_cuda_reduced_lm_serves_through_the_kernel(monkeypatch):
    """``serve_lm`` at llama3-8b's reduced config (head width 16, float32)
    on the card: one kernel launch per layer in the prefill, none in
    decode, and the prefill's logits within 1e-4 of the same path with
    attention through the plain version (float32, sums in another
    order through two layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.configs.archs import REDUCED
    from repro_torch.launch import serve

    before = tfa.flash_attention.launches
    out = serve.serve_lm("llama3-8b", 4, device="cuda")
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - before == \
        REDUCED["llama3-8b"].num_layers
    assert out["tokens"].shape == (2, 4)

    def plain(q, k, v, *, causal, window, softcap, q_tile, kv_tile):
        return tfa.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    monkeypatch.setattr(tops, "flash_attention", plain)
    ref = serve.serve_lm("llama3-8b", 4, device="cuda")
    torch.testing.assert_close(out["last_logits"], ref["last_logits"],
                               atol=1e-4, rtol=1e-4)
