"""The port's ``seg_softmax`` against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel (two pallas_calls) run in interpret mode and
against the JAX oracle, on the same numpy-seeded inputs, at the
reference's own tolerance for this kernel: atol = rtol = 1e-5 (the Pallas
kernel rescales its denominator online, the oracles take the max first).
The last destinations receive no edge and about a fifth of the edges are
masked. The CUDA kernels are held against the plain version in a test that
needs the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import seg_softmax as tss  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _problem(shape, n=24, seed=0, scale=3.0, empty_tail=3, mask_p=0.8):
    r = np.random.default_rng(seed)
    e = shape[0]
    return {"logits": (r.normal(size=shape) * scale).astype(np.float32),
            "receivers": r.integers(0, n - empty_tail,
                                    size=e).astype(np.int64),
            "edge_mask": r.random(e) < mask_p}


def _torch(p, device="cpu"):
    return [torch.from_numpy(p[k]).to(device)
            for k in ("logits", "receivers", "edge_mask")]


def _jnp(p):
    import jax.numpy as jnp
    return [jnp.asarray(p["logits"]), jnp.asarray(p["receivers"], jnp.int32),
            jnp.asarray(p["edge_mask"])]


@pytest.mark.parametrize("shape,edge_tile,banks", [
    ((128,), 32, 4),
    ((128, 4), 32, 4),
    ((200, 3), 64, 5),           # ragged edge tiles and uneven banks
    ((96, 1), 32, 2),
])
def test_seg_softmax_matches_reference(jops, shape, edge_tile, banks):
    n = 24
    p = _problem(shape, n, seed=shape[0] + len(shape))
    ours = tops.seg_softmax(*_torch(p), n, edge_tile=edge_tile,
                            num_banks=banks)
    kern = jops.seg_softmax(*_jnp(p), n, edge_tile=edge_tile,
                            num_banks=banks)
    ref = jops.segment_softmax_ref(*_jnp(p), n)
    assert ours.shape == shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_masked_edges_are_exactly_zero_and_rows_sum_to_one(jops):
    n = 24
    p = _problem((160, 4), n, seed=7)
    ours = tops.seg_softmax(*_torch(p), n).numpy()
    kern = np.asarray(jops.seg_softmax(*_jnp(p), n, edge_tile=32,
                                       num_banks=4))
    masked = ~p["edge_mask"]
    assert (ours[masked] == 0.0).all() and (kern[masked] == 0.0).all()
    sums = np.zeros((n, 4))
    np.add.at(sums, p["receivers"][p["edge_mask"]], ours[p["edge_mask"]])
    reached = np.zeros(n, bool)
    reached[p["receivers"][p["edge_mask"]]] = True
    np.testing.assert_allclose(sums[reached], 1.0, atol=1e-5)
    assert (sums[~reached] == 0.0).all()


@pytest.mark.parametrize("shape", [(64,), (64, 2)])
def test_fully_masked_stream_gives_zero_weights(jops, shape):
    n = 16
    p = _problem(shape, n, seed=1)
    p["edge_mask"][:] = False
    ours = tops.seg_softmax(*_torch(p), n)
    kern = jops.seg_softmax(*_jnp(p), n, edge_tile=32, num_banks=4)
    assert (ours.numpy() == 0.0).all()
    assert (np.asarray(kern) == 0.0).all()


def test_extreme_logits_stay_finite(jops):
    """Logits of +-1e4: neither overflow nor 0/0."""
    n = 24
    p = _problem((160, 4), n, seed=3, scale=1e4)
    ours = tops.seg_softmax(*_torch(p), n)
    kern = jops.seg_softmax(*_jnp(p), n, edge_tile=32, num_banks=4)
    assert np.isfinite(ours.numpy()).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **TOL)


def _padding_row_problem(shape, n, banks, seed=0):
    """``default_rng(seed)`` logits and receivers in [0, N), every edge
    unmasked; the first five edges go to the padding rows [N, n_pad) (two
    to row N, three to row n_pad - 1) and the sixth to row n_pad, past
    them."""
    r = np.random.default_rng(seed)
    e = shape[0]
    n_pad = -(-n // banks) * banks
    rcv = r.integers(0, n, size=e).astype(np.int64)
    rcv[:6] = [n, n, n_pad - 1, n_pad - 1, n_pad - 1, n_pad]
    return {"logits": (r.normal(size=shape) * 3.0).astype(np.float32),
            "receivers": rcv, "edge_mask": np.ones(e, bool)}


@pytest.mark.parametrize("n,banks", [(30, 4), (29, 8)])
@pytest.mark.parametrize("shape", [(40,), (40, 2)])
def test_padding_row_receivers_follow_the_kernel(jops, shape, n, banks):
    """The JAX kernel keeps statistics for ceil(N, num_banks) rows, so an
    unmasked edge into a padding row [N, n_pad) is normalised with the
    other edges there; an edge past n_pad weighs 0."""
    p = _padding_row_problem(shape, n, banks)
    ours = tops.seg_softmax(*_torch(p), n, edge_tile=8, num_banks=banks)
    kern = np.asarray(jops.seg_softmax(*_jnp(p), n, edge_tile=8,
                                       num_banks=banks))
    np.testing.assert_allclose(ours.numpy(), kern, **TOL)
    assert (ours.numpy()[:5] > 0).all() and (ours.numpy()[5] == 0).all()
    plain = tss.segment_softmax_ref(*_torch(p), n, num_banks=banks)
    assert torch.equal(ours, plain)


def test_edge_permutation_invariance():
    n = 24
    p = _problem((128, 4), n, seed=9)
    perm = np.random.default_rng(2).permutation(128)
    q = {k: v[perm] for k, v in p.items()}
    a = tops.seg_softmax(*_torch(p), n).numpy()
    b = tops.seg_softmax(*_torch(q), n).numpy()
    np.testing.assert_allclose(a[perm], b, **TOL)


def test_wrapper_rejects_bad_input_and_launches_nothing_on_the_cpu():
    p = _problem((64, 2), 16, seed=4)
    lg, rcv, mask = _torch(p)
    with pytest.raises(ValueError):
        tops.seg_softmax(lg[:, :, None], rcv, mask, 16)
    before = tss.seg_softmax.launches
    ours = tops.seg_softmax(lg, rcv, mask, 16)
    assert torch.equal(ours, tss.segment_softmax_ref(lg, rcv, mask, 16))
    assert tss.seg_softmax.launches == before
    half = tops.seg_softmax(lg.to(torch.bfloat16), rcv, mask, 16)
    assert half.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [
    ((4096, 4), 1024),
    ((1024, 4), 64),
    ((3001,), 997),
    ((1000, 300), 61),
])
def test_cuda_kernel_matches_plain_version(shape, n):
    """The two CUDA launches vs the plain version on the card, bitwise
    equal across rows-per-block and runs; masked edges exactly 0. Both are
    fp32 with exponentials and sums in another order: 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = _problem(shape, n, seed=shape[0], empty_tail=16)
    args = _torch(p, "cuda")
    before = tss.seg_softmax.launches
    outs = [tops.seg_softmax(*args, n, rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 16)]
    plain = tss.segment_softmax_ref(*args, n)
    torch.cuda.synchronize()
    assert tss.seg_softmax.launches == before + 2 * len(outs)
    assert outs[0].shape == shape
    masked = ~args[2]
    assert (outs[0][masked] == 0).all()
    torch.testing.assert_close(outs[0], plain, **TOL)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
