"""The port's ``mp_scatter`` and ``mp_scatter_multi`` against the JAX
package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels run in interpret mode and against the
JAX oracles, on the same numpy-seeded inputs, at the reference's own kernel
tolerance: atol = rtol = 2e-5. The last destinations receive no edge and
about a fifth of the edges are masked. The CUDA kernels are held against
the plain versions in tests that need the card.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mp_scatter as tms  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ALL_STATS = tms.MULTI_STATS
TOL = dict(atol=2e-5, rtol=2e-5)
# each statistic alone, PNA's four, everything
SUBSETS = [(s,) for s in ALL_STATS] + [("sum", "sumsq", "max", "min"),
                                        ALL_STATS]
SHAPES = [
    (128, 16, 32, 32, 2),
    (200, 8, 30, 64, 4),         # ragged: E % tile != 0, N % banks != 0
    (96, 24, 17, 32, 5),         # uneven bank sizes
]


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _problem(e=200, d=8, n=30, seed=0, mask_p=0.8, empty_tail=4):
    """Numpy inputs; the last ``empty_tail`` destinations receive no
    edge."""
    r = np.random.default_rng(seed)
    return {"msg": r.normal(size=(e, d)).astype(np.float32),
            "receivers": r.integers(0, max(n - empty_tail, 1),
                                    size=e).astype(np.int64),
            "edge_mask": r.random(e) < mask_p}


def _torch(p, device="cpu"):
    return [torch.from_numpy(p[k]).to(device)
            for k in ("msg", "receivers", "edge_mask")]


def _jnp(p):
    import jax.numpy as jnp
    return [jnp.asarray(p["msg"]), jnp.asarray(p["receivers"], jnp.int32),
            jnp.asarray(p["edge_mask"])]


def _flags(stats):
    return {f"want_{s}": s in stats for s in ALL_STATS}


@pytest.mark.parametrize("e,d,n,edge_tile,banks", SHAPES)
def test_mp_scatter_matches_reference(jops, e, d, n, edge_tile, banks):
    p = _problem(e, d, n, seed=e + n)
    ours = tops.mp_scatter(*_torch(p), n, edge_tile=edge_tile,
                           num_banks=banks)
    kern = jops.mp_scatter(*_jnp(p), n, edge_tile=edge_tile, num_banks=banks)
    ref = jops.mp_scatter_ref(*_jnp(p), n)
    assert ours.shape == (n, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert (ours.numpy()[n - 4:] == 0.0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=["tiles", "ragged", "banks5"])
@pytest.mark.parametrize("stats", SUBSETS, ids="+".join)
def test_mp_scatter_multi_matches_reference(jops, stats, shape):
    e, d, n, edge_tile, banks = shape
    p = _problem(e, d, n, seed=e + len(stats))
    ours = tops.mp_scatter_multi(*_torch(p), n, **_flags(stats),
                                 edge_tile=edge_tile, num_banks=banks)
    kern = jops.mp_scatter_multi(*_jnp(p), n, **_flags(stats),
                                 edge_tile=edge_tile, num_banks=banks)
    ref = jops.mp_scatter_multi_ref(*_jnp(p), n, stats)
    # a dict out of jax.jit comes back with its keys sorted
    assert tuple(ours) == tuple(ref) == stats and set(kern) == set(stats)
    for name, v in ours.items():
        assert v.dtype == torch.float32
        assert v.shape == ((n, 1) if name == "count" else (n, d))
        np.testing.assert_allclose(v.numpy(), np.asarray(kern[name]),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)


def test_empty_destinations_are_exact(jops):
    """Rows no unmasked edge reaches: sum, sumsq and count 0, max -inf,
    min +inf, on both sides. Node 0 is reached only by masked edges, as
    padding is."""
    e, d, n = 96, 8, 16
    p = _problem(e, d, n, seed=1)
    p["edge_mask"][p["receivers"] == 0] = False
    empty = [0, n - 4, n - 3, n - 2, n - 1]
    ours = tops.mp_scatter_multi(*_torch(p), n, **_flags(ALL_STATS))
    kern = jops.mp_scatter_multi(*_jnp(p), n, **_flags(ALL_STATS),
                                 edge_tile=32, num_banks=4)
    for name, want in (("sum", 0.0), ("sumsq", 0.0), ("count", 0.0),
                       ("max", -np.inf), ("min", np.inf)):
        assert (ours[name].numpy()[empty] == want).all(), name
        assert (np.asarray(kern[name])[empty] == want).all(), name
    assert (ours["count"].numpy()[1:n - 4] > 0).any()


@pytest.mark.parametrize("stats", [("sum",), ALL_STATS], ids="+".join)
def test_fully_masked_stream_gives_the_neutrals(jops, stats):
    e, d, n = 64, 4, 16
    p = _problem(e, d, n, seed=2)
    p["edge_mask"][:] = False
    ours = tops.mp_scatter_multi(*_torch(p), n, **_flags(stats))
    kern = jops.mp_scatter_multi(*_jnp(p), n, **_flags(stats), edge_tile=32,
                                 num_banks=2)
    neutral = {"sum": 0.0, "sumsq": 0.0, "count": 0.0, "max": -np.inf,
               "min": np.inf}
    for name in stats:
        assert (ours[name].numpy() == neutral[name]).all(), name
        assert (np.asarray(kern[name]) == neutral[name]).all(), name
    assert (tops.mp_scatter(*_torch(p), n).numpy() == 0.0).all()


def test_mp_scatter_keeps_the_message_dtype(jops):
    """bf16 messages: f32 accumulation, bf16 out, as the reference's
    ``test_mp_scatter_preserves_dtype_and_parity`` (its tolerance)."""
    import jax.numpy as jnp
    p = _problem(128, 8, 32, seed=3)
    msg, rcv, mask = _torch(p)
    ours = tops.mp_scatter(msg.to(torch.bfloat16), rcv, mask, 32)
    jm, jr, jk = _jnp(p)
    kern = jops.mp_scatter(jm.astype(jnp.bfloat16), jr, jk, 32, edge_tile=32,
                           num_banks=4)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


def test_edge_permutation_invariance():
    p = _problem(128, 8, 32, seed=9)
    perm = np.random.default_rng(2).permutation(128)
    q = {k: v[perm] for k, v in p.items()}
    a = tops.mp_scatter_multi(*_torch(p), 32, **_flags(ALL_STATS))
    b = tops.mp_scatter_multi(*_torch(q), 32, **_flags(ALL_STATS))
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_wrappers_reject_bad_input():
    p = _problem()
    msg, rcv, mask = _torch(p)
    with pytest.raises(ValueError):                  # no statistic
        tops.mp_scatter_multi(msg, rcv, mask, 30)
    with pytest.raises(ValueError):
        tms.mp_scatter_multi(msg, rcv, mask, 30, stats=("median",))
    with pytest.raises(ValueError):                  # 1-D messages
        tops.mp_scatter(msg[:, 0], rcv, mask, 30)
    with pytest.raises(ValueError):
        tops.mp_scatter_multi(msg[:, 0], rcv, mask, 30, want_sum=True)


def test_cpu_path_takes_the_plain_version_and_launches_nothing():
    p = _problem(64, 8, 16, seed=9)
    before = (tms.mp_scatter.launches, tms.mp_scatter_multi.launches)
    ours = tops.mp_scatter_multi(*_torch(p), 16, **_flags(ALL_STATS))
    plain = tms.mp_scatter_multi_ref(*_torch(p), 16, ALL_STATS)
    assert all(torch.equal(ours[k], plain[k]) for k in plain)
    assert torch.equal(tops.mp_scatter(*_torch(p), 16),
                       tms.mp_scatter_ref(*_torch(p), 16))
    assert (tms.mp_scatter.launches,
            tms.mp_scatter_multi.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(e=4096, d=100, n=1024, stats=("sum",)),
    dict(e=4096, d=80, n=1024, stats=("sum", "sumsq", "max", "min")),
    dict(e=3001, d=200, n=997, stats=ALL_STATS),
    dict(e=1000, d=300, n=61, stats=ALL_STATS),
    dict(e=1024, d=9, n=64, stats=("count", "max")),
])
def test_cuda_kernel_matches_plain_version(case):
    """The CUDA kernels vs their plain versions on the card, bitwise equal
    across rows-per-block and runs. Both are fp32 with sums in another
    order, so they agree to 1e-4 of each output's scale; empty rows, and
    every max and min, are exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e, d, n, stats = case["e"], case["d"], case["n"], case["stats"]
    p = _problem(e, d, n, seed=e, empty_tail=32)
    args = _torch(p, "cuda")
    before = tms.mp_scatter_multi.launches
    outs = [tops.mp_scatter_multi(*args, n, **_flags(stats),
                                  rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 16)]
    plain = tms.mp_scatter_multi_ref(*args, n, stats)
    sums = [tops.mp_scatter(*args, n, rows_per_block=rpb)
            for rpb in (None, None, 1, 16)]
    torch.cuda.synchronize()
    assert tms.mp_scatter_multi.launches == before + len(outs)
    assert tuple(outs[0]) == tuple(plain) == stats
    for name, want in plain.items():
        got = outs[0][name]
        if name in ("max", "min"):
            assert torch.equal(got, want), name
        else:
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, atol=1e-4 * scale,
                                       rtol=1e-4, msg=name)
        for o in outs[1:]:
            assert torch.equal(o[name], got), name
    want = tms.mp_scatter_ref(*args, n)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(sums[0], want, atol=1e-4 * scale, rtol=1e-4)
    assert (sums[0][n - 32:] == 0).all()
    for a, b in itertools.pairwise(sums):
        assert torch.equal(a, b)


OUT_OF_RANGE_KERNELS = ("mp_scatter", "mp_scatter_multi", "seg_softmax")


def _out_of_range_problem(e=160, d=6, n=32, seed=5, mask_p=0.8):
    """Receivers spread over [-4, N + 12): edges outside [0, N), masked or
    not, as the MoE dispatch's trash slot ``E_loc * capacity`` is. N is a
    multiple of every bank count used, so no receiver lands in the JAX
    kernels' padding rows."""
    r = np.random.default_rng(seed)
    return {"msg": r.normal(size=(e, d)).astype(np.float32),
            "receivers": r.integers(-4, n + 12, size=e).astype(np.int64),
            "edge_mask": r.random(e) < mask_p}


@pytest.mark.parametrize("masked", [True, False],
                         ids=["masked", "unmasked"])
@pytest.mark.parametrize("kernel", OUT_OF_RANGE_KERNELS)
def test_out_of_range_receivers_are_dropped(jops, kernel, masked):
    """Edges whose receiver lies outside [0, N) add nothing, as in the
    interpret-mode JAX kernels; the plain versions used to raise on them
    (``index_add_`` / ``scatter_reduce``: index out of bounds)."""
    n = 32
    p = _out_of_range_problem(n=n)
    outside = (p["receivers"] < 0) | (p["receivers"] >= n)
    assert outside.sum() > 10
    p["edge_mask"][outside] = not masked
    msg, rcv, mask = _torch(p)
    jm, jr, jk = _jnp(p)
    if kernel == "mp_scatter":
        ours = {"sum": tops.mp_scatter(msg, rcv, mask, n)}
        kern = {"sum": jops.mp_scatter(jm, jr, jk, n, edge_tile=32,
                                       num_banks=4)}
    elif kernel == "mp_scatter_multi":
        ours = tops.mp_scatter_multi(msg, rcv, mask, n, **_flags(ALL_STATS))
        kern = jops.mp_scatter_multi(jm, jr, jk, n, **_flags(ALL_STATS),
                                     edge_tile=32, num_banks=4)
    else:
        ours = {"w": tops.seg_softmax(msg[:, :2], rcv, mask, n)}
        kern = {"w": jops.seg_softmax(jm[:, :2], jr, jk, n, edge_tile=32,
                                      num_banks=4)}
        assert (ours["w"].numpy()[outside] == 0.0).all()
    for name, v in ours.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(kern[name]),
                                   err_msg=name, **TOL)
    if kernel != "seg_softmax":
        # the same as the in-range edges alone
        keep = ~outside
        q = {k: v[keep] for k, v in p.items()}
        inside = tops.mp_scatter(*_torch(q), n)
        np.testing.assert_array_equal(ours["sum"].numpy(), inside.numpy())
