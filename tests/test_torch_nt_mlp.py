"""The port's ``nt_mlp`` and ``fused_nt_scatter`` against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels run in interpret mode and the JAX
oracles, on the same numpy-seeded inputs, at the reference's own
tolerances (``tests/test_kernels.py``): ``nt_mlp`` 3e-5, ``fused_nt_scatter``
1e-4, at the reference's shapes and at GIN's 100 -> 200 -> 100. bf16 and
f16 operands widen exactly to float32 on both sides, so ``fused_nt_scatter``
keeps its float32 tolerance; ``nt_mlp`` rounds its float32 result into the
operands' type on both sides, so the two may differ by one unit in the last
place of that type (2^-7 of the value in bf16, 2^-10 in f16) where the
float32 sums straddle a rounding point. The CUDA kernels are held against
the plain versions in tests that need the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_nt_scatter as tfs  # noqa: E402
from repro_torch.kernels import nt_mlp as tnt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

NT_TOL = dict(atol=3e-5, rtol=3e-5)
FUSED_TOL = dict(atol=1e-4, rtol=1e-4)
# one unit in the last place of a 16-bit result, relative to the value
ULP16 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
MLP = ("x", "w1", "b1", "w2", "b2")
EDGES = ("senders", "receivers", "edge_mask", "edge_feat")


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _mlp(r, n, din, dff, dout):
    return {"x": r.normal(size=(n, din)).astype(np.float32),
            "w1": (r.normal(size=(din, dff)) * 0.2).astype(np.float32),
            "b1": r.normal(size=(dff,)).astype(np.float32),
            "w2": (r.normal(size=(dff, dout)) * 0.2).astype(np.float32),
            "b2": r.normal(size=(dout,)).astype(np.float32)}


def _problem(n, din, dff, d, e=0, seed=0, lo=0, hi=None):
    r = np.random.default_rng(seed)
    p = _mlp(r, n, din, dff, d)
    if e:
        hi = n if hi is None else hi
        p["senders"] = r.integers(lo, hi, size=e).astype(np.int64)
        p["receivers"] = r.integers(lo, hi, size=e).astype(np.int64)
        p["edge_mask"] = r.random(e) < 0.9
        p["edge_feat"] = r.normal(size=(e, d)).astype(np.float32)
    return p


def _torch(p, keys, device="cpu", dtype=None):
    """The operands named by ``keys`` as tensors; float ones in ``dtype``
    where it is given."""
    out = [torch.from_numpy(p[k]).to(device) for k in keys]
    return [t.to(getattr(torch, dtype)) if dtype and t.is_floating_point()
            else t for t in out]


def _jnp(p, keys, dtype=None):
    import jax.numpy as jnp
    out = [jnp.asarray(p[k], jnp.int32) if p[k].dtype == np.int64
           else jnp.asarray(p[k]) for k in keys]
    return [a.astype(getattr(jnp, dtype)) if dtype
            and jnp.issubdtype(a.dtype, jnp.floating) else a for a in out]


NT_SHAPES = [
    (64, 32, 48, 24, 32, 32),
    (128, 64, 96, 64, 64, 32),
    (128, 128, 64, 32, 32, 64),
    (64, 100, 200, 100, 32, 50),          # GIN's MLP at the hep bucket
]


@pytest.mark.parametrize("n,din,dff,dout,node_tile,k_tile", NT_SHAPES)
def test_nt_mlp_matches_reference(jops, n, din, dff, dout, node_tile,
                                  k_tile):
    p = _problem(n, din, dff, dout, seed=n + din)
    ours = tops.nt_mlp(*_torch(p, MLP), node_tile=node_tile, k_tile=k_tile)
    kern = jops.nt_mlp(*_jnp(p, MLP), node_tile=node_tile, k_tile=k_tile)
    ref = jops.nt_mlp_ref(*_jnp(p, MLP))
    assert ours.shape == (n, dout) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **NT_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **NT_TOL)


def test_nt_mlp_returns_the_input_dtype(jops):
    """bf16 x and weights (the port takes one dtype for all): float32
    inside, bf16 out, as the Pallas kernel (its bf16 tolerance)."""
    import jax.numpy as jnp
    p = _problem(64, 32, 48, 24, seed=2)
    ours = tops.nt_mlp(*_torch(p, MLP, dtype="bfloat16"), node_tile=32,
                       k_tile=32)
    kern = jops.nt_mlp(*_jnp(p, MLP, "bfloat16"), node_tile=32, k_tile=32)
    assert ours.dtype == torch.bfloat16 and kern.dtype == jnp.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_nt_mlp_16bit_operands_match_reference(jops, dtype):
    """x and the weights in bf16 or f16 at GIN's MLP: widened exactly,
    summed in float32, rounded once into the dtype on both sides; within
    one unit in the last place (plus the float32 tolerance) of the Pallas
    kernel's and of the oracle's result rounded the same way."""
    import jax.numpy as jnp
    p = _problem(64, 100, 200, 100, seed=5)
    ours = tops.nt_mlp(*_torch(p, MLP, dtype=dtype), node_tile=32,
                       k_tile=50)
    kern = jops.nt_mlp(*_jnp(p, MLP, dtype), node_tile=32, k_tile=50)
    ref = jops.nt_mlp_ref(*_jnp(p, MLP, dtype)).astype(getattr(jnp, dtype))
    assert ours.dtype == getattr(torch, dtype) and kern.dtype == ref.dtype
    scale = max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))
    for want in (kern, ref):
        np.testing.assert_allclose(
            ours.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=NT_TOL["atol"] * scale, rtol=ULP16[dtype])


FUSED_SHAPES = [
    (64, 128, 32, 48, 24, 32),
    (96, 256, 16, 32, 64, 32),
    (64, 512, 100, 200, 100, 32),         # GIN's MLP
]


@pytest.mark.parametrize("n,e,din,dff,d,node_tile", FUSED_SHAPES)
def test_fused_nt_scatter_matches_reference(jops, n, e, din, dff, d,
                                            node_tile):
    p = _problem(n, din, dff, d, e=e, seed=e + d)
    ours = tops.fused_nt_scatter(*_torch(p, MLP + EDGES),
                                 node_tile=node_tile)
    kern = jops.fused_nt_scatter(*_jnp(p, MLP + EDGES), node_tile=node_tile)
    # the oracle takes edge_feat before edge_mask
    oracle_order = MLP + ("senders", "receivers", "edge_feat", "edge_mask")
    ref = jops.fused_nt_scatter_ref(*_jnp(p, oracle_order))
    plain = tops.fused_nt_scatter_ref(*_torch(p, oracle_order))
    assert ours.shape == (n, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **FUSED_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FUSED_TOL)
    assert torch.equal(ours, plain)


@pytest.mark.parametrize("mlp_dtype,edge_dtype", [
    ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("float32", "bfloat16")])
def test_fused_nt_scatter_16bit_operands_match_reference(jops, mlp_dtype,
                                                         edge_dtype):
    """bf16 / f16 MLP operands and edge features at GIN's MLP: widened
    exactly to float32, so the float32 tolerance holds against the Pallas
    kernel and the oracle; the port's plain version is the oracle's
    arithmetic on the same widened values."""
    n, e, d = 64, 512, 100
    p = _problem(n, 100, 200, d, e=e, seed=9)
    mlp = _torch(p, MLP, dtype=mlp_dtype)
    snd, rcv, mask, ef = _torch(p, EDGES, dtype=edge_dtype)
    ours = tops.fused_nt_scatter(*mlp, snd, rcv, mask, ef, node_tile=32)
    jm = _jnp(p, MLP, mlp_dtype)
    jsnd, jrcv, jmask, jef = _jnp(p, EDGES, edge_dtype)
    kern = jops.fused_nt_scatter(*jm, jsnd, jrcv, jmask, jef, node_tile=32)
    ref = jops.fused_nt_scatter_ref(*jm, jsnd, jrcv, jef, jmask)
    plain = tops.fused_nt_scatter_ref(*[t.float() for t in mlp], snd, rcv,
                                      ef.float(), mask)
    assert ours.shape == (n, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **FUSED_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FUSED_TOL)
    assert torch.equal(ours, plain)


@pytest.mark.parametrize("kernel", ["nt_mlp", "fused_nt_scatter"])
@pytest.mark.parametrize("operand", ["w1", "b1", "w2", "b2"])
def test_mixed_dtypes_raise_before_any_launch(kernel, operand):
    """The MLP's operands share x's dtype, or the wrapper raises a
    ValueError naming the one that differs, before it launches anything
    (here on the CPU; the card path makes the same check first)."""
    p = _problem(32, 16, 24, 8, e=64, seed=3)
    args = dict(zip(MLP + EDGES, _torch(p, MLP + EDGES)))
    args[operand] = args[operand].to(torch.bfloat16)
    before = (tnt.nt_mlp.launches, tfs.fused_nt_scatter.launches)
    with pytest.raises(ValueError, match=operand):
        if kernel == "nt_mlp":
            tops.nt_mlp(*(args[k] for k in MLP), node_tile=32, k_tile=16)
        else:
            tops.fused_nt_scatter(*(args[k] for k in MLP + EDGES),
                                  node_tile=32)
    assert (tnt.nt_mlp.launches, tfs.fused_nt_scatter.launches) == before


def test_fused_nt_scatter_out_of_range_edges_add_nothing(jops):
    """Senders or receivers outside [0, N) add nothing, as in the Pallas
    kernel (its oracle clips the sender instead): held against the kernel
    alone."""
    n, e = 64, 256
    p = _problem(n, 16, 32, 24, e=e, seed=8, lo=-4, hi=n + 8)
    outside = ((p["senders"] < 0) | (p["senders"] >= n)
               | (p["receivers"] < 0) | (p["receivers"] >= n))
    assert (outside & p["edge_mask"]).sum() > 10
    ours = tops.fused_nt_scatter(*_torch(p, MLP + EDGES), node_tile=32)
    kern = jops.fused_nt_scatter(*_jnp(p, MLP + EDGES), node_tile=32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **FUSED_TOL)
    q = dict(p, edge_mask=p["edge_mask"] & ~outside)
    inside = tops.fused_nt_scatter(*_torch(q, MLP + EDGES), node_tile=32)
    assert torch.equal(ours, inside)


@pytest.mark.parametrize("which", ["nt_node_tile", "nt_k_tile",
                                   "fused_node_tile"])
def test_padding_rules(jops, which):
    """The reference's ValueErrors: N % node_tile, D_in % k_tile."""
    p = _problem(48, 24, 16, 8, e=32, seed=1)
    for side, prep in ((tops, lambda k: _torch(p, k)),
                       (jops, lambda k: _jnp(p, k))):
        with pytest.raises(ValueError):
            if which == "nt_node_tile":
                side.nt_mlp(*prep(MLP), node_tile=32, k_tile=8)
            elif which == "nt_k_tile":
                side.nt_mlp(*prep(MLP), node_tile=16, k_tile=16)
            else:
                side.fused_nt_scatter(*prep(MLP + EDGES), node_tile=32)


def test_cpu_path_takes_the_plain_version_and_launches_nothing():
    p = _problem(64, 16, 32, 8, e=128, seed=4)
    before = (tnt.nt_mlp.launches, tfs.fused_nt_scatter.launches)
    assert torch.equal(tops.nt_mlp(*_torch(p, MLP), node_tile=32, k_tile=16),
                       tnt.nt_mlp_ref(*_torch(p, MLP)))
    tops.fused_nt_scatter(*_torch(p, MLP + EDGES))
    assert (tnt.nt_mlp.launches, tfs.fused_nt_scatter.launches) == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _close_to_scale(got, want, tol=1e-4):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,din,dff,dout", [(1024, 100, 200, 100),
                                            (32, 100, 200, 100),
                                            (997, 64, 128, 64),
                                            (300, 9, 1000, 3)])
def test_cuda_nt_mlp_matches_plain_version(n, din, dff, dout):
    """The CUDA kernel against its plain version (cuBLAS, TF32 off): both
    fp32 with sums in another order, so within 1e-4 of the scale; bitwise
    across runs and rows per block."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    p = _problem(n, din, dff, dout, seed=n)
    args = _torch(p, MLP, "cuda")
    before = tnt.nt_mlp.launches
    outs = [tnt.nt_mlp(*args, node_tile=1, k_tile=1, rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 16)]
    plain = tnt.nt_mlp_ref(*args)
    torch.cuda.synchronize()
    assert tnt.nt_mlp.launches == before + len(outs)
    _close_to_scale(outs[0], plain)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,din,dff,d", [(1024, 4096, 64, 128, 64),
                                           (64, 1024, 100, 200, 100),
                                           (997, 3001, 16, 32, 300)])
def test_cuda_fused_nt_scatter_matches_plain_version(n, e, din, dff, d):
    """The two CUDA launches against the plain version and against nt_mlp
    followed by mp_pipeline's relu(y[src] + edge_term) sum; bitwise across
    runs and rows per block; out-of-range edges add nothing."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.mp_pipeline import mp_pipeline
    p = _problem(n, din, dff, d, e=e, seed=e, lo=-2, hi=n + 3)
    args = _torch(p, MLP + EDGES, "cuda")
    before = tfs.fused_nt_scatter.launches
    outs = [tfs.fused_nt_scatter(*args, node_tile=1, rows_per_block=rpb)
            for rpb in (None, None, 1, 5)]
    x, w1, b1, w2, b2, snd, rcv, mask, ef = args
    plain = tfs.fused_nt_scatter_ref(x, w1, b1, w2, b2, snd, rcv, ef, mask)
    inside = mask & (snd >= 0) & (snd < n) & (rcv >= 0) & (rcv < n)
    y = tnt.nt_mlp(x, w1, b1, w2, b2, node_tile=1, k_tile=1)
    two = mp_pipeline(y, snd.clamp(0, n - 1), rcv.clamp(0, n - 1), inside,
                      n, stats=("sum",), edge_term=ef,
                      activation="relu")["sum"]
    torch.cuda.synchronize()
    assert tfs.fused_nt_scatter.launches == before + 2 * len(outs)
    _close_to_scale(outs[0], plain)
    _close_to_scale(outs[0], two)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def _views_off(ts, by_bytes):
    """Each tensor as a contiguous view that starts ``by_bytes`` into a
    buffer of its own (0: the tensors as they are)."""
    out = []
    for t in ts:
        k = by_bytes // t.element_size()
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        buf[k:].copy_(t.reshape(-1))
        out.append(buf[k:].view(t.shape))
    return out


# the kernel's result against the plain version's: float32 sums in another
# order (1e-4 of the scale), then, for 16-bit results, the rounding into the
# dtype (half a unit in the last place: 2^-8 of the value in bf16, 2^-11 in
# f16)
CARD_RTOL = {"float32": 1e-4, "bfloat16": 1e-4 + 2.0 ** -8,
             "float16": 1e-4 + 2.0 ** -11}

# (dtype, n, d_in, d_ff, d_out, views off this many bytes): every dtype at
# GIN's MLP; d_in 9 and d_ff 25 (short quads; chunks off 4 floats, which
# take 4-byte cp.async in f32 and plain loads in 16 bits); weights off 16
# bytes (4-byte copies) and, in bf16, off 4 bytes (plain loads); n not a
# multiple of the rows per block
STAGING = [
    ("float32", 64, 100, 200, 100, 0),
    ("bfloat16", 64, 100, 200, 100, 0),
    ("float16", 1024, 100, 200, 100, 0),
    ("float32", 997, 9, 25, 9, 0),
    ("bfloat16", 997, 9, 25, 9, 0),
    ("float32", 1024, 100, 200, 100, 4),
    ("bfloat16", 61, 100, 200, 100, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,din,dff,dout,offset", STAGING)
def test_cuda_nt_mlp_staging_paths(dtype, n, din, dff, dout, offset):
    """The staged tile in each dtype and on each staging path: the result in
    x's dtype within CARD_RTOL of the plain version, bitwise across runs and
    at 1, 3, 8 and 16 rows per block."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    p = _problem(n, din, dff, dout, seed=n + din)
    args = _views_off(_torch(p, MLP, "cuda", dtype), offset)
    outs = [tnt.nt_mlp(*args, node_tile=1, k_tile=1, rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 8, 16)]
    plain = tnt.nt_mlp_ref(*args)
    torch.cuda.synchronize()
    assert outs[0].dtype == args[0].dtype
    scale = max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(outs[0].float(), plain, atol=1e-4 * scale,
                               rtol=CARD_RTOL[dtype])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_dtype,edge_dtype,n,e", [
    ("float32", "float32", 997, 3001), ("bfloat16", "bfloat16", 64, 1024),
    ("float16", "float16", 64, 1024), ("float32", "float16", 1024, 4096)])
def test_cuda_fused_nt_scatter_is_nt_mlp_then_mp_pipeline(mlp_dtype,
                                                         edge_dtype, n, e):
    """The two launches (the second overlapped with the first by
    programmatic dependent launch) bitwise equal to nt_mlp followed by
    mp_pipeline on the operands widened to float32 (the widening is exact
    and the tile widens at the load), at any rows per block."""
    _need_card()
    from repro_torch.kernels.mp_pipeline import mp_pipeline
    p = _problem(n, 100, 200, 100, e=e, seed=e + n)
    mlp = _torch(p, MLP, "cuda", mlp_dtype)
    snd, rcv, mask, ef = _torch(p, EDGES, "cuda", edge_dtype)
    before = tfs.fused_nt_scatter.launches
    outs = [tfs.fused_nt_scatter(*mlp, snd, rcv, mask, ef, node_tile=1,
                                 rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 16)]
    y = tnt.nt_mlp(*[t.float() for t in mlp], node_tile=1, k_tile=1)
    two = mp_pipeline(y, snd, rcv, mask, n, stats=("sum",),
                      edge_term=ef.float(), activation="relu")["sum"]
    plain = tfs.fused_nt_scatter_ref(*mlp, snd, rcv, ef, mask)
    torch.cuda.synchronize()
    assert tfs.fused_nt_scatter.launches == before + 2 * len(outs)
    assert outs[0].dtype == torch.float32
    assert torch.equal(outs[0], two)
    _close_to_scale(outs[0], plain)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
