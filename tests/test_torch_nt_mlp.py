"""The port's ``nt_mlp`` and ``fused_nt_scatter`` against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels run in interpret mode and the JAX
oracles, on the same numpy-seeded inputs, at the reference's own
tolerances (``tests/test_kernels.py``): ``nt_mlp`` 3e-5, ``fused_nt_scatter``
1e-4, at the reference's shapes and at GIN's 100 -> 200 -> 100. The CUDA
kernels are held against the plain versions in tests that need the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_nt_scatter as tfs  # noqa: E402
from repro_torch.kernels import nt_mlp as tnt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

NT_TOL = dict(atol=3e-5, rtol=3e-5)
FUSED_TOL = dict(atol=1e-4, rtol=1e-4)
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


def _torch(p, keys, device="cpu"):
    return [torch.from_numpy(p[k]).to(device) for k in keys]


def _jnp(p, keys):
    import jax.numpy as jnp
    return [jnp.asarray(p[k], jnp.int32) if p[k].dtype == np.int64
            else jnp.asarray(p[k]) for k in keys]


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
    """bf16 x: float32 inside, bf16 out, as the Pallas kernel (its bf16
    tolerance)."""
    import jax.numpy as jnp
    p = _problem(64, 32, 48, 24, seed=2)
    args = _torch(p, MLP)
    args[0] = args[0].to(torch.bfloat16)
    jargs = _jnp(p, MLP)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    ours = tops.nt_mlp(*args, node_tile=32, k_tile=32)
    kern = jops.nt_mlp(*jargs, node_tile=32, k_tile=32)
    assert ours.dtype == torch.bfloat16 and kern.dtype == jnp.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)


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
