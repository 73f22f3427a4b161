"""The port's ``gather_rows``, bf16 ``mp_scatter`` and MoE data path
(``moe_dispatch`` / ``moe_combine``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels run in interpret mode, and the JAX
oracles, on the same numpy-seeded inputs, at the reference's own
tolerances: ``gather_rows`` 1e-5 (``tests/test_moe_kernels.py``), bf16
``mp_scatter`` 5e-2 (``tests/test_multi_aggregate.py``), the MoE path 1e-4
against the JAX pair and the dense per-token sum. The routing keeps
``nn/moe.py``'s convention: an assignment that is not owned points its slot
one past the buffer. The CUDA kernels are held against the plain versions
in tests that need the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gather_rows as tgr  # noqa: E402
from repro_torch.kernels import moe_dispatch as tmoe  # noqa: E402
from repro_torch.kernels import mp_scatter as tms  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MOE_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module")
def jgr():
    """The JAX package's gather_rows module (absent where JAX is not
    installed, as on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.gather_rows")


@pytest.fixture(scope="module")
def jmoe():
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.moe_dispatch")


@pytest.fixture(scope="module")
def jops():
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _gather_problem(n, d, s, seed=0, lo=0, hi=None):
    r = np.random.default_rng(seed)
    return {"y": r.normal(size=(n, d)).astype(np.float32),
            "idx": r.integers(lo, n if hi is None else hi,
                              size=s).astype(np.int64),
            "mask": r.random(s) < 0.8}


def _torch(p, keys, device="cpu"):
    return [torch.from_numpy(p[k]).to(device) for k in keys]


def _jnp(p, keys):
    import jax.numpy as jnp
    return [jnp.asarray(p[k], jnp.int32) if p[k].dtype == np.int64
            else jnp.asarray(p[k]) for k in keys]


GATHER = ("y", "idx", "mask")


@pytest.mark.parametrize("n,d,s,tile,banks", [
    (64, 32, 128, 32, 2),
    (128, 16, 256, 64, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_reference(jgr, n, d, s, tile, banks, dtype):
    import jax.numpy as jnp
    p = _gather_problem(n, d, s, seed=n + s)
    y, idx, mask = _torch(p, GATHER)
    jy, jidx, jmask = _jnp(p, GATHER)
    if dtype == "bfloat16":
        y, jy = y.to(torch.bfloat16), jy.astype(jnp.bfloat16)
    ours = tgr.gather_rows(y, idx, mask, idx_tile=tile, num_banks=banks)
    kern = jgr.gather_rows(jy, jidx, jmask, idx_tile=tile, num_banks=banks)
    ref = jgr.gather_rows_ref(jy, jidx, jmask)
    assert ours.shape == (s, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert (ours.numpy()[~p["mask"]] == 0.0).all()


def test_gather_rows_out_of_range_rows_are_zero(jgr):
    """An unmasked index outside [0, N) gives a zero row, as the Pallas
    kernel (no bank owns it); its oracle clips instead, so the port is held
    against the kernel alone here."""
    n, d, s = 64, 16, 128
    p = _gather_problem(n, d, s, seed=3, lo=-6, hi=n + 10)
    outside = (p["idx"] < 0) | (p["idx"] >= n)
    assert (outside & p["mask"]).sum() > 5
    ours = tgr.gather_rows(*_torch(p, GATHER), idx_tile=32, num_banks=4)
    kern = jgr.gather_rows(*_jnp(p, GATHER), idx_tile=32, num_banks=4)
    ref = jgr.gather_rows_ref(*_jnp(p, GATHER))
    np.testing.assert_allclose(ours.numpy(), np.asarray(kern), **TOL)
    assert (ours.numpy()[outside] == 0.0).all()
    assert np.abs(np.asarray(ref)[outside & p["mask"]]).max() > 0


@pytest.mark.parametrize("s,n,tile,banks", [(100, 64, 32, 2),
                                            (128, 30, 32, 4)],
                         ids=["s_not_tiled", "n_not_banked"])
def test_gather_rows_padding_rules(jgr, s, n, tile, banks):
    p = _gather_problem(n, 8, s, seed=1)
    with pytest.raises(ValueError):
        tgr.gather_rows(*_torch(p, GATHER), idx_tile=tile, num_banks=banks)
    with pytest.raises(ValueError):
        jgr.gather_rows(*_jnp(p, GATHER), idx_tile=tile, num_banks=banks)


def test_gather_rows_cpu_path_takes_the_plain_version():
    p = _gather_problem(64, 8, 64, seed=4)
    before = tgr.gather_rows.launches
    ours = tgr.gather_rows(*_torch(p, GATHER), idx_tile=32, num_banks=2)
    assert torch.equal(ours, tgr.gather_rows_ref(*_torch(p, GATHER)))
    assert tgr.gather_rows.launches == before


def _dispatch_stream(t, d, slots, seed, trash=True):
    """Messages of T tokens sent to unique slots, some assignments not
    owned; those point one past the buffer (``trash``) or at slot 0."""
    r = np.random.default_rng(seed)
    s = slots
    own = r.random(s) < 0.8
    slot = r.permutation(slots).astype(np.int64)
    slot[~own] = slots if trash else 0
    return {"x": r.normal(size=(t, d)).astype(np.float32),
            "token_ids": r.integers(0, t, size=s).astype(np.int64),
            "slot": slot, "own": own}


@pytest.mark.parametrize("multi", [False, True], ids=["sum", "multi"])
def test_mp_scatter_bf16_dispatch_stream(jops, multi):
    """bf16 messages into unique slots, the dropped ones one past the
    buffer: f32 accumulation, bf16 out (f32 accumulators from the multi
    sweep), at the reference's bf16 tolerance."""
    import jax.numpy as jnp
    slots = 128
    p = _dispatch_stream(32, 16, slots, seed=6)
    msg = p["x"][p["token_ids"]]
    tm = torch.from_numpy(msg).to(torch.bfloat16)
    rcv, own = torch.from_numpy(p["slot"]), torch.from_numpy(p["own"])
    jm = jnp.asarray(msg).astype(jnp.bfloat16)
    jr, jk = jnp.asarray(p["slot"], jnp.int32), jnp.asarray(p["own"])
    if multi:
        ours = tms.mp_scatter_multi(tm, rcv, own, slots, stats=("sum",
                                                                "max"))
        kern = jops.mp_scatter_multi(jm, jr, jk, slots, want_sum=True,
                                     want_max=True, edge_tile=32,
                                     num_banks=4)
        for name in ("sum", "max"):
            assert ours[name].dtype == torch.float32
            np.testing.assert_allclose(ours[name].numpy(),
                                       np.asarray(kern[name]), **BF16_TOL)
        return
    ours = tms.mp_scatter(tm, rcv, own, slots)
    kern = jops.mp_scatter(jm, jr, jk, slots, edge_tile=32, num_banks=4)
    assert ours.dtype == torch.bfloat16 and kern.dtype == jnp.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               **BF16_TOL)
    # one message a slot: the bf16 value itself, exactly
    want = np.zeros((slots, 16), np.float32)
    want[p["slot"][p["own"]]] = tm.float().numpy()[p["own"]]
    np.testing.assert_array_equal(ours.float().numpy(), want)


def _routing(t, e_loc, cap, k, seed):
    """Synthetic top-k routing of T tokens to E_loc experts with capacity
    ``cap``, binned as ``nn/moe.py`` bins it; not-owned assignments point
    at the trash slot E_loc * cap."""
    r = np.random.default_rng(seed)
    top_i = np.stack([r.permutation(e_loc)[:k] for _ in range(t)])
    top_w = r.random((t, k)).astype(np.float32)
    flat_e = top_i.reshape(-1)
    flat_t = np.repeat(np.arange(t, dtype=np.int64), k)
    order = np.argsort(flat_e, kind="stable")
    se, st, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    starts = np.searchsorted(se, np.arange(e_loc), side="left")
    rank = np.arange(t * k) - starts[se]
    own = rank < cap
    slot = np.where(own, se * cap + rank, e_loc * cap).astype(np.int64)
    return se, st, slot, own, sw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_path_matches_jax_and_dense(jmoe, dtype):
    """dispatch -> expert FFN -> combine, the port against the JAX pair and
    the dense per-token sum, with some assignments past capacity."""
    import jax.numpy as jnp
    r = np.random.default_rng(1)
    t, d, e_loc, cap, k = 64, 16, 4, 24, 2
    se, st, slot, own, sw = _routing(t, e_loc, cap, k, seed=1)
    assert 0 < (~own).sum() < own.sum()          # some are dropped
    x = r.normal(size=(t, d)).astype(np.float32)
    w_expert = (r.normal(size=(e_loc, d, d)) * 0.3).astype(np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    rt = [torch.from_numpy(a) for a in (st, slot, own)]
    rj = [jnp.asarray(st, jnp.int32), jnp.asarray(slot, jnp.int32),
          jnp.asarray(own)]
    kw = dict(edge_tile=32, num_banks=2)

    buf = tmoe.moe_dispatch(tx, *rt, e_loc * cap, **kw)
    jbuf = jmoe.moe_dispatch(jx, *rj, e_loc * cap, **kw)
    assert buf.dtype == tx.dtype and buf.shape == (e_loc * cap, d)
    # one token a slot: the buffer is the tokens themselves, on both sides
    np.testing.assert_array_equal(buf.float().numpy(),
                                  np.asarray(jbuf.astype(jnp.float32)))

    # the expert FFN outside the kernels, once, fed to both combines
    bufn = buf.float().numpy().reshape(e_loc, cap, d)
    y = np.maximum(np.einsum("ecd,edf->ecf", bufn, w_expert), 0.0)
    y = y.reshape(e_loc * cap, d).astype(np.float32)
    ty, jy = torch.from_numpy(y), jnp.asarray(y)
    if dtype == "bfloat16":
        ty, jy = ty.to(torch.bfloat16), jy.astype(jnp.bfloat16)
    out = tmoe.moe_combine(ty, *rt, torch.from_numpy(sw), t, **kw)
    jout = jmoe.moe_combine(jy, *rj, jnp.asarray(sw), t, **kw)
    assert out.dtype == torch.float32 and out.shape == (t, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)

    # dense per token, in float64, from the same (rounded) operands
    xs = tx.double().numpy()
    ys = ty.double().numpy()
    ref = np.zeros((t, d))
    for a in range(t * k):
        if own[a]:
            ref[st[a]] += sw[a] * ys[slot[a]]
    np.testing.assert_allclose(out.numpy(), ref, **MOE_TOL)
    direct = np.zeros((t, d))
    for a in range(t * k):
        if own[a]:
            direct[st[a]] += sw[a] * np.maximum(
                xs[st[a]] @ w_expert[se[a]], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), direct, **MOE_TOL)


def test_moe_dispatch_is_permutation_invariant():
    """Routing entries in any order give the same buffer, bitwise."""
    p = _dispatch_stream(32, 8, 64, seed=2)
    perm = np.random.default_rng(3).permutation(64)
    args = ("token_ids", "slot", "own")
    a = tmoe.moe_dispatch(torch.from_numpy(p["x"]),
                          *[torch.from_numpy(p[k]) for k in args], 64)
    b = tmoe.moe_dispatch(torch.from_numpy(p["x"]),
                          *[torch.from_numpy(p[k][perm]) for k in args], 64)
    assert torch.equal(a, b)


def test_moe_combine_keeps_the_padding_rule(jmoe):
    """S % edge_tile != 0 raises on both sides (gather_rows' rule)."""
    import jax.numpy as jnp
    p = _dispatch_stream(16, 8, 48, seed=4)
    y = np.ones((48, 8), np.float32)
    w = np.ones(48, np.float32)
    with pytest.raises(ValueError):
        tmoe.moe_combine(torch.from_numpy(y),
                         *[torch.from_numpy(p[k]) for k in
                           ("token_ids", "slot", "own")],
                         torch.from_numpy(w), 16, edge_tile=32, num_banks=2)
    with pytest.raises(ValueError):
        jmoe.moe_combine(jnp.asarray(y), jnp.asarray(p["token_ids"]),
                         jnp.asarray(p["slot"]), jnp.asarray(p["own"]),
                         jnp.asarray(w), 16, edge_tile=32, num_banks=2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,s", [(10240, 2048, 8192), (1000, 100, 3000),
                                   (64, 9, 128)])
def test_cuda_gather_rows_matches_plain_version(dtype, n, d, s):
    """The CUDA kernel against its plain version: exact (a copy and a
    widening), masked and out-of-range rows zero; the widths that split
    into 16-byte pieces and the ones that do not."""
    _need_card()
    p = _gather_problem(n, d, s, seed=d, lo=-3, hi=n + 40)
    y, idx, mask = _torch(p, GATHER, "cuda")
    y = y.to(dtype)
    before = tgr.gather_rows.launches
    out = tgr.gather_rows(y, idx, mask, idx_tile=1, num_banks=1)
    again = tgr.gather_rows(y, idx, mask, idx_tile=1, num_banks=1)
    plain = tgr.gather_rows_ref(y, idx, mask)
    torch.cuda.synchronize()
    assert tgr.gather_rows.launches == before + 2
    assert out.dtype == torch.float32
    assert torch.equal(out, plain) and torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(e=8192, d=2048, n=10240, unique=True),
    dict(e=4096, d=100, n=1024, unique=False),
    dict(e=3001, d=9, n=997, unique=False),
])
def test_cuda_mp_scatter_bf16_matches_plain_version(case):
    """bf16 messages on the card: f32 accumulation, bf16 written by the
    kernel (round to nearest even). With one message a slot (the MoE
    dispatch) it equals the plain version bitwise; otherwise the f32 sums
    come in another order, so the two may round to neighbouring bf16
    values: within 2^-7 of the output's scale. Bitwise across runs and
    rows per block; out-of-range receivers add nothing."""
    _need_card()
    e, d, n = case["e"], case["d"], case["n"]
    r = np.random.default_rng(e)
    if case["unique"]:
        rcv = r.permutation(n)[:e].astype(np.int64)
    else:
        rcv = r.integers(-2, n + 5, size=e).astype(np.int64)
    msg = torch.from_numpy(r.normal(size=(e, d)).astype(np.float32)).cuda()
    msg = msg.to(torch.bfloat16)
    rcv = torch.from_numpy(rcv).cuda()
    mask = torch.from_numpy(r.random(e) < 0.8).cuda()
    outs = [tms.mp_scatter(msg, rcv, mask, n, rows_per_block=rpb)
            for rpb in (None, None, 1, 7)]
    plain = tms.mp_scatter_ref(msg, rcv, mask, n).to(torch.bfloat16)
    multi = tms.mp_scatter_multi(msg, rcv, mask, n, stats=("sum", "max"))
    multi_plain = tms.mp_scatter_multi_ref(msg, rcv, mask, n, ("sum", "max"))
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.bfloat16
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    if case["unique"]:
        assert torch.equal(outs[0], plain)
    else:
        scale = max(1.0, float(plain.float().abs().max()))
        torch.testing.assert_close(outs[0].float(), plain.float(),
                                   atol=2 ** -7 * scale, rtol=2 ** -7)
    assert multi["sum"].dtype == torch.float32
    assert torch.equal(multi["max"], multi_plain["max"])
    scale = max(1.0, float(multi_plain["sum"].abs().max()))
    torch.testing.assert_close(multi["sum"], multi_plain["sum"],
                               atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hub_row", "unaligned_view"])
def test_cuda_mp_scatter_bf16_is_the_stream_order_fold(case):
    """bf16 messages at the MoE width (D = 2048): the kernel's bf16 sums
    are bitwise the float32 stream-order fold of the widened messages on
    the host (``np.add.at``), rounded to nearest even. On a hub row (5,000
    of 8,192 unmasked edges), and on a message view 2 bytes off 16 (element
    loads); bitwise across rows per block."""
    _need_card()
    e, d, n = 8192, 2048, 1024
    r = np.random.default_rng(1 if case == "hub_row" else 2)
    rcv = r.integers(0, n, size=e).astype(np.int64)
    mask = np.ones(e, bool) if case == "hub_row" else r.random(e) < 0.8
    if case == "hub_row":
        rcv[r.choice(e, size=5000, replace=False)] = n // 3
    msg32 = torch.from_numpy(r.normal(size=(e, d)).astype(np.float32))
    msg = msg32.to(torch.bfloat16)
    keep = mask & (rcv >= 0) & (rcv < n)
    fold = np.zeros((n, d), np.float32)
    np.add.at(fold, rcv[keep], msg.float().numpy()[keep])
    want = torch.from_numpy(fold).to(torch.bfloat16)
    if case == "unaligned_view":
        buf = torch.empty(e * d + 1, dtype=torch.bfloat16, device="cuda")
        dev_msg = buf[1:].view(e, d)
        dev_msg.copy_(msg)
        assert dev_msg.data_ptr() % 16 == 2
    else:
        dev_msg = msg.cuda()
    rcv_d, mask_d = torch.from_numpy(rcv).cuda(), torch.from_numpy(mask).cuda()
    for rpb in (None, 1, 16):
        out = tms.mp_scatter(dev_msg, rcv_d, mask_d, n, rows_per_block=rpb)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
def test_cuda_moe_path_matches_plain_version():
    """dispatch and combine on the card against the same path on the CPU:
    the buffer bitwise, the combined tokens within 1e-4 of the scale."""
    _need_card()
    t, d, e_loc, cap, k = 256, 256, 16, 40, 4
    se, st, slot, own, sw = _routing(t, e_loc, cap, k, seed=5)
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(size=(t, d)).astype(np.float32))
    x = x.to(torch.bfloat16)
    rt = [torch.from_numpy(a) for a in (st, slot, own)]
    before = (tms.mp_scatter.launches, tgr.gather_rows.launches)
    buf = tmoe.moe_dispatch(x.cuda(), *[a.cuda() for a in rt], e_loc * cap)
    y = torch.relu(buf.float()).to(torch.bfloat16)
    out = tmoe.moe_combine(y, *[a.cuda() for a in rt],
                           torch.from_numpy(sw).cuda(), t)
    torch.cuda.synchronize()
    assert (tms.mp_scatter.launches - before[0],
            tgr.gather_rows.launches - before[1]) == (2, 1)
    assert torch.equal(buf.cpu(), tmoe.moe_dispatch(x, *rt, e_loc * cap))
    plain = tmoe.moe_combine(y.cpu(), *rt, torch.from_numpy(sw), t)
    scale = max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(out.cpu(), plain, atol=1e-4 * scale,
                               rtol=1e-4)
