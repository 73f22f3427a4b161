"""The training path's kernels on the card (``cuda`` marker; each test
decides inside itself whether there is a card and skips where there is
none). No JAX here: the card's machine has none, so every comparison is
against the port's plain PyTorch versions.

* ``FlashAttentionFn``: the forward kernel's lse and the backward kernel
  (``csrc/flash_attention_bwd.cu``) against ``flash_attention_bwd_ref``,
  launched and counted, never the plain path; bitwise across two runs, at
  every head width in both types also the lse and delta buffer its dQ
  launch writes for the dK / dV launch.
* ``MpScatterFn`` / ``GatherRowsFn``: each backward launches the other
  kernel, and the gradients equal autograd of the plain versions.
* A reduced MoE layer and a reduced LM train on the card: every parameter
  gets a gradient, against the same step through the plain kernels.
* A kernel with no backward raises on a CUDA input that requires grad.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gather_rows as tgr
from repro_torch.kernels import mp_scatter as tms

# float32: the kernel and the plain version sum in other orders, over up to
# a few hundred keys or rows: within 2e-5 of each gradient's scale
F32_TOL = 2e-5
# bfloat16: the plain version computes in float32; the kernel's tensor
# cores take P and dS rounded to bf16 (one term each, within 2^-8 of each
# value) and sum in float32 (tests/test_torch_flash_bwd_rounding.py models
# it on the CPU). Both round each gradient once, so they may differ by one
# bf16 unit (2^-8 to 2^-7 of the value) where the two float32 values
# straddle a rounding point, and P's and dS's rounding moves the float32
# values by less than a unit: held at 2^-7 of each gradient's scale
BF16_TOL = 2.0 ** -7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol):
    scale = max(1e-30, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


def _inputs(b, h, sq, sk, d, dtype, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * s).to("cuda", dtype)
    return (t(b, h, sq, d, s=q_scale), t(b, h, sk, d), t(b, h, sk, d),
            t(b, h, sq, d))


CASES = [
    # b, h, sq, sk, d, causal, window, softcap, q scale
    (2, 2, 128, 128, 64, True, None, None, 1.0),
    (1, 2, 200, 200, 128, True, 48, 50.0, 50.0),   # ragged, all options
    (1, 2, 96, 160, 256, False, None, None, 1.0),
    (2, 4, 40, 40, 16, True, 16, None, 1.0),       # the reduced configs' D
    (1, 2, 150, 333, 32, True, 90, 30.0, 30.0),    # Sq < Sk, ragged kv tile
    (1, 2, 256, 128, 64, True, None, None, 1.0),   # rows that see no key
    (1, 1, 300, 300, 256, True, 100, None, 1.0),   # D=256's 32-key tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d,causal,window,cap,qs", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_plain(b, h, sq, sk, d, causal, window,
                                            cap, qs, dtype):
    _card()
    dt = getattr(torch, dtype)
    q, k, v, dout = _inputs(b, h, sq, sk, d, dt, seed=sq + d, q_scale=qs)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = (tfa.flash_attention.launches,
              tfa.flash_attention_bwd.launches)
    out, lse = tfa._forward_with_lse(q, k, v, causal, window, cap)
    ref_out, ref_lse = tfa.flash_attention_ref(q, k, v, **kw, with_lse=True)
    grads = [tfa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
             for _ in range(2)]
    plain = tfa.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before[0] + 1
    assert tfa.flash_attention_bwd.launches == before[1] + 4
    seen = lse > -1e29
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-4,
                               rtol=1e-5)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for got, again, want in zip(grads[0], grads[1], plain):
        assert got.dtype == dt and torch.equal(got, again)
        _close(got, want, tol)
    if sq > sk and causal:
        assert not bool(grads[0][0][:, :, :sq - sk].any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", tfa.CUDA_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_bitwise_and_its_delta_at_every_width(d, dtype):
    """At every head width and type: two runs give the same bits (the
    gradients and the stats buffer between the launches), the buffer's
    delta is the plain rowsum(dout * out) within float32 summation order
    (1e-6 of its scale), its lse the forward's bits, and the padding rows
    past Sq zeros."""
    _card()
    dt = getattr(torch, dtype)
    sq, sk = 100, 130
    q, k, v, dout = _inputs(1, 3, sq, sk, d, dt, seed=d)
    kw = dict(causal=True, window=70, softcap=None)
    out, lse = tfa._forward_with_lse(q, k, v, True, 70, None)
    runs = [tfa._launch_bwd(q, k, v, out, lse, dout, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    stats = runs[0][3]
    assert stats.shape == (3, 2, 128)
    delta = (dout.float() * out.float()).sum(-1).reshape(3, sq)
    _close(stats[:, 1, :sq], delta, 1e-6)
    assert torch.equal(stats[:, 0, :sq], lse.reshape(3, sq))
    assert not bool(stats[:, :, sq:].any())
    _close(runs[0][0], tfa.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                   **kw)[0],
           F32_TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.cuda
def test_cuda_function_launches_the_backward_kernel():
    """Through ``flash_attention`` with inputs that require grad: one
    forward launch (with lse), two backward launches, gradients with a
    ``grad_fn`` chain back to the leaves; under no_grad the plain forward
    launch alone."""
    _card()
    q, k, v, dout = _inputs(1, 2, 128, 128, 64, torch.bfloat16, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.flash_attention.launches,
              tfa.flash_attention_bwd.launches)
    out = tfa.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    out.backward(dout)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 2)
    lse = tfa._forward_with_lse(q, k, v, True, None, None)[1]
    want = tfa.flash_attention_bwd_ref(q, k, v, out.detach(), lse, dout)
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w, BF16_TOL)
    with torch.no_grad():
        tfa.flash_attention(*leaves, causal=True)
    assert tfa.flash_attention_bwd.launches == before[1] + 2


@pytest.mark.cuda
def test_cuda_flash_kernels_launch_from_a_fresh_thread():
    """The bf16 forward (with lse) and backward kernels as the first CUDA
    work of a new thread, where no context is current until the kernels'
    own runtime makes one (an autograd worker's backward): both launch and
    give what they give on the main thread, bit for bit."""
    import threading
    _card()
    q, k, v, dout = _inputs(1, 2, 128, 128, 64, torch.bfloat16, seed=3)

    def run():
        out, lse = tfa._forward_with_lse(q, k, v, True, None, None)
        return (out, lse) + tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = run()
    got, errors = [], []

    def worker():
        try:
            got.append(run())
            torch.cuda.synchronize()
        except RuntimeError as exc:
            errors.append(exc)
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scatter_and_gather_backward_are_each_other(dtype):
    """``mp_scatter``'s backward launches ``gather_rows`` and the reverse;
    both equal autograd of the plain versions, with masked and
    out-of-range rows."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    e, n, d = 512, 96, 64
    idx = torch.from_numpy(rng.integers(-3, n + 3, e)).cuda()
    mask = torch.from_numpy(rng.random(e) < 0.8).cuda()
    msg = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(
        "cuda", dt).requires_grad_()
    y = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        "cuda", dt).requires_grad_()
    g_out = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        "cuda", dt)
    g_rows = torch.from_numpy(
        rng.normal(size=(e, d)).astype(np.float32)).cuda()
    before = (tms.mp_scatter.launches, tgr.gather_rows.launches)
    out = tms.mp_scatter(msg, idx, mask, n, edge_tile=1, num_banks=1)
    rows = tgr.gather_rows(y, idx, mask, idx_tile=1, num_banks=1)
    assert out.grad_fn is not None and rows.grad_fn is not None
    (out.float() * g_out.float()).sum().add((rows * g_rows).sum()).backward()
    torch.cuda.synchronize()
    assert (tms.mp_scatter.launches, tgr.gather_rows.launches) == (
        before[0] + 2, before[1] + 2)
    m2 = msg.detach().clone().requires_grad_()
    y2 = y.detach().clone().requires_grad_()
    ref = tms.mp_scatter_ref(m2, idx, mask, n).to(dt)
    ref_rows = tgr.gather_rows_ref(y2, idx, mask)
    (ref.float() * g_out.float()).sum().add(
        (ref_rows * g_rows).sum()).backward()
    tol = 0.0 if dt == torch.float32 else BF16_TOL
    _close(msg.grad, m2.grad, tol)
    _close(y.grad, y2.grad, max(tol, 1e-6))


@pytest.mark.cuda
def test_cuda_kernels_without_a_backward_raise():
    _card()
    msg = torch.ones(128, 8, device="cuda", requires_grad=True)
    r = torch.zeros(128, dtype=torch.int64, device="cuda")
    m = torch.ones(128, dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        tms.mp_scatter_multi(msg, r, m, 4, stats=("sum",))
    with torch.no_grad():
        tms.mp_scatter_multi(msg, r, m, 4, stats=("sum",))


def _with_plain_kernels(monkeypatch):
    """Route the LM path's three kernels to their plain versions."""
    from repro_torch.kernels import moe_dispatch, ops

    def attn(q, k, v, *, causal=True, window=None, softcap=None, q_tile=128,
             kv_tile=128):
        return tfa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)

    def scatter(msg, r, mask, n, **kw):
        return tms.mp_scatter_ref(msg, r, mask, n).to(msg.dtype)

    def gather(y, idx, mask, **kw):
        return tgr.gather_rows_ref(y, idx, mask)

    monkeypatch.setattr(ops, "flash_attention", attn)
    monkeypatch.setattr(moe_dispatch, "mp_scatter", scatter)
    monkeypatch.setattr(moe_dispatch, "gather_rows", gather)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_cuda_reduced_lm_gradients_through_the_kernels(arch, monkeypatch):
    """``lm_loss`` and every parameter's gradient of a reduced model on the
    card, through the kernels, against the same step through the plain
    versions (float32, TF32 off; within 1e-4 of each gradient's scale:
    float32 sums in other orders through two blocks)."""
    _card()
    from repro_torch.configs.archs import REDUCED
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves
    cfg = REDUCED[arch]
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                 .astype(np.int32)).cuda()
             for k in ("tokens", "labels")}
    launches = {k: f.launches for k, f in
                (("attn", tfa.flash_attention),
                 ("bwd", tfa.flash_attention_bwd),
                 ("scatter", tms.mp_scatter), ("gather", tgr.gather_rows))}
    loss, _ = lm.lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    moved = {k: f.launches - launches[k] for k, f in
             (("attn", tfa.flash_attention),
              ("bwd", tfa.flash_attention_bwd),
              ("scatter", tms.mp_scatter), ("gather", tgr.gather_rows))}
    layers = cfg.num_layers
    assert moved["attn"] == layers and moved["bwd"] == 2 * layers
    if cfg.num_experts:
        # forward: dispatch + combine scatters and one gather a layer; the
        # inner remat runs them again; the backward: a gather for each
        # scatter, a scatter for the gather
        assert moved["scatter"] == 2 * 2 * layers + layers
        assert moved["gather"] == 2 * layers + 2 * layers
    _with_plain_kernels(monkeypatch)
    loss_p, _ = lm.lm_loss(params, batch, cfg)
    grads_p = torch.autograd.grad(loss_p, leaves)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for g, gp in zip(grads, grads_p):
        _close(g, gp, 1e-4)
