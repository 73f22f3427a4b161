"""The bf16 flash backward kernel's arithmetic, modelled in plain PyTorch
on the CPU, against the port's plain backward.

``csrc/flash_attention_bwd.cu`` runs bf16 inputs on the tensor cores:
s = (q . k) * scale and dp = dout . v summed in float32 from the raw bf16
operands; delta = rowsum(dout * out) in float32; p and ds in float32 on the
accumulators; then P and dS enter the register-A products as one bf16
term each (round to nearest even), every product summed in float32, and
each gradient rounded once to bf16. ``kernel_model`` does the same in
PyTorch (in another summation order), with one term or the forward's two
(hi = bf16(x), lo = bf16(x - hi)), so that the choice of terms is tested
where the kernel cannot run. It is held within the card tests'
``BF16_TOL`` (2^-7 of each gradient's scale) of
``flash_attention_bwd_ref``, which ``tests/test_torch_flash_backward.py``
holds against the JAX package's ``_bwd``; and the faults the card's
checks plant (``chip_smoke.py::check_bwd_planted_faults``: one q block's
dQ skipping one kv tile, the softcap's derivative dropped) fail that
tolerance.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, visible)

# tests/test_torch_train_card.py's BF16_TOL: two bf16 units of each
# gradient's scale
BF16_TOL = 2.0 ** -7
# the terms P and dS enter the tensor cores as (the kernel's kTerms)
TERMS = 1

# (B, H, Sq, Sk, D, causal, window, softcap, q scale)
CASES = {
    "causal_d64": (2, 2, 128, 128, 64, True, None, None, 1.0),
    "softcap_q50": (1, 2, 200, 200, 128, True, 48, 50.0, 50.0),
    "window_d256": (1, 1, 256, 256, 256, True, 100, None, 1.0),
    "not_causal_d256": (1, 2, 96, 160, 256, False, None, None, 1.0),
    "window_d16": (2, 4, 40, 40, 16, True, 16, None, 1.0),
    "sq_lt_sk_softcap": (1, 2, 150, 256, 32, True, 90, 30.0, 30.0),
    "rows_see_no_key": (1, 2, 256, 128, 64, True, None, None, 1.0),
}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(x, n):
    """x as ``n`` bf16 terms (hi, then what hi misses)."""
    out = []
    for _ in range(n):
        out.append(_bf16(x - sum(out)) if out else _bf16(x))
    return out


def _p_ds(q, k, v, out, lse, dout, *, causal, window, softcap,
          drop_dcap=False):
    """p and ds in float32, (B, H, Sq, Sk), 0 off the mask: s and dp from
    the raw operands, then scale, softcap (ds times its derivative, unless
    ``drop_dcap``) and exp(s - lse), as the kernel's passes run."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window)
    s = (qf @ kf.mT) * scale
    dp = gf @ vf.mT - (gf * of).sum(-1, keepdim=True)
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        if not drop_dcap:
            dp = dp * (1.0 - t * t)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    return p, torch.where(mask, p * dp, 0.0)


def kernel_model(q, k, v, out, lse, dout, *, terms=TERMS, skip=None,
                 drop_dcap=False, **mask):
    """(dq, dk, dv) in bf16 by the tensor-core kernel's arithmetic: P and
    dS in ``terms`` bf16 terms, products summed in float32. A planted
    fault: ``skip`` = (q rows, keys) slices whose dS the dQ product drops,
    or ``drop_dcap`` the softcap's derivative."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, out, lse, dout, **mask, drop_dcap=drop_dcap)
    dsq = ds
    if skip is not None:
        dsq = ds.clone()
        dsq[..., skip[0], skip[1]] = 0.0
    qf, kf, gf = q.float(), k.float(), dout.float()
    dv = sum(t.mT @ gf for t in _terms(p, terms))
    dk = sum(t.mT @ qf for t in _terms(ds, terms)) * scale
    dq = sum(t @ kf for t in _terms(dsq, terms)) * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _case(name, seed=0):
    b, h, sq, sk, d, causal, window, cap, q_scale = CASES[name]
    rng = np.random.default_rng(seed + sq + d)

    def t(*shape, s=1.0):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32) * s).to(torch.bfloat16)
    q, k, v, dout = (t(b, h, sq, d, s=q_scale), t(b, h, sk, d),
                     t(b, h, sk, d), t(b, h, sq, d))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_attention_ref(q, k, v, **kw, with_lse=True)
    return (q, k, v, out, lse, dout), kw


def _worst(got, want):
    """The largest share of its own scale (max |want|) by which a gradient
    misses."""
    return max(float((a.float() - b.float()).abs().max())
               / max(1e-30, float(b.float().abs().max()))
               for a, b in zip(got, want))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_rounding_within_bf16_tol(name, seed):
    args, kw = _case(name, seed)
    want = flash_attention_bwd_ref(*args, **kw)
    got = kernel_model(*args, **kw)
    assert _worst(got, want) <= BF16_TOL
    if args[0].shape[2] > args[1].shape[2] and kw["causal"]:
        rows = args[0].shape[2] - args[1].shape[2]
        assert not bool(got[0][:, :, :rows].any())


def test_the_second_term_matters():
    """What a second term would buy: with one bf16 term for P and dS, as
    the kernel takes them, every case and seed here stays within the
    tolerance, one bf16 unit of the scale, but comes within a tenth of it
    on some (~2^-9 of each probability, summed over hundreds of keys); two
    terms, the forward's split, would keep every case below half of it at
    13-22% more time a call on the card."""
    worst = {1: 0.0, 2: 0.0}
    for name in CASES:
        for seed in (0, 1):
            args, kw = _case(name, seed)
            want = flash_attention_bwd_ref(*args, **kw)
            for terms in worst:
                worst[terms] = max(worst[terms], _worst(
                    kernel_model(*args, **kw, terms=terms), want))
    assert 0.9 * BF16_TOL < worst[1] <= BF16_TOL, worst
    assert worst[2] < BF16_TOL / 2, worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_skipped_kv_tile_fails_the_tolerance(name):
    """dQ of one q block (128 rows, 64 at D = 256) skipping one 64-key
    tile, the one whose keys move that block's dq most (a peaked softmax
    leaves most tiles' share below any tolerance), as the card's check
    plants it."""
    args, kw = _case(name)
    q, k = args[0], args[1]
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    bq, bk = (64 if d == 256 else 128), 64
    want = flash_attention_bwd_ref(*args, **kw)
    ds = _p_ds(*args, **kw)[1]
    nq, nk = -(-sq // bq), -(-sk // bk)
    dsp = torch.nn.functional.pad(ds, (0, nk * bk - sk, 0, nq * bq - sq))
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, nk * bk - sk))
    share = torch.einsum("xhaibj,xhbjd->xhaibd",
                         dsp.reshape(*ds.shape[:2], nq, bq, nk, bk),
                         kp.reshape(*k.shape[:2], nk, bk, d)).abs()
    a, t = divmod(int(share.amax(dim=(0, 1, 3, 5)).argmax()), nk)
    fault = kernel_model(*args, **kw,
                         skip=(slice(a * bq, (a + 1) * bq),
                               slice(t * bk, (t + 1) * bk)))
    assert _worst(fault, want) > BF16_TOL


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if CASES[n][7] is not None])
def test_a_dropped_softcap_derivative_fails_the_tolerance(name):
    args, kw = _case(name)
    want = flash_attention_bwd_ref(*args, **kw)
    fault = kernel_model(*args, **kw, drop_dcap=True)
    assert _worst(fault, want) > BF16_TOL

