"""The float32 flash kernels' arithmetic, modelled in plain PyTorch on the
CPU, against the port's plain versions and a float64 reference.

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` run float32
inputs on the bf16 tensor cores (``csrc/split3.cuh``): each operand of each
product is split into three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), each rounded to nearest even, and a product is the
sum of six cross products (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi),
each exact in float32 and summed in float32. q is scaled by 1/sqrt(D) in
float32 before its split, as the plain versions scale it; softmax, softcap,
masks, delta and the folds stay float32. ``split_mm`` and the two models
below do the same (in another summation order), so that the split is
tested where the kernels cannot run: the three terms give x back bit for
bit; the models stay within the card checks' float32 tolerances of
``flash_attention_ref`` and ``flash_attention_bwd_ref`` (which
``tests/test_torch_flash_attention.py`` and
``tests/test_torch_flash_backward.py`` hold against the JAX package); their
errors against the float64 plain versions stay within 4x the float32 plain
versions' own; and two terms (three products) do not, so the third term
matters.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, visible)

# chip_smoke.py's FLASH_TOL["float32"] (|k - p| <= 2e-5 + 2e-5 |p|) and
# FLASH_BWD_TOL["float32"] (2e-5 of each gradient's max |p|)
FWD_RTOL = FWD_ATOL = 2e-5
BWD_TOL = 2e-5
# the split's error against float64, at most this many times the float32
# plain version's
RATIO = 4.0
# the six cross products (a term, b term) in the kernels' order, small
# first; two terms keep the last three
PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))

# (B, H, Sq, Sk, D, causal, window, softcap, q scale)
CASES = {
    "causal_d16": (1, 2, 96, 96, 16, True, None, None, 1.0),
    "window_d16": (2, 2, 100, 100, 16, True, 24, None, 1.0),
    "window_softcap_d64": (1, 2, 128, 128, 64, True, 40, 30.0, 30.0),
    "sq_gt_sk_d64": (1, 2, 160, 96, 64, True, None, None, 1.0),
    "sq_lt_sk_window_d256": (1, 1, 64, 160, 256, True, 100, None, 1.0),
    "not_causal_softcap_d256": (1, 1, 80, 80, 256, False, None, 50.0, 50.0),
}


def split3(x, terms=3):
    """x (float32) as ``terms`` bf16 terms, each what the ones before it
    miss, rounded to nearest even (float32 tensors holding bf16 values)."""
    out, rest = [], x
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def split_mm(a, b, terms=3):
    """a @ b by the kernels' split: the cross products of the operands'
    ``terms`` terms (six of three, three of two), each summed in float32,
    added small first."""
    ta, tb = split3(a, terms), split3(b, terms)
    out = None
    for i, j in PAIRS[0 if terms == 3 else 3:]:
        prod = ta[i] @ tb[j]
        out = prod if out is None else out + prod
    return out


def fwd_model(q, k, v, *, causal, window, softcap, terms=3):
    """The float32 forward by the kernel's arithmetic: S and P.V by
    ``split_mm``, q scaled first, softmax and softcap in float32, 0 for a
    row that sees no key."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window)
    s = split_mm(q * scale, k.mT, terms)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return split_mm(p, v, terms) / l


def bwd_model(q, k, v, out, lse, dout, *, causal, window, softcap,
              terms=3):
    """(dq, dk, dv) by the float32 backward kernels' arithmetic: its five
    products (S, dP, dV, dK, dQ) by ``split_mm``, q scaled first, delta,
    p and ds in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = visible(q.shape[2], k.shape[2], causal=causal, window=window)
    qs = q * scale
    delta = (dout * out).sum(-1, keepdim=True)
    s = split_mm(qs, k.mT, terms)
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        dcap, s = 1.0 - t * t, softcap * t
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (split_mm(dout, v.mT, terms) - delta)
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(mask, ds, 0.0)
    return (split_mm(ds, k, terms) * scale, split_mm(ds.mT, qs, terms),
            split_mm(p.mT, dout, terms))


def _case(name, seed=0):
    """The case's float32 inputs from numpy (seeded), the plain forward's
    out and lse, dout, and the same in float64 with its own out and lse."""
    b, h, sq, sk, d, causal, window, cap, q_scale = CASES[name]
    rng = np.random.default_rng(seed + 7 * sq + d)

    def t(*shape, s=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * s).astype(np.float32))
    q, k, v, dout = (t(b, h, sq, d, s=q_scale), t(b, h, sk, d),
                     t(b, h, sk, d), t(b, h, sq, d))
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = flash_attention_ref(q, k, v, **kw, with_lse=True)
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, dout))
    out64, lse64 = flash_attention_ref(q64, k64, v64, **kw, with_lse=True)
    return ((q, k, v, out, lse, dout), (q64, k64, v64, out64, lse64, g64),
            kw)


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def _worst_share(got, want):
    """The largest share of its own scale (max |want|) by which a gradient
    misses."""
    return max(_max_err(a, b) / max(1e-30, float(b.abs().max()))
               for a, b in zip(got, want))


def test_three_terms_give_x_back_bitwise():
    """hi + mid + lo == x for numpy-seeded float32 values of both signs
    across 2^-100 .. 2^100, and 0; each term a bf16 value."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, size=20000)
    exps = rng.integers(-100, 101, size=20000)
    sign = rng.choice([-1.0, 1.0], size=20000)
    x = torch.from_numpy(np.concatenate(
        [(sign * mant * np.exp2(exps)).astype(np.float32),
         np.array([0.0, 1.0, -1.0, 2.0 ** -100, 3.0e37], np.float32)]))
    hi, mid, lo = split3(x)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert torch.equal((hi + mid) + lo, x)
    nz = x != 0
    assert bool((mid.abs() <= 2.0 ** -8 * x.abs()).all())
    assert bool((lo[nz].abs() <= 2.0 ** -16 * x[nz].abs()).all())
    # two terms miss what lo holds
    assert not torch.equal(hi + mid, x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_model_within_f32_tol_of_plain(name):
    (q, k, v, *_), _, kw = _case(name)
    want = flash_attention_ref(q, k, v, **kw)
    got = fwd_model(q, k, v, **kw)
    assert bool((got - want).abs().le(FWD_ATOL + FWD_RTOL * want.abs())
                .all())
    sq, sk = q.shape[2], k.shape[2]
    if sq > sk and kw["causal"]:
        assert not bool(got[:, :, :sq - sk].any())


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_model_within_f32_tol_of_plain(name):
    args, _, kw = _case(name)
    want = flash_attention_bwd_ref(*args, **kw)
    assert _worst_share(bwd_model(*args, **kw), want) <= BWD_TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_terms_within_4x_of_plain_f32_against_f64(name):
    """Forward and backward: the model's error against the float64 plain
    version is at most RATIO times the float32 plain version's."""
    args, args64, kw = _case(name)
    want64 = flash_attention_ref(*args64[:3], **kw)
    plain = _max_err(flash_attention_ref(*args[:3], **kw), want64)
    assert _max_err(fwd_model(*args[:3], **kw), want64) <= RATIO * plain
    grads64 = flash_attention_bwd_ref(*args64, **kw)
    plain = _worst_share(flash_attention_bwd_ref(*args, **kw), grads64)
    assert _worst_share(bwd_model(*args, **kw), grads64) <= RATIO * plain


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_terms_exceed_4x_of_plain_f32_against_f64(name):
    """Two terms (hi.hi, hi.mid, mid.hi) miss the float64 version by more
    than RATIO times the float32 plain version, in the forward and in the
    backward: the third term is what brings the split to float32."""
    args, args64, kw = _case(name)
    want64 = flash_attention_ref(*args64[:3], **kw)
    plain = _max_err(flash_attention_ref(*args[:3], **kw), want64)
    assert _max_err(fwd_model(*args[:3], **kw, terms=2),
                    want64) > RATIO * plain
    grads64 = flash_attention_bwd_ref(*args64, **kw)
    plain = _worst_share(flash_attention_bwd_ref(*args, **kw), grads64)
    assert _worst_share(bwd_model(*args, **kw, terms=2),
                        grads64) > RATIO * plain
