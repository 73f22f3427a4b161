"""Flash attention (causal, local window, logit softcap), with its plain
PyTorch version.

The twin of ``repro/kernels/flash_attention.py``. q is (B, H, Sq, D), k and
v are (B, H, Sk, D) with the same H (callers repeat KV heads for GQA); the
output is (B, H, Sq, D) in ``q.dtype``. Per query row i and key j:

  * scores ``(q * 1/sqrt(D)) @ k^T`` in float32, q scaled before the
    product; with ``softcap`` they become ``softcap * tanh(s / softcap)``;
  * positions are end-aligned, ``q_pos = i + (Sk - Sq)``: ``causal`` keeps
    ``j <= q_pos``, ``window`` keeps ``j > q_pos - window``;
  * the softmax's running max, denominator and accumulator are float32 and
    the denominator is clamped at 1e-30, so a row that sees no key comes
    out 0 (the reference's oracle ``mha_ref`` gives NaN there; the port
    follows the kernel).

``flash_attention`` takes its plain version ``flash_attention_ref`` for
tensors on the CPU. For CUDA tensors it launches the hand-written kernel
``csrc/flash_attention.cu`` (float32 or bfloat16, D of 16, 32, ... 256)
or raises; ``flash_attention.launches`` counts those launches. For
``meta`` tensors (the dry run, ``repro_torch/counter.py``) it makes the
kernel's outputs, checks the kernel's limits and launches nothing. Under
an active counter each call, on the card or on meta, declares its
launches and its work (``kernels/cost.py``). ``q_tile``
and ``kv_tile`` are the reference's contract on the lengths (Sq % q_tile ==
Sk % kv_tile == 0, else ``ValueError``) and its TPU grid; the CUDA kernel
tiles by its own constants and masks ragged ends, so they change nothing
else.

The backward. When grad mode is on and q, k or v requires grad,
``flash_attention`` goes through ``FlashAttentionFn``, the twin of
``repro/nn/flash.py``'s custom VJP of ``flash_mha``: its forward also
writes the rows' log-sum-exp (float32, (B, H, Sq)) and saves (q, k, v,
out, lse), as ``_fwd`` saves them; its backward is ``flash_attention_bwd``
(``_bwd``'s function): the plain ``flash_attention_bwd_ref`` for CPU
tensors, the hand-written ``csrc/flash_attention_bwd.cu`` for CUDA ones
(two launches a call, each counted in ``flash_attention_bwd.launches``:
dQ, which also computes delta = rowsum(dout * out), then dK / dV; bf16 on
the tensor cores by ``wgmma`` on TMA-staged tiles, P and dS entering them
as one bf16 term each; float32 on FMAs).
Serving runs under ``torch.no_grad()`` or on tensors that need no grad,
and takes the forward launch alone, which writes no lse.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.mp_pipeline import launch_ptr
from repro_torch import counter

# the head widths the CUDA kernel is instantiated for
CUDA_HEAD_DIMS = (16, 32, 64, 128, 256)
CUDA_DTYPES = (torch.float32, torch.bfloat16)
# score elements one step of the plain version holds (256 MB of float32)
_REF_CHUNK = 1 << 26


def visible(sq: int, sk: int, *, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query row sees (end-aligned)."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _acc_dtype(dtype) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for float64
    inputs (``torch.autograd.gradcheck``'s)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        with_lse: bool = False):
    """Dense attention under the kernel's rules (scale q first, float32
    softmax, 0 for a row that sees no key), in ``q.dtype``. Runs a few
    (batch, head) pairs at a time to bound the score matrix's memory.
    With ``with_lse`` returns (out, lse): each row's log-sum-exp
    ``m + log(max(l, 1e-30))`` as ``_fwd`` saves it, (B, H, Sq) in the
    working type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    f32 = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    mask = visible(sq, sk, causal=causal, window=window, device=q.device)
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    out = torch.empty((b * h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=f32, device=q.device)
    step = max(1, _REF_CHUNK // max(1, sq * sk))
    for i in range(0, b * h, step):
        s = (qf[i:i + step].to(f32) * scale) @ kf[i:i + step].to(f32).mT
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask, s, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[i:i + step] = ((p @ vf[i:i + step].to(f32)) / l).to(q.dtype)
        lse[i:i + step] = (m + torch.log(l))[..., 0]
    out = out.reshape(b, h, sq, d)
    return (out, lse.reshape(b, h, sq)) if with_lse else out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The plain backward, ``repro/nn/flash.py::_bwd``'s function, dense in
    float32 and a few (batch, head) pairs at a time: from q (B, H, Sq, D),
    k, v (B, H, Sk, D), the forward's out and lse, and dout, returns (dq,
    dk, dv) in the inputs' dtypes. p = exp(s - lse) on visible keys,
    delta = rowsum(dout * out), ds = p (dp - delta), times 1 - tanh^2
    under a softcap; q is scaled by 1/sqrt(D) before the products, as the
    forward scales it."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    f32 = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    mask = visible(sq, sk, causal=causal, window=window, device=q.device)
    qf, kf, vf, of, gf = (t.reshape(b * h, -1, d)
                          for t in (q, k, v, out, dout))
    lf = lse.reshape(b * h, sq).to(f32)
    dq = torch.empty((b * h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b * h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b * h, sk, d), dtype=v.dtype, device=q.device)
    step = max(1, _REF_CHUNK // max(1, sq * sk))
    for i in range(0, b * h, step):
        sl = slice(i, i + step)
        qs = qf[sl].to(f32) * scale
        kk, vv, go = kf[sl].to(f32), vf[sl].to(f32), gf[sl].to(f32)
        delta = (go * of[sl].to(f32)).sum(-1, keepdim=True)
        s = qs @ kk.mT
        dcap = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            dcap = 1.0 - t * t
            s = softcap * t
        p = torch.where(mask, torch.exp(s - lf[sl, :, None]), 0.0)
        ds = p * (go @ vv.mT - delta)
        if dcap is not None:
            ds = ds * dcap
        dv[sl] = (p.mT @ go).to(v.dtype)
        dk[sl] = (ds.mT @ qs).to(k.dtype)
        dq[sl] = ((ds @ kk) * scale).to(q.dtype)
    return (dq.reshape(b, h, sq, d), dk.reshape(b, h, sk, d),
            dv.reshape(b, h, sk, d))


def _check(q, k, v, q_tile, kv_tile):
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(
            f"expected q (B, H, Sq, D) and k, v (B, H, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} must share B, H "
            f"and D (repeat KV heads for GQA first)")
    if q.shape[2] % q_tile or k.shape[2] % kv_tile:
        raise ValueError("pad sequence lengths to tile sizes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_tile: int = 128,
                    kv_tile: int = 128) -> torch.Tensor:
    """Attention of q (B, H, Sq, D) over k, v (B, H, Sk, D), in
    ``q.dtype``. Sq % q_tile == Sk % kv_tile == 0 (``ValueError``
    otherwise). CPU tensors run ``flash_attention_ref``; CUDA tensors
    launch the kernel; meta tensors get its outputs. Where autograd needs
    the graph (grad mode on and q, k or v requiring grad) the call goes
    through ``FlashAttentionFn``."""
    _check(q, k, v, q_tile, kv_tile)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap)


flash_attention.launches = 0


def _forward_with_lse(q, k, v, causal, window, softcap):
    """(out, lse float32 (B, H, Sq)): the plain version for CPU tensors, the
    forward kernel with its lse output for CUDA ones (its outputs for meta
    ones)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, with_lse=True)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                   lse=lse), lse


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward saves (q, k, v,
    out, lse), the backward runs ``flash_attention_bwd`` (the kernel on
    the card, the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward_with_lse(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its output, the
    rows' log-sum-exp and the output's gradient. CPU tensors run
    ``flash_attention_bwd_ref``; CUDA tensors launch
    ``csrc/flash_attention_bwd.cu`` (its dQ launch computes delta = rowsum
    (dout * out) in float32 for its rows, its dK / dV launch reads it) or
    raise; meta tensors get its outputs."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cpu, cuda or meta, "
                         f"not {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, causal=causal,
                       window=window, softcap=softcap)[:3]


flash_attention_bwd.launches = 0


def bind_launch(lib):
    """``lib``'s ``flash_attention_launch`` with its C signature set."""
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel():
    return bind_launch(build.load("flash_attention"))


def _check_card(q, k, window):
    """The CUDA kernels' limits on their inputs, each a ``ValueError``."""
    b, h, _, d = q.shape
    if q.dtype not in CUDA_DTYPES:
        raise ValueError(f"q must be one of {CUDA_DTYPES} on the card, got "
                         f"{q.dtype}")
    if d not in CUDA_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head widths "
                         f"{CUDA_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"the CUDA grid takes B*H <= 65535, got {b * h}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _launch(q, k, v, *, causal, window, softcap, lse=None):
    dev = q.device
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_card(q, k, window)
    need = functools.partial(launch_ptr, dev)
    out = torch.empty_like(q)
    ptrs = (need(q, "q", q.dtype, (b, h, sq, d)),
            need(k, "k", q.dtype, (b, h, sk, d)),
            need(v, "v", q.dtype, (b, h, sk, d)), out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v must start on 16-byte boundaries")
    lse_ptr = None if lse is None else need(lse, "lse", torch.float32,
                                            (b, h, sq))
    if counter.active():
        counter.note_kernel("flash_attention", *cost.flash_work(
            b, h, sq, sk, d, causal=causal, window=window,
            itemsize=q.element_size(), lse=lse is not None))
    if dev.type == "meta":
        return out
    err = _kernel()(*ptrs, lse_ptr, b * h, sq, sk, d,
                    int(q.dtype == torch.bfloat16),
                    int(causal), int(window is not None), window or 0,
                    int(softcap is not None), float(softcap or 0.0),
                    1.0 / math.sqrt(d),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    build.count_launches(flash_attention)
    return out


def bind_bwd_launch(lib):
    """``lib``'s ``flash_attention_bwd_launch`` with its C signature set."""
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_bwd():
    return bind_bwd_launch(build.load("flash_attention_bwd"))


def _launch_bwd(q, k, v, out, lse, dout, *, causal, window, softcap):
    """(dq, dk, dv, stats): the two launches on the current stream, and the
    float32 (B*H, 2, Sq rounded up to 64) buffer between them, each row's
    lse and delta = rowsum(dout * out) as the dQ launch wrote them (0 past
    Sq)."""
    dev = q.device
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_card(q, k, window)
    need = functools.partial(launch_ptr, dev)
    ptrs = (need(q, "q", q.dtype, (b, h, sq, d)),
            need(k, "k", q.dtype, (b, h, sk, d)),
            need(v, "v", q.dtype, (b, h, sk, d)),
            need(out, "out", q.dtype, (b, h, sq, d)),
            need(dout, "dout", q.dtype, (b, h, sq, d)))
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v, out, dout must start on 16-byte "
                         "boundaries")
    stats = torch.empty((b * h, 2, -(-sq // 64) * 64), dtype=torch.float32,
                        device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launches = int(sq > 0) + int(sk > 0)
    if counter.active():
        counter.note_kernel("flash_attention_bwd", *cost.flash_bwd_work(
            b, h, sq, sk, d, causal=causal, window=window,
            itemsize=q.element_size()), launches=launches)
    if dev.type == "meta":
        return dq, dk, dv, stats
    err = _kernel_bwd()(*ptrs, need(lse, "lse", torch.float32, (b, h, sq)),
                        stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), b * h, sq, sk, d,
                        int(q.dtype == torch.bfloat16), int(causal),
                        int(window is not None), window or 0,
                        int(softcap is not None), float(softcap or 0.0),
                        1.0 / math.sqrt(d),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with CUDA "
                           f"error {err}")
    # two CUDA launches a call: dQ (and delta), then dK / dV
    build.count_launches(flash_attention_bwd, launches)
    return dq, dk, dv, stats
