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
or raises; ``flash_attention.launches`` counts those launches. ``q_tile``
and ``kv_tile`` are the reference's contract on the lengths (Sq % q_tile ==
Sk % kv_tile == 0, else ``ValueError``) and its TPU grid; the CUDA kernel
tiles by its own constants and masks ragged ends, so they change nothing
else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import launch_ptr

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Dense attention under the kernel's rules (scale q first, float32
    softmax, 0 for a row that sees no key), in ``q.dtype``. Runs a few
    (batch, head) pairs at a time to bound the score matrix's memory."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    mask = visible(sq, sk, causal=causal, window=window, device=q.device)
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    out = torch.empty((b * h, sq, d), dtype=q.dtype, device=q.device)
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
    return out.reshape(b, h, sq, d)


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
    launch the kernel."""
    _check(q, k, v, q_tile, kv_tile)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap)


flash_attention.launches = 0


def _kernel():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, *, causal, window, softcap):
    dev = q.device
    b, h, sq, d = q.shape
    sk = k.shape[2]
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
    need = functools.partial(launch_ptr, dev)
    out = torch.empty_like(q)
    ptrs = (need(q, "q", q.dtype, (b, h, sq, d)),
            need(k, "k", q.dtype, (b, h, sk, d)),
            need(v, "v", q.dtype, (b, h, sk, d)), out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v must start on 16-byte boundaries")
    err = _kernel()(*ptrs, b * h, sq, sk, d, int(q.dtype == torch.bfloat16),
                    int(causal), int(window is not None), window or 0,
                    int(softcap is not None), float(softcap or 0.0),
                    1.0 / math.sqrt(d),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out
