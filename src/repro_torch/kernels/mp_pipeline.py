"""The fused gather-phi-scatter edge phase, with its plain PyTorch version.

The twin of ``repro/kernels/mp_pipeline.py``. Per edge, phi is

    phi_e = act( y[snd_e] * src_weight_e + edge_term_e + bias )

with ``src_weight`` per-edge scalars (E,), full width (E, D) or per-head
lanes (E, H) with H dividing D, and every term optional. The edge phase
accumulates phi into raw float32 statistics per destination in one sweep:
``sum``, ``sumsq``, ``count`` (N, 1), and keyed ``max`` / ``min``, whose
empty destinations sit at the finite -BIG / +BIG.

With ``att_src`` / ``att_dst`` (N, H) the sweep also carries GAT's edge
softmax online: per head, logit_e = leaky_relu(att_src[snd_e] +
att_dst[rcv_e], slope), a running max and a rescaled denominator per
(destination, head), and ``sum`` comes back softmax-weighted and normalised,
followed by the carries ``att_max`` (-BIG when empty) and ``att_denom``
(0 when empty), both (N, H).

Out-of-range indices follow the Pallas kernel: an edge whose receiver lies
outside [0, N) adds nothing, and one whose sender does gathers a zero row
and still counts (phi = act(edge_term + bias); its attention source half
is 0).

``mp_pipeline`` takes its plain version ``mp_pipeline_ref`` for tensors on
the CPU. For CUDA tensors it launches the hand-written kernel
``csrc/mp_pipeline.cu`` or raises; ``mp_pipeline.launches`` counts those
launches. ``apply_fusable_phi`` is shared with ``layer_fused``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

# Finite keyed-select offset of the max/min accumulators (empty
# destinations sit at -BIG / +BIG).
BIG = 1e30

# The accumulators, in the order the outputs come back.
MULTI_STATS = ("sum", "sumsq", "count", "max", "min")
# The online-softmax carries, appended when attention is on.
ATT_STATS = ("att_max", "att_denom")

_SW_MODES = {"none": 0, "scalar": 1, "full": 2, "head": 3}


def src_weight_mode(src_weight: torch.Tensor, d: int):
    """Classify a src_weight stream: ``('scalar', 0)`` for (E,),
    ``('full', 0)`` for (E, D), ``('head', D // H)`` for per-head (E, H)
    lanes with H dividing D."""
    if src_weight.ndim == 1:
        return "scalar", 0
    h = src_weight.shape[1]
    if h == d:
        return "full", 0
    if h and d % h == 0:
        return "head", d // h
    raise ValueError(
        f"src_weight width {h} must equal D={d} or divide it (per-head)")


def owned_stream(receivers: torch.Tensor, edge_mask: torch.Tensor,
                 num_nodes: int):
    """The edges that count, ``edge_mask`` and a receiver in [0, N), and
    the receivers with every other edge sent to row 0 (where the caller
    adds its neutral), so that the scatter ops stay in bounds."""
    own = edge_mask & (receivers >= 0) & (receivers < num_nodes)
    return own, torch.where(own, receivers, 0)


def src_rows(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """``x[senders]`` with a zero row for a sender outside [0, N), as the
    Pallas kernels' one-hot gather gives (no wrap of negative indices)."""
    ok = (senders >= 0) & (senders < x.shape[0])
    rows = x[torch.where(ok, senders, 0)]
    return torch.where(ok.reshape(-1, *([1] * (rows.ndim - 1))), rows, 0)


def apply_fusable_phi(x: torch.Tensor, senders: torch.Tensor, *,
                      src_weight: Optional[torch.Tensor] = None,
                      edge_term: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      activation: str = "none") -> torch.Tensor:
    """act(x[snd] * sw + et + b) in float32, terms applied in that order;
    a sender outside [0, N) reads a zero row."""
    msg = src_rows(x, senders).to(torch.float32)
    if src_weight is not None:
        sw = src_weight.to(torch.float32)
        if sw.ndim == 1:
            msg = msg * sw[:, None]
        else:
            mode, head_dim = src_weight_mode(sw, msg.shape[1])
            if mode == "head":
                e_n, d_n = msg.shape
                msg = (msg.reshape(e_n, sw.shape[1], head_dim)
                       * sw[:, :, None]).reshape(e_n, d_n)
            else:
                msg = msg * sw
    if edge_term is not None:
        msg = msg + edge_term.to(torch.float32)
    if bias is not None:
        msg = msg + bias.to(torch.float32)
    if activation == "relu":
        msg = torch.relu(msg)
    elif activation != "none":
        raise ValueError(f"unsupported activation '{activation}'")
    return msg


def seg_sum_rows(v: torch.Tensor, receivers: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """f32 per-destination sums of the (E, W) rows ``v``."""
    return torch.zeros((num_nodes, v.shape[1]), dtype=torch.float32,
                       device=v.device).index_add_(0, receivers, v)


def seg_extreme_rows(v: torch.Tensor, own: torch.Tensor,
                     receivers: torch.Tensor, num_nodes: int, fill: float,
                     reduce: str) -> torch.Tensor:
    """Per-destination max (``reduce='amax'``) or min (``'amin'``) of the
    (E, W) rows ``v`` where ``own`` (E, 1) is set, seeded with the finite
    neutral ``fill``: rows no edge reaches keep it."""
    seed = torch.full((num_nodes, v.shape[1]), fill, dtype=torch.float32,
                      device=v.device)
    return seed.scatter_reduce(0, receivers[:, None].expand(-1, v.shape[1]),
                               torch.where(own, v, fill), reduce,
                               include_self=False)


def no_backward(name: str, *tensors) -> None:
    """Raise where autograd would need a backward this kernel does not have:
    grad mode on and a CUDA input that requires grad. The kernel's output
    would carry no ``grad_fn``, and the gradient upstream would be lost
    without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.device.type == "cuda" and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{name} has no backward on the card; call it "
                           f"under torch.no_grad() or on tensors that need "
                           f"no grad")


def launch_ptr(dev: torch.device, t: torch.Tensor, name: str, dtype,
               shape) -> int:
    """The data pointer of ``t`` for a kernel launch on ``dev``, after the
    checks the kernel cannot make: device, dtype, shape and contiguity,
    each a ``ValueError``."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _check_args(x, num_nodes, stats, activation, att_src, att_dst):
    """The reference's argument checks (``ValueError``); returns the stats
    in ``MULTI_STATS`` order and the attention head count (0 when off)."""
    stats = tuple(s for s in MULTI_STATS if s in stats)
    if not stats:
        raise ValueError("stats must name at least one accumulator")
    if activation not in ("none", "relu"):
        raise ValueError(f"unsupported activation '{activation}'")
    if (att_src is None) != (att_dst is None):
        raise ValueError("att_src and att_dst must be given together")
    n, d = x.shape
    if n != num_nodes:
        raise ValueError(f"node buffer has {n} rows, expected {num_nodes}")
    heads = 0
    if att_src is not None:
        if "sum" not in stats or set(stats) - {"sum", "count"}:
            raise ValueError(
                "attention supports stats ('sum',) plus optional 'count', "
                f"got {stats}")
        if (att_src.shape != att_dst.shape or att_src.ndim != 2
                or att_src.shape[0] != num_nodes):
            raise ValueError(
                f"attention halves must both be ({num_nodes}, H), got "
                f"{tuple(att_src.shape)} / {tuple(att_dst.shape)}")
        heads = att_src.shape[1]
        if heads == 0 or d % heads != 0:
            raise ValueError(
                f"attention head count {heads} must divide D={d}")
    return stats, heads


def mp_pipeline_ref(x: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, edge_mask: torch.Tensor,
                    num_nodes: int, stats, *,
                    src_weight: Optional[torch.Tensor] = None,
                    edge_term: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    activation: str = "none",
                    att_src: Optional[torch.Tensor] = None,
                    att_dst: Optional[torch.Tensor] = None,
                    att_slope: float = 0.2) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of ``mp_pipeline`` (raw f32 accumulators).

    The same contract: the ∓BIG neutral of empty-destination max/min, the
    attention carries (``att_max`` -BIG / ``att_denom`` 0 when empty) and
    the softmax-weighted, normalised ``sum``, and the out-of-range rules of
    the module docstring. The softmax is two-pass here (segment max, then
    exp and sums), as in the kernel, which also rescales across its edge
    tiles past the first.
    """
    msg = apply_fusable_phi(x, senders, src_weight=src_weight,
                            edge_term=edge_term, bias=bias,
                            activation=activation)
    e_n, d = msg.shape
    own, receivers = owned_stream(receivers, edge_mask, num_nodes)
    count = own.to(torch.float32)[:, None]
    own = own[:, None]

    def seg_sum(v):
        return seg_sum_rows(v, receivers, num_nodes)

    def seg_ext(v, fill, reduce):
        return seg_extreme_rows(v, own, receivers, num_nodes, fill, reduce)

    out: Dict[str, torch.Tensor] = {}
    att = {}
    if att_src is not None:
        heads = att_src.shape[1]
        hd = d // heads
        logits = (src_rows(att_src, senders)
                  + att_dst[receivers]).to(torch.float32)
        logits = torch.where(logits >= 0.0, logits, att_slope * logits)
        m = seg_ext(logits, -BIG, "amax")
        p = torch.where(own, torch.exp(logits - m[receivers]), 0.0)
        denom = seg_sum(p)
        num = seg_sum((p[:, :, None] * msg.reshape(e_n, heads, hd)
                       ).reshape(e_n, d))
        wgt = torch.where(denom > 0.0,
                          1.0 / torch.clamp(denom, min=1e-16), 0.0)
        out["sum"] = (num.reshape(num_nodes, heads, hd)
                      * wgt[:, :, None]).reshape(num_nodes, d)
        att = {"att_max": m, "att_denom": denom}
    elif "sum" in stats:
        out["sum"] = seg_sum(torch.where(own, msg, 0.0))
    if "sumsq" in stats:
        m0 = torch.where(own, msg, 0.0)
        out["sumsq"] = seg_sum(m0 * m0)
    if "count" in stats:
        out["count"] = seg_sum(count)
    if "max" in stats:
        out["max"] = seg_ext(msg, -BIG, "amax")
    if "min" in stats:
        out["min"] = seg_ext(msg, BIG, "amin")
    out.update(att)
    return out


def mp_pipeline(x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_mask: torch.Tensor,
                num_nodes: int, *, stats,
                src_weight: Optional[torch.Tensor] = None,
                edge_term: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                activation: str = "none",
                att_src: Optional[torch.Tensor] = None,
                att_dst: Optional[torch.Tensor] = None,
                att_slope: float = 0.2, edge_tile: int = 128,
                num_banks: int = 4, rows_per_block: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """One-launch edge phase: gather, fusable phi, multi-stat scatter.

    Returns ``{name: f32 tensor}`` for the requested ``stats`` in
    ``MULTI_STATS`` order, then ``ATT_STATS`` when attention is on.
    Attention restricts ``stats`` to ("sum",) plus an optional "count".
    CPU tensors run ``mp_pipeline_ref``; CUDA tensors launch the kernel.
    ``edge_tile`` and ``num_banks`` are the reference's TPU grid (edge tile
    and destination banks); they do not bind on Hopper, are accepted with
    the reference's defaults and change nothing. ``rows_per_block``
    overrides how many destination rows one CUDA block owns (the kernel's
    own choice by default; the result does not depend on it).
    """
    stats, heads = _check_args(x, num_nodes, stats, activation, att_src,
                               att_dst)
    sw_mode, head_dim = ("none", 0) if src_weight is None else (
        src_weight_mode(src_weight, x.shape[1]))      # raises on a bad width
    if x.device.type == "cpu":
        return mp_pipeline_ref(
            x, senders, receivers, edge_mask, num_nodes, stats,
            src_weight=src_weight, edge_term=edge_term, bias=bias,
            activation=activation, att_src=att_src, att_dst=att_dst,
            att_slope=att_slope)
    if x.device.type != "cuda":
        raise ValueError(f"mp_pipeline runs on cpu or cuda, not {x.device}")
    no_backward("mp_pipeline", x, src_weight, edge_term, bias, att_src,
                att_dst)
    return _launch(x, senders, receivers, edge_mask, num_nodes, stats, heads,
                   sw_mode, head_dim, src_weight=src_weight,
                   edge_term=edge_term, bias=bias, activation=activation,
                   att_src=att_src, att_dst=att_dst, att_slope=att_slope,
                   rows_per_block=rows_per_block)


mp_pipeline.launches = 0


def _kernel():
    fn = build.load("mp_pipeline").mp_pipeline_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, senders, receivers, edge_mask, num_nodes, stats, heads,
            sw_mode, head_dim, *, src_weight, edge_term, bias, activation,
            att_src, att_dst, att_slope, rows_per_block):
    dev = x.device
    n, d = x.shape
    e = senders.shape[0]
    need = functools.partial(launch_ptr, dev)

    f32 = torch.float32
    if e >= 2 ** 31 or n * max(d, 1) >= 2 ** 31:
        raise ValueError("mp_pipeline indexes edges and node rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")

    sw_cols, sw_ptr = 0, None
    if src_weight is not None:
        sw_cols = 1 if sw_mode == "scalar" else src_weight.shape[1]
        sw_ptr = need(src_weight, "src_weight", f32,
                      (e,) if sw_mode == "scalar" else (e, sw_cols))
    att_ptrs = (None, None)
    if heads:
        att_ptrs = (need(att_src, "att_src", f32, (n, heads)),
                    need(att_dst, "att_dst", f32, (n, heads)))

    widths = {"sum": d, "sumsq": d, "count": 1, "max": d, "min": d,
              "att_max": heads, "att_denom": heads}
    names = stats + (ATT_STATS if heads else ())
    out = {s: torch.empty((n, widths[s]), dtype=f32, device=dev)
           for s in names}

    def ptr(name):
        return out[name].data_ptr() if name in out else None

    args = (
        need(x, "x", f32, (n, d)),
        need(senders, "senders", torch.int64, (e,)),
        need(receivers, "receivers", torch.int64, (e,)),
        need(edge_mask, "edge_mask", torch.bool, (e,)),
        sw_ptr,
        None if edge_term is None else need(edge_term, "edge_term", f32,
                                            (e, d)),
        None if bias is None else need(bias, "bias", f32, (d,)),
        *att_ptrs,
        ptr("sum"), ptr("sumsq"), ptr("count"), ptr("max"), ptr("min"),
        ptr("att_max"), ptr("att_denom"),
        n, e, d, _SW_MODES[sw_mode], sw_cols, head_dim,
        int(activation == "relu"), heads, float(att_slope),
        rows_per_block or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"mp_pipeline launch failed with CUDA error {err}")
    build.count_launches(mp_pipeline)
    return out
