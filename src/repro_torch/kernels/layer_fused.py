"""One GNN layer in one launch: gather, phi, aggregate, update MLP.

The twin of ``repro/kernels/layer_fused.py``. Per edge, phi is the fusable
form ``act(y[snd] * src_weight + edge_term + phi_bias)`` with ``y`` the
gather buffer (``node_input`` or ``x``, width D); per node the update is
one of three epilogues:

  * self term (GIN, GIN-VN, GCN): ``z = sum_agg + self_coeff * x`` with
    ``self_coeff`` None, a scalar (GIN's 1+eps, a 0-d or one-element
    tensor) or a per-node (N,) vector (GCN's self-loop norm);
  * degree scalers (PNA; ``scalers`` (N, S) and ``degrees`` (N,)): mean,
    std, max and min derived from the sum, sum of squares and keyed max /
    min, ``m = [mean | std | max | min]`` and
    ``z = [x | s_0 * m | ... | s_{S-1} * m]`` (width D_x + S·4·D);
  * directional field (DGN; ``field_wsum`` (N,) and ``degrees``): the gather
    buffer is the stacked [x | x·w] pair (D = 2·D_x) and
    ``z = [x | s1[:, :D_x] / deg | |s1[:, D_x:] - x * field_wsum|]``
    (width 3·D_x);

then ``out = act_out(mlp(z))`` with ``mlp`` one dense layer (w1, b1) or two
with a ReLU between (w1, b1, w2, b2).

Out-of-range indices follow the Pallas kernel: an edge whose receiver lies
outside [0, N) adds nothing, and one whose sender does gathers a zero row
of ``y`` and still counts.

``layer_fused`` takes its plain PyTorch version ``layer_fused_ref`` for
tensors on the CPU. For CUDA tensors it launches the hand-written kernel
``csrc/layer_fused.cu`` or raises; ``layer_fused.launches`` counts those
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mp_pipeline import (_SW_MODES, BIG,
                                             apply_fusable_phi, launch_ptr,
                                             owned_stream, seg_extreme_rows,
                                             seg_sum_rows, src_weight_mode)

_EPILOGUES = {"self_mlp": 0, "scalers": 1, "field": 2}


def _check_args(x, num_nodes, *, w1, node_input, self_coeff, scalers,
                degrees, field_wsum, w2, b2, phi_activation, out_activation):
    """The reference's argument checks (``ValueError``), in its order;
    returns the message width D and the epilogue's name."""
    if phi_activation not in ("none", "relu"):
        raise ValueError(f"unsupported activation '{phi_activation}'")
    if out_activation not in ("none", "relu"):
        raise ValueError(f"unsupported activation '{out_activation}'")
    if (w2 is None) != (b2 is None):
        raise ValueError("w2 and b2 must be given together")
    if sum(p is not None for p in (self_coeff, scalers, field_wsum)) > 1:
        raise ValueError(
            "self_coeff, scalers and field_wsum are mutually exclusive")
    if (scalers is not None or field_wsum is not None) and degrees is None:
        raise ValueError("the scalers/field epilogues need the shared degrees")
    n, d_x = x.shape
    if n != num_nodes:
        raise ValueError(f"node buffer has {n} rows, expected {num_nodes}")
    y = x if node_input is None else node_input
    if y.shape[0] != num_nodes:
        raise ValueError(
            f"node_input has {y.shape[0]} rows, expected {num_nodes}")
    d = y.shape[1]
    epilogue = ("scalers" if scalers is not None
                else "field" if field_wsum is not None else "self_mlp")
    if epilogue == "scalers":
        d_in = d_x + scalers.shape[1] * 4 * d
    elif epilogue == "field":
        if d != 2 * d_x:
            raise ValueError(
                f"the field epilogue expects a stacked gather buffer of "
                f"width 2·{d_x}, got {d}")
        d_in = d_x + d
    else:
        d_in = d
    if w1.shape[0] != d_in:
        raise ValueError(f"w1 contracts over {w1.shape[0]}, epilogue "
                         f"'{epilogue}' expects {d_in}")
    if self_coeff is not None:
        sc_shape = tuple(torch.as_tensor(self_coeff).shape)
        if sc_shape not in ((), (1,), (num_nodes,)):
            raise ValueError(f"self_coeff must be scalar or ({num_nodes},), "
                             f"got shape {sc_shape}")
        if d_x != d:
            raise ValueError(f"the self term adds x of width {d_x} to "
                             f"messages of width {d}")
    if scalers is not None and scalers.shape[0] != num_nodes:
        raise ValueError(
            f"scalers has {scalers.shape[0]} rows, expected {num_nodes}")
    return d, epilogue


def layer_fused_ref(x: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, edge_mask: torch.Tensor,
                    num_nodes: int, *, w1: torch.Tensor, b1: torch.Tensor,
                    node_input: Optional[torch.Tensor] = None,
                    src_weight: Optional[torch.Tensor] = None,
                    edge_term: Optional[torch.Tensor] = None,
                    phi_bias: Optional[torch.Tensor] = None,
                    phi_activation: str = "none", self_coeff=None,
                    scalers: Optional[torch.Tensor] = None,
                    degrees: Optional[torch.Tensor] = None,
                    field_wsum: Optional[torch.Tensor] = None,
                    w2: Optional[torch.Tensor] = None,
                    b2: Optional[torch.Tensor] = None,
                    out_activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version of ``layer_fused`` (same contract)."""
    f32 = torch.float32
    y = x if node_input is None else node_input
    msg = apply_fusable_phi(y, senders, src_weight=src_weight,
                            edge_term=edge_term, bias=phi_bias,
                            activation=phi_activation)
    own, receivers = owned_stream(receivers, edge_mask, num_nodes)
    own = own[:, None]
    m0 = torch.where(own, msg, 0.0)
    s1 = seg_sum_rows(m0, receivers, num_nodes)
    xf = x.to(f32)
    if field_wsum is not None or scalers is not None:
        if degrees is None:
            raise ValueError(
                "the scalers/field epilogues need the shared degrees")
        deg = degrees.to(f32)[:, None]
        rdenom = 1.0 / torch.clamp(deg, min=1.0)
    if field_wsum is not None:
        d_x = x.shape[1]
        mean = s1[:, :d_x] * rdenom
        dx = torch.abs(s1[:, d_x:] - xf * field_wsum.to(f32)[:, None])
        z = torch.cat([xf, mean, dx], dim=-1)
    elif scalers is not None:
        s2 = seg_sum_rows(m0 * m0, receivers, num_nodes)
        mx = seg_extreme_rows(msg, own, receivers, num_nodes, -BIG, "amax")
        mn = seg_extreme_rows(msg, own, receivers, num_nodes, BIG, "amin")
        mean = s1 * rdenom
        var = torch.clamp(s2 * rdenom - mean * mean, min=0.0)
        std = torch.sqrt(var + 1e-5)
        nonempty = deg > 0.0
        mx = torch.where(nonempty & (mx > -BIG), mx, 0.0)
        mn = torch.where(nonempty & (mn < BIG), mn, 0.0)
        m = torch.cat([mean, std, mx, mn], dim=-1)
        sc = scalers.to(f32)
        z = torch.cat([xf] + [m * sc[:, k:k + 1]
                              for k in range(sc.shape[1])], dim=-1)
    else:
        z = s1
        if self_coeff is not None:
            sc = torch.as_tensor(self_coeff, dtype=f32, device=x.device)
            z = z + xf * (sc if sc.ndim == 0 else sc[:, None])
    h = z @ w1.to(f32) + b1.to(f32)
    if w2 is not None:
        h = torch.relu(h) @ w2.to(f32) + b2.to(f32)
    if out_activation == "relu":
        h = torch.relu(h)
    return h.to(x.dtype)


def layer_fused(x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_mask: torch.Tensor,
                num_nodes: int, *, w1: torch.Tensor, b1: torch.Tensor,
                node_input: Optional[torch.Tensor] = None,
                src_weight: Optional[torch.Tensor] = None,
                edge_term: Optional[torch.Tensor] = None,
                phi_bias: Optional[torch.Tensor] = None,
                phi_activation: str = "none", self_coeff=None,
                scalers: Optional[torch.Tensor] = None,
                degrees: Optional[torch.Tensor] = None,
                field_wsum: Optional[torch.Tensor] = None,
                w2: Optional[torch.Tensor] = None,
                b2: Optional[torch.Tensor] = None,
                out_activation: str = "none", edge_tile: int = 128,
                num_banks: int = 4,
                rows_per_block: Optional[int] = None) -> torch.Tensor:
    """One-launch GNN layer; returns (num_nodes, D_out) in ``x.dtype``.

    CPU tensors run ``layer_fused_ref``; CUDA tensors launch the kernel.
    ``edge_tile`` and ``num_banks`` are the reference's TPU grid; they do
    not bind on Hopper, are accepted with the reference's defaults and
    change nothing.
    ``rows_per_block`` overrides how many destination rows one CUDA block
    owns, as far as shared memory allows (the kernel's own choice by
    default; the result does not depend on it).
    """
    d, epilogue = _check_args(
        x, num_nodes, w1=w1, node_input=node_input, self_coeff=self_coeff,
        scalers=scalers, degrees=degrees, field_wsum=field_wsum, w2=w2,
        b2=b2, phi_activation=phi_activation, out_activation=out_activation)
    sw_mode, head_dim = ("none", 0) if src_weight is None else (
        src_weight_mode(src_weight, d))      # raises on a bad width
    if x.device.type == "cpu":
        return layer_fused_ref(
            x, senders, receivers, edge_mask, num_nodes, w1=w1, b1=b1,
            node_input=node_input, src_weight=src_weight,
            edge_term=edge_term, phi_bias=phi_bias,
            phi_activation=phi_activation, self_coeff=self_coeff,
            scalers=scalers, degrees=degrees, field_wsum=field_wsum,
            w2=w2, b2=b2, out_activation=out_activation)
    if x.device.type != "cuda":
        raise ValueError(f"layer_fused runs on cpu or cuda, not {x.device}")
    return _launch(x, senders, receivers, edge_mask, num_nodes, d, epilogue,
                   sw_mode, head_dim, w1=w1, b1=b1, node_input=node_input,
                   src_weight=src_weight, edge_term=edge_term,
                   phi_bias=phi_bias, phi_activation=phi_activation,
                   self_coeff=self_coeff, scalers=scalers, degrees=degrees,
                   field_wsum=field_wsum, w2=w2, b2=b2,
                   out_activation=out_activation,
                   rows_per_block=rows_per_block)


layer_fused.launches = 0


def _kernel():
    fn = build.load("layer_fused").layer_fused_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int:
        # pointers are cut and the stream slot holds garbage
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, senders, receivers, edge_mask, num_nodes, d, epilogue,
            sw_mode, head_dim, *, w1, b1, node_input, src_weight, edge_term,
            phi_bias, phi_activation, self_coeff, scalers, degrees,
            field_wsum, w2, b2, out_activation, rows_per_block):
    dev = x.device
    e = senders.shape[0]
    d_x = x.shape[1]
    f32 = torch.float32
    need = functools.partial(launch_ptr, dev)

    def node_vec(t, name):
        return None if t is None else need(t, name, f32, (num_nodes,))

    y = x if node_input is None else node_input
    d_in, d_ff = w1.shape
    two_layer = w2 is not None
    d_out = w2.shape[1] if two_layer else d_ff
    if max(e, num_nodes) * d >= 2 ** 31:
        raise ValueError("layer_fused indexes edge and node rows with int32")
    if rows_per_block is not None and rows_per_block < 1:
        raise ValueError("rows_per_block must be >= 1")

    sw_cols, sw_ptr = 0, None
    if src_weight is not None:
        sw_cols = 1 if sw_mode == "scalar" else src_weight.shape[1]
        sw_ptr = need(src_weight, "src_weight", f32,
                      (e,) if sw_mode == "scalar" else (e, sw_cols))
    self_mode, sc_ptr = 0, None
    if self_coeff is not None:
        sc = self_coeff
        if not isinstance(sc, torch.Tensor):
            sc = torch.tensor(float(sc), dtype=f32, device=dev)
        sc = sc.reshape(-1)
        self_mode = 1 if sc.numel() == 1 else 2     # scalar | per node
        sc_ptr = need(sc, "self_coeff", f32, sc.shape)
    n_scalers = 0 if scalers is None else scalers.shape[1]

    out = torch.empty((num_nodes, d_out), dtype=f32, device=dev)
    args = (
        need(x, "x", f32, (num_nodes, d_x)),
        need(y, "node_input", f32, (num_nodes, d)),
        need(senders, "senders", torch.int64, (e,)),
        need(receivers, "receivers", torch.int64, (e,)),
        need(edge_mask, "edge_mask", torch.bool, (e,)),
        sw_ptr,
        None if edge_term is None else need(edge_term, "edge_term", f32,
                                            (e, d)),
        None if phi_bias is None else need(phi_bias, "phi_bias", f32, (d,)),
        sc_ptr,
        None if scalers is None else need(scalers, "scalers", f32,
                                          (num_nodes, n_scalers)),
        node_vec(degrees if epilogue != "self_mlp" else None, "degrees"),
        node_vec(field_wsum, "field_wsum"),
        need(w1, "w1", f32, (d_in, d_ff)),
        need(b1, "b1", f32, (d_ff,)),
        None if w2 is None else need(w2, "w2", f32, (d_ff, d_out)),
        None if b2 is None else need(b2, "b2", f32, (d_out,)),
        out.data_ptr(),
        num_nodes, e, d, d_x, d_in, d_ff, d_out,
        _SW_MODES[sw_mode], sw_cols, head_dim, self_mode,
        _EPILOGUES[epilogue], n_scalers,
        int(phi_activation == "relu"), int(out_activation == "relu"),
        rows_per_block or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"layer_fused launch failed with CUDA error {err}")
    layer_fused.launches += 1
    return out
