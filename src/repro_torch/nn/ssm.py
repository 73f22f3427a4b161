"""Mamba2's SSD (state-space duality) mixer, chunked.

The twin of ``repro/nn/ssm.py``. The sequence is cut into chunks: the terms
within a chunk are dense (Q x Q) masked products, the terms across chunks
carry an (H, P, N) state through a short scan (arXiv:2405.21060). The
reference computes all of it with jnp outside any Pallas kernel, so the
port computes it in plain PyTorch: a Python loop over the chunks for the
scan, products by ``torch.einsum``, every intermediate float32.

``ssd_ref`` is the naive O(S) recurrence, the oracle of the tests.

Caches are updated in place where the caller passes views of a stacked
buffer (``nn/transformer.py::stack_apply``): ``MambaCache.state`` and
``.conv`` are written, ``length`` is a Python int.

On a mesh (``rules`` / ``mesh``, inside a position of a serving or
training step's ``shard_map``) the weights are whole, as the reference's
rules place them (``in_proj`` and ``out_proj`` split only by FSDP's
``embed_fsdp``, gathered just before their products), and the heads are
split in the activations (``ssm_heads`` on the model axis). ``x`` is
gathered whole over the sequence where the residual is split; every
position runs the input projection, the causal conv, the gated RMSNorm
and the output projection on every row, and the SSD on its own block of
heads: its columns of ``xhs`` and ``dt`` and its slices of ``a_log``,
``d_skip`` and ``dt_bias`` (``bmat`` / ``cmat`` are every head's). The
decode cache's state is the position's heads, its conv window whole on
every position. The SSD's output is gathered over the heads before the
gate; the output projection is then whole on every position, which keeps
its own rows. Without a mesh every split axis is ``None`` and every helper
an identity.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (Mesh, ParamDef, ShardingRules,
                                              logical_constraint)
from repro_torch.distributed.tensor_parallel import (gather_dim, gather_fsdp,
                                                     gather_seq, global_batch,
                                                     own_rows, split_axis)
from repro_torch.nn.layers import rmsnorm


def mamba_param_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    din = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = din + 2 * n
    f32 = torch.float32
    return {
        "in_proj": ParamDef((d, 2 * din + 2 * n + h), ("embed_fsdp", None),
                            dtype=cfg.dtype),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), (None, None),
                           scale=0.3, dtype=cfg.dtype),
        "conv_b": ParamDef((conv_dim,), (None,), init="zeros",
                           dtype=cfg.dtype),
        "a_log": ParamDef((h,), (None,), init="constant", constant=0.5,
                          dtype=f32),
        "d_skip": ParamDef((h,), (None,), init="ones", dtype=f32),
        "dt_bias": ParamDef((h,), (None,), init="zeros", dtype=f32),
        "norm_scale": ParamDef((din,), (None,), init="ones", dtype=cfg.dtype),
        "out_proj": ParamDef((din, d), (None, "embed_fsdp"), dtype=cfg.dtype),
    }


class MambaCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32 SSM state
    conv: torch.Tensor    # (B, W-1, conv_dim) conv window
    length: int           # tokens seen


def put_window(buf: torch.Tensor, window: torch.Tensor) -> None:
    """Write a prefill's conv window into the cache's ``buf`` in place. The
    reference's slice has W-1 rows only for prompts of at least W-1 tokens
    (a shorter prompt slices from a negative start, and its next decode
    step fails); such a window raises here rather than broadcast."""
    if window.shape != buf.shape:
        raise ValueError(f"a prompt of {window.shape[1]} conv rows cannot "
                         f"fill a window of {buf.shape[1]}: prefill at "
                         f"least {buf.shape[1]} tokens")
    buf.copy_(window)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then silu. x: (B, S, C);
    w: (W, C)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: (B, S, H, P); dt: (B, S, H); bm / cm: (B, S, N).

    Returns (y (B, S, H, P) in xh.dtype, final_state (B, H, P, N) float32).
    S is padded to a multiple of Q = min(chunk, S) with dt = 0: decay 1 and
    no update, an exact no-op."""
    b, s_real, h, p = xh.shape
    n = bm.shape[-1]
    q = min(chunk, s_real)
    pad = (-s_real) % q
    f32 = torch.float32
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    s = s_real + pad
    nc = s // q
    a = -torch.exp(a_log.to(f32))                               # (H,) < 0
    dtf = dt.to(f32)

    xc = xh.reshape(b, nc, q, h, p).to(f32)
    dtc = dtf.reshape(b, nc, q, h)
    bc = bm.reshape(b, nc, q, n).to(f32)
    cc = cm.reshape(b, nc, q, n).to(f32)
    cs = torch.cumsum(dtc * a, dim=2)                           # (B,C,Q,H)

    # within a chunk: decay from j to i (j's own decay excluded, dt_j in).
    # The exponent is masked, not its result: above the diagonal diff >= 0
    # grows with the chunk and exp overflows to inf there (a full-width
    # chunk of 128), whose masked gradient is 0 * inf = NaN in the
    # reference's where(tril, exp(diff), 0); exp(-inf) = 0 gives the same
    # values and a zero gradient
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # (B,C,i,j,H)
    decay = torch.exp(torch.where(tril[None, None, :, :, None], diff,
                                  -torch.inf))
    del diff
    g = torch.einsum("bcin,bcjn->bcij", cc, bc)                 # (B,C,Q,Q)
    m = g[..., None] * decay * dtc[:, :, None, :, :]
    del decay, g
    y = torch.einsum("bcijh,bcjhp->bcihp", m, xc)
    del m

    # each chunk's state: sum_j B_j dt_j decay(j -> end) x_j
    last = cs[:, :, -1:, :]                                     # (B,C,1,H)
    states = torch.einsum("bcjn,bcjhp->bchpn", bc,
                          (dtc * torch.exp(last - cs))[..., None] * xc)
    chunk_decay = torch.exp(last[:, :, 0, :])                   # (B,C,H)

    carry = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    s_in = torch.empty_like(states)                             # incoming
    for c in range(nc):
        s_in[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    y += (torch.einsum("bcin,bchpn->bcihp", cc, s_in)
          * torch.exp(cs)[..., None])
    y = y.reshape(b, s, h, p)[:, :s_real]
    return y.to(xh.dtype), carry


def ssd_ref(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """The naive O(S) recurrence (the tests' oracle), in xh.dtype."""
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    x32, dt32, b32, c32 = (t.to(f32) for t in (xh, dt, bm, cm))
    state = torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    ys = []
    for i in range(s):
        dt_t = dt32[:, i]                                       # (B, H)
        upd = (dt_t[..., None, None] * x32[:, i, :, :, None]
               * b32[:, i, None, None, :])                      # (B,H,P,N)
        state = state * torch.exp(dt_t * a)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c32[:, i]))
    return torch.stack(ys, dim=1).to(xh.dtype)


def mamba_mixer(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, *, cache: Optional[MambaCache] = None,
                rules: Optional[ShardingRules] = None,
                mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """One Mamba2 mixer. x: (B, S, d), a position's rows where the residual
    is split by sequence.

    Without a cache: the chunked SSD over the sequence. With a cache and
    S == 1: one recurrence step on the cached state and conv window, both
    written in place. A prefill with a cache writes the final state and the
    last W-1 inputs of the conv (the reference's slice ``xbc[:, S-W+1:]``:
    prompts of at least W-1 tokens give a full window). On a mesh the SSD
    and the state run on the position's heads (the module's docstring)."""
    sp = split_axis(rules, mesh, "seq_sp")
    hax = split_axis(rules, mesh, "ssm_heads")
    ef = split_axis(rules, mesh, "embed_fsdp")
    x = gather_seq(x, sp)
    b, s, _ = x.shape
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    f32 = torch.float32

    zxbcdt = x @ gather_fsdp(params["in_proj"], 0, ef)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * n]
    # the position's heads of dt and of the per-head vectors
    dt = F.softplus(own_rows(zxbcdt[..., -h:], hax, 2).to(f32)
                    + own_rows(params["dt_bias"], hax, 0))
    a_log = own_rows(params["a_log"], hax, 0)
    d_skip = own_rows(params["d_skip"], hax, 0)

    new_cache = None
    if cache is not None and s == 1:
        # decode: roll the conv window, one step of the recurrence
        window = torch.cat([cache.conv, xbc], dim=1)            # (B, W, C)
        conv = F.silu(torch.einsum("bwc,wc->bc", window.to(f32),
                                   params["conv_w"].to(f32))
                      + params["conv_b"].to(f32))
        xht = own_rows(conv[..., :din].reshape(b, h, p), hax, 1)
        bmat = conv[..., din:din + n]
        cmat = conv[..., din + n:]
        a = -torch.exp(a_log.to(f32))
        dt_t = dt[:, 0]                                         # (B, H)
        upd = dt_t[..., None, None] * xht[..., None] * bmat[:, None, None, :]
        state = cache.state * torch.exp(dt_t * a)[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, cmat)
        y = y + d_skip[None, :, None] * xht
        y = gather_dim(y.to(x.dtype), hax, 1).reshape(b, 1, din)
        cache.state.copy_(state)
        cache.conv.copy_(window[:, 1:])
        new_cache = MambaCache(cache.state, cache.conv, cache.length + 1)
    else:
        xbc_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        xhs = own_rows(xbc_conv[..., :din].reshape(b, s, h, p), hax, 2)
        bmat = xbc_conv[..., din:din + n]
        cmat = xbc_conv[..., din + n:]
        gb = global_batch(b, rules, mesh)
        xhs = logical_constraint(xhs, "batch", "seq", "ssm_heads", None,
                                 rules=rules, mesh=mesh, shape=(gb, s, h, p))
        dt = logical_constraint(dt, "batch", "seq", "ssm_heads", rules=rules,
                                mesh=mesh, shape=(gb, s, h))
        y, final = ssd_chunked(xhs, dt, a_log, bmat, cmat, cfg.ssm_chunk)
        y = y + d_skip[None, None, :, None] * xhs.to(f32)
        y = gather_dim(y.to(x.dtype), hax, 2).reshape(b, s, din)
        if cache is not None:                                   # prefill
            cache.state.copy_(final)
            put_window(cache.conv, xbc[:, s - cfg.ssm_conv + 1:, :])
            new_cache = MambaCache(cache.state, cache.conv, s)

    y = rmsnorm(y * F.silu(z.to(f32)).to(x.dtype), params["norm_scale"],
                cfg.norm_eps)
    # whole on every position: each keeps its rows of the sequence
    return own_rows(y @ gather_fsdp(params["out_proj"], 1, ef), sp), \
        new_cache
