"""The FlowGNN-banked MoE data path, composed from the port's kernels.

The twin of ``repro/kernels/moe_dispatch.py``, which has no kernel of its
own:

    dispatch: buf = mp_scatter(x[token_ids], slot, own, num_slots)
    combine:  out = mp_scatter(w * gather_rows(y, slot, own), token_ids, T)

The routing arrays are the router's raw output order (``token_ids``,
``slot``, ``own``, ``weights``, each (T*k,)); any order gives the same
buffer, since every owned slot is hit by one assignment. An assignment that
is not owned may point its slot one past the buffer (``nn/moe.py``'s trash
row): it is masked and adds nothing. ``pad_assignments`` brings a stream
to the wrappers' index tile with such assignments. The dtypes follow the
reference: dispatch returns ``x.dtype``, combine float32. On the card each
step is one kernel launch (``mp_scatter``, ``gather_rows``,
``mp_scatter``); the token gather ``x[token_ids]`` and the weighting are
PyTorch ops, as the reference leaves them to XLA outside any kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gather_rows import gather_rows
from repro_torch.kernels.mp_scatter import mp_scatter


def pad_assignments(token_ids: torch.Tensor, slot: torch.Tensor,
                    own: torch.Tensor, weights: torch.Tensor,
                    num_slots: int, *, edge_tile: int = 128):
    """The routing arrays padded to a multiple of ``edge_tile`` (the
    wrappers' index tile; they raise otherwise, as the reference's do) with
    assignments that are not owned: token 0, the trash slot ``num_slots``,
    weight 0. Returns (token_ids, slot, own, weights)."""
    pad = (-slot.shape[0]) % edge_tile
    if not pad:
        return token_ids, slot, own, weights

    def grow(v, fill):
        return torch.cat([v, torch.full((pad,), fill, dtype=v.dtype,
                                        device=v.device)])
    return (grow(token_ids, 0), grow(slot, num_slots), grow(own, False),
            grow(weights, 0.0))


def moe_dispatch(x: torch.Tensor, token_ids: torch.Tensor,
                 slot: torch.Tensor, own: torch.Tensor, num_slots: int, *,
                 edge_tile: int = 128, num_banks: int = 4) -> torch.Tensor:
    """Build the (num_slots, d) expert buffer from routed tokens (x: (T, d);
    token_ids / slot / own: (T*k,))."""
    msg = x[token_ids.clamp(0, x.shape[0] - 1)]
    return mp_scatter(msg, slot, own, num_slots, edge_tile=edge_tile,
                      num_banks=num_banks)


def moe_combine(y: torch.Tensor, token_ids: torch.Tensor,
                slot: torch.Tensor, own: torch.Tensor, weights: torch.Tensor,
                num_tokens: int, *, edge_tile: int = 128,
                num_banks: int = 4) -> torch.Tensor:
    """out[t] = sum over t's owned assignments of w * y[slot] (float32):
    the banked gather, then the banked scatter-add back to tokens."""
    gathered = gather_rows(y, slot, own, idx_tile=edge_tile,
                           num_banks=num_banks)
    msg = gathered * weights[:, None].to(gathered.dtype)
    return mp_scatter(msg, token_ids, own, num_tokens, edge_tile=edge_tile,
                      num_banks=num_banks)
