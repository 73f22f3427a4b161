"""``layer_fused``'s grid form: its launch rule, its scratch and the
order its buckets give the fold.

``csrc/layer_fused.cu`` has two forms, bitwise equal. The block-local form
sweeps the whole edge stream in every block; the grid form (packed
batches) buckets the owned edges once by tile across a cooperative grid
(``edge_buckets.cuh::bucket_edges_keyed``: count, scan, place by rank
within a warp, warps in no fixed order), then ranks each tile's segment
by (group of lanes, edge index) and folds it. The CPU tests hold the
wrapper's rule and scratch sizes, and a numpy model of that bucketing:
whatever order the warps place their edges in, each row's list is its
owned edges in stream order, which is what makes the fold bitwise. The
``cuda`` tests hold the kernel itself on the card.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import layer_fused as tlf  # noqa: E402

SMS = 132     # an H100's SMs


# ---------------------------------------------------------------------------
# the wrapper's rule and scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,rows,want", [
    (32, 64, None, "block"),          # molhiv bucket
    (64, 1024, None, "block"),        # hep bucket: 64 blocks x 1,024
    (256, 512, None, "block"),        # packed 8: 128 blocks x 512
    (1024, 4096, None, "block"),      # 128 blocks x 4,096: the crossover
    (2048, 4096, None, "block"),      # packed 64: 128 blocks x 4,096
    (2048, 4097, None, "grid"),       # one edge past it
    (4096, 8192, None, "grid"),       # 128 blocks x 8,192
    (32768, 65536, None, "grid"),     # packed 1,024
    (16384, 4000, None, "grid"),      # N > E: 132 blocks x 4,000
    (64, 1024, 16, "block"),          # 4 blocks
    (1024, 4096, 1, "grid"),          # 1,024 blocks x 4,096
    (512, 1024, None, "block"),       # 128 blocks x 1,024
])
def test_launch_form_at_and_around_the_crossover(n, e, rows, want):
    assert tlf.CROSSOVER_READS == 128 * 4096
    assert tlf.launch_form(n, e, rows, SMS) == want


def test_launch_form_counts_blocks_of_the_block_local_grid():
    """ceil(N / rows) blocks (rows: one SM's share, or the caller's) each
    read E edges; the grid form past CROSSOVER_READS of them."""
    for n, e, rows, sms in [(1000, 300, None, 132), (999, 131, 1, 132),
                            (5000, 40, None, 16), (7, 20000, 3, 132)]:
        r = rows or -(-n // sms)
        blocks = -(-n // r)
        want = "grid" if blocks * e > tlf.CROSSOVER_READS else "block"
        assert tlf.launch_form(n, e, rows, sms) == want


@pytest.mark.parametrize("n,e", [(1, 0), (64, 1024), (32768, 65536)])
def test_scratch_sizes(n, e):
    """counts (N), row_start (N + 1) and order (E) for the grid form, keyed
    by tile or by row (both fit); nothing for the block-local form."""
    assert tlf.scratch_ints(n, e, "grid") == 2 * n + 1 + e
    assert tlf.scratch_ints(n, e, "block") == 0


def test_cpu_path_takes_no_form(monkeypatch):
    """On the CPU the wrapper runs the plain version: no form is chosen and
    no scratch allocated."""
    def refuse(*args, **kw):
        raise AssertionError("launch_form consulted on the CPU")
    monkeypatch.setattr(tlf, "launch_form", refuse)
    monkeypatch.setattr(tlf, "scratch_ints", refuse)
    kw, args = _gin_problem(np.random.default_rng(0), 40, 300, 8)
    ours = tlf.layer_fused(*_tensors(args), **_tensors(kw))
    plain = tlf.layer_fused_ref(*_tensors(args), **_tensors(kw))
    assert torch.equal(ours, plain)


# ---------------------------------------------------------------------------
# a numpy model of the grid bucketing and the listing of a tile
# ---------------------------------------------------------------------------

THREADS = 256
WARP = 32


def owned_row(rcv, mask, n):
    """Each edge's row when some row owns it (unmasked, receiver in
    [0, n)), else -1."""
    return np.where(mask & (rcv >= 0) & (rcv < n), rcv, -1)


def model_buckets(rcv, mask, n, per_key, blocks, rng):
    """Phases 0-3 of ``bucket_edges_keyed`` on a grid of ``blocks`` blocks:
    per-key counts, their exclusive scan, then each warp's 32 consecutive
    edges of a round placed by one subtraction per key (the leader's
    atomicSub) and their ranks among the warp's lanes, the warps taking
    their turns in an order drawn from ``rng``. Returns (row_start, order,
    counts after placing)."""
    keys = -(-n // per_key)
    row = owned_row(rcv, mask, n)
    key = np.where(row >= 0, row // per_key, -1)
    counts = np.bincount(key[key >= 0], minlength=keys).astype(np.int64)
    row_start = np.concatenate([[0], np.cumsum(counts)])
    order = np.full(int(row_start[-1]), -1, np.int64)
    stride = blocks * THREADS
    warps = [base + w * WARP for base in range(0, len(rcv), stride)
             for w in range(stride // WARP) if base + w * WARP < len(rcv)]
    left = counts.copy()
    for first in rng.permutation(warps) if warps else []:
        lanes = np.arange(first, min(first + WARP, len(rcv)))
        for k in np.unique(key[lanes]):
            if k < 0:
                continue
            peers = lanes[key[lanes] == k]       # in lane order
            take = len(peers)
            before = left[k]
            left[k] -= take
            for rank, i in enumerate(peers):
                order[row_start[k] + before - take + rank] = i
    return row_start, order, left


def model_listing(rcv, snd, mask, n, d, per_key, rows, groups, cap,
                  row_start, order):
    """Phase B of the grid form: per tile of ``rows`` rows its segment (its
    keys' buckets), each entry placed at the count of entries before it by
    (its row's group of lanes, local row % ``groups``; edge index), each
    group folding its run of places; or, past ``cap`` entries, the stream
    swept in order. Then each listed edge's sender offset (-1: a zero
    row). Returns {row: [edges in the order its group folds them]} and
    {edge: sender offset}."""
    lists, offsets = {}, {}
    row = owned_row(rcv, mask, n)
    for row0 in range(0, n, rows):
        here = min(rows, n - row0)
        k0, k1 = row0 // per_key, -(-(row0 + here) // per_key)
        seg = order[row_start[k0]:row_start[k1]]
        if len(seg) <= cap:
            key = [((rcv[v] - row0) % groups, v) for v in seg]
            listed = np.empty_like(seg)
            for k, v in zip(key, seg):
                listed[sum(j < k for j in key)] = v
            gstart = [sum(k[0] < g for k in key) for g in range(groups + 1)]
            runs = [listed[gstart[g]:gstart[g + 1]] for g in range(groups)]
        else:
            runs = [np.nonzero((row >= row0) & (row < row0 + here))[0]]
        for run in runs:
            for e in run:
                lists.setdefault(int(rcv[e]), []).append(int(e))
                s = int(snd[e])
                offsets[int(e)] = s * d if 0 <= s < n else -1
    return lists, offsets


def check_stream_order(rcv, snd, mask, n, per_key, rows, groups, cap, blocks,
                       seed):
    rng = np.random.default_rng(seed)
    row_start, order, left = model_buckets(rcv, mask, n, per_key, blocks,
                                           rng)
    row = owned_row(rcv, mask, n)
    # every owned edge placed once; the counts end at 0
    assert sorted(order.tolist()) == np.nonzero(row >= 0)[0].tolist()
    assert not left.any()
    d = 5
    lists, offsets = model_listing(rcv, snd, mask, n, d, per_key, rows,
                                   groups, cap, row_start, order)
    for r in range(n):
        want = np.nonzero(row == r)[0].tolist()
        assert lists.get(r, []) == want, f"row {r}"
    assert set(lists) <= set(range(n))
    for e, off in offsets.items():
        s = snd[e]
        assert off == (s * d if 0 <= s < n else -1)


def edge_stream(rng, n, e, *, hub=0.0, empty=0, mask_p=0.8, out_p=0.0):
    """Receivers into the first n - empty rows, a ``hub`` share of them
    into row n // 3, ``out_p`` of receivers and senders outside [0, n)."""
    rcv = rng.integers(0, max(1, n - empty), size=e)
    rcv = np.where(rng.random(e) < hub, n // 3, rcv)
    snd = rng.integers(0, n, size=e)
    for a, past in ((rcv, 12), (snd, 8)):
        pick = rng.random(e) < out_p
        a[pick] = np.where(rng.random(int(pick.sum())) < 0.5,
                           rng.integers(-4, 0, size=int(pick.sum())),
                           rng.integers(n, n + past,
                                        size=int(pick.sum())))
    return rcv.astype(np.int64), snd.astype(np.int64), rng.random(e) < mask_p


@pytest.mark.parametrize("case", ["hub_row", "one_row", "n_gt_e", "no_edges",
                                  "out_of_range", "empty_rows"])
@pytest.mark.parametrize("per_key_is_tile", [True, False])
def test_bucketing_model_keeps_stream_order(case, per_key_is_tile):
    """The named edge cases, keyed by tile and by row, lists past 64
    entries swept."""
    rng = np.random.default_rng(7)
    n, e, kw = {
        "hub_row": (300, 3000, dict(hub=0.7)),
        "one_row": (40, 700, dict(hub=1.0)),
        "n_gt_e": (2000, 150, {}),
        "no_edges": (50, 0, {}),
        "out_of_range": (200, 1200, dict(out_p=0.3)),
        "empty_rows": (300, 900, dict(empty=120)),
    }[case]
    rcv, snd, mask = edge_stream(rng, n, e, **kw)
    rows = 8
    check_stream_order(rcv, snd, mask, n, rows if per_key_is_tile else 1,
                       rows, 2, 64, 3, seed=11)


@settings(max_examples=40)
@given(n=st.integers(1, 400), e=st.integers(0, 1500),
       rows=st.integers(1, 16), tile_keys=st.booleans(),
       groups=st.integers(1, 8),
       cap=st.sampled_from([4, 32, 1024]), blocks=st.integers(1, 6),
       hub=st.floats(0.0, 0.9), empty=st.integers(0, 50),
       mask_p=st.floats(0.2, 1.0), out_p=st.floats(0.0, 0.3),
       seed=st.integers(0, 2 ** 31 - 1))
def test_bucketing_model_property(n, e, rows, tile_keys, groups, cap,
                                  blocks, hub, empty, mask_p, out_p, seed):
    """Any warp order, key width, groups of lanes, list capacity and grid:
    each row's list is its owned edges in stream order, hub rows, empty
    rows, masked edges and indices outside [0, n) included."""
    rng = np.random.default_rng(seed)
    rcv, snd, mask = edge_stream(rng, n, e, hub=hub, empty=min(empty, n - 1),
                                 mask_p=mask_p, out_p=out_p)
    check_stream_order(rcv, snd, mask, n, rows if tile_keys else 1, rows,
                       groups, cap, blocks, seed)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def _glorot(r, d_in, d_out):
    return (r.normal(size=(d_in, d_out)) * np.sqrt(2.0 / (d_in + d_out))
            ).astype(np.float32)


def _stream(r, n, e, d, empty_tail=16):
    x = r.normal(size=(n, d)).astype(np.float32)
    snd = r.integers(0, n, size=e).astype(np.int64)
    rcv = r.integers(0, max(1, n - empty_tail), size=e).astype(np.int64)
    mask = r.random(e) < 0.8
    return x, snd, rcv, mask


def _gin_problem(r, n, e, d, d_ff=None):
    """GIN's self form: edge term, relu phi, scalar self term, two layers."""
    d_ff = d_ff or 2 * d
    x, snd, rcv, mask = _stream(r, n, e, d)
    kw = {"edge_term": r.normal(size=(e, d)).astype(np.float32),
          "phi_activation": "relu",
          "self_coeff": np.array([1.1], np.float32),
          "w1": _glorot(r, d, d_ff),
          "b1": (0.1 * r.normal(size=(d_ff,))).astype(np.float32),
          "w2": _glorot(r, d_ff, d),
          "b2": (0.1 * r.normal(size=(d,))).astype(np.float32)}
    return kw, (x, snd, rcv, mask, n)


def _degrees(rcv, mask, n):
    own = mask & (rcv >= 0) & (rcv < n)
    return np.bincount(rcv[own], minlength=n).astype(np.float32)


def _pna_problem(r, n, e, d):
    """PNA's scalers form: node input, edge term, bias, three scalers, w1
    13d -> d (1040 x 80 at d = 80: the weight ring)."""
    x, snd, rcv, mask = _stream(r, n, e, d)
    deg = _degrees(rcv, mask, n)
    log_deg = np.log(deg + 1.0)
    kw = {"node_input": r.normal(size=(n, d)).astype(np.float32),
          "edge_term": r.normal(size=(e, d)).astype(np.float32),
          "phi_bias": r.normal(size=(d,)).astype(np.float32),
          "phi_activation": "relu", "degrees": deg,
          "scalers": np.stack([np.ones_like(log_deg), log_deg / 1.3,
                               1.3 / np.maximum(log_deg, 1e-3)],
                              axis=-1).astype(np.float32),
          "w1": _glorot(r, 13 * d, d),
          "b1": (0.1 * r.normal(size=(d,))).astype(np.float32),
          "out_activation": "relu"}
    return kw, (x, snd, rcv, mask, n)


def _dgn_problem(r, n, e, d):
    """DGN's field form: the stacked [x | x] buffer, a full [1 | w]
    src_weight, its sums, w1 3d -> d."""
    x, snd, rcv, mask = _stream(r, n, e, d)
    w = r.normal(size=(e,)).astype(np.float32)
    wsum = np.zeros(n, np.float32)
    own = mask & (rcv >= 0) & (rcv < n)
    np.add.at(wsum, rcv[own], w[own])
    kw = {"node_input": np.concatenate([x, x], axis=-1),
          "src_weight": np.concatenate(
              [np.ones((e, d), np.float32),
               np.repeat(w[:, None], d, axis=1)], axis=-1),
          "degrees": _degrees(rcv, mask, n), "field_wsum": wsum,
          "w1": _glorot(r, 3 * d, d),
          "b1": (0.1 * r.normal(size=(d,))).astype(np.float32),
          "out_activation": "relu"}
    return kw, (x, snd, rcv, mask, n)


PROBLEMS = {"gin": (_gin_problem, 100), "pna": (_pna_problem, 80),
            "dgn": (_dgn_problem, 100)}


def _tensors(v, device="cpu"):
    if isinstance(v, dict):
        return {k: _tensors(a, device) for k, a in v.items()}
    if isinstance(v, tuple):
        return tuple(_tensors(a, device) for a in v)
    return torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v


def _on_card(form, n, e, seed=0):
    r = np.random.default_rng(seed)
    make, d = PROBLEMS[form]
    kw, args = make(r, n, e, d)
    return _tensors(args, "cuda"), _tensors(kw, "cuda")


def _run(args, kw, form=None, **extra):
    old = tlf._force_form
    tlf._force_form = form
    try:
        return tlf.layer_fused(*args, **kw, **extra)
    finally:
        tlf._force_form = old


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gin", "pna", "dgn"])
@pytest.mark.parametrize("n,e", [(64, 1024), (1024, 4096), (997, 3001),
                                 (4096, 8192)])
def test_cuda_grid_form_is_bitwise_the_block_local_form(form, n, e):
    """Both forms at shapes where each runs, at the kernel's own rows per
    block and at 1, 3, 8, 16: all bitwise equal."""
    _card()
    args, kw = _on_card(form, n, e)
    outs = [_run(args, kw, f, rows_per_block=rows)
            for f in ("block", "grid") for rows in (None, 1, 3, 8, 16)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gin", "pna", "dgn"])
def test_cuda_both_forms_match_the_plain_version_at_n32768(form):
    """GIN's packed bucket of 1,024 graphs (N=32,768, E=65,536) in each
    epilogue: both forms within 1e-4 of the plain version's scale (fp32
    sums in another order), and bitwise equal to each other."""
    _card()
    args, kw = _on_card(form, 32768, 65536)
    grid = _run(args, kw, "grid")
    block = _run(args, kw, "block")
    plain = tlf.layer_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    assert tlf.launch_form(32768, 65536, None,
                           tlf._sm_count(torch.cuda.current_device())) == "grid"
    scale = max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(grid, plain, atol=1e-4 * scale, rtol=1e-4)
    assert torch.equal(grid, block)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gin", "pna"])
def test_cuda_grid_form_replays_bitwise_from_a_cuda_graph(form):
    """One grid-form layer (its scratch from the graph's pool; PNA's ring
    restaged a tile) captured and replayed: bitwise the eager call."""
    _card()
    args, kw = _on_card(form, 2048, 4096)
    eager = _run(args, kw, "grid")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run(args, kw, "grid")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _run(args, kw, "grid")
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_cuda_grid_form_raises_when_the_grid_cannot_be_resident(monkeypatch):
    """More blocks than the card holds at once: the cooperative launch is
    refused, the wrapper raises and counts no launch, and no other form
    runs in its place; the next launch works."""
    _card()
    args, kw = _on_card("gin", 2048, 4096)
    before = tlf.layer_fused.launches
    monkeypatch.setattr(tlf, "_force_grid", 1 << 20)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(args, kw, "grid")
    assert tlf.layer_fused.launches == before
    monkeypatch.setattr(tlf, "_force_grid", 0)
    out = _run(args, kw, "grid")
    torch.cuda.synchronize()
    assert tlf.layer_fused.launches == before + 1
    assert bool(torch.isfinite(out).all())
