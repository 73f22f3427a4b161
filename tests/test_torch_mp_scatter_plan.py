"""``mp_scatter``'s two forms: the wrapper's rule, its scratch, and a numpy
model of who folds what, in which order.

``csrc/mp_scatter.cu`` launches in one of two forms, bitwise equal. The
block form (an ordinary launch) buckets each block's rows stably in shared
memory and folds every row, one chunk of 512 bytes of its columns a block,
through a ring of asynchronous copies (``csrc/long_rows.cuh``). The grid
form (cooperative) buckets every edge by row between grid barriers, warps
placing their runs in no fixed order; warps fold the short rows from a
register sort of their segment, and the grid's blocks fold the long ones,
(row, chunk) units, each sorting its segment alone by a bitmap of its edge
indices. The CPU tests hold the wrapper's rule and scratch sizes, and a
numpy model of both forms: whatever order the warps placed their edges in,
every (row, column) is folded by exactly one thread, over that row's owned
edges in stream order, and no row longer than the warp's sort is folded by
a warp. The ``cuda`` tests in ``test_torch_mp_scatter.py`` hold the kernel
itself on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mp_scatter as tms  # noqa: E402

SMS = 132         # an H100's SMs
THREADS = 256
WARP = 32
CHUNK_BYTES = 512                   # a block form's chunk of a row
SPLIT_CHUNK, SPLIT_LEN = 128, 1024  # a grid form long row's units past it
STAGE_BYTES = 16384                 # a slot of the ring
WINDOW = 1 << 16
LIST = 2048
F32, BF16 = torch.float32, torch.bfloat16


# ---------------------------------------------------------------------------
# the wrapper's rule and scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,d,dtype,rows,want", [
    (32, 64, 100, F32, None, "block"),         # molhiv bucket
    (64, 1024, 100, F32, None, "block"),       # hep: 64 blocks x 1,024
    (64, 1024, 200, F32, None, "block"),       # DGN hep: 2 chunks a row
    (256, 512, 64, F32, None, "block"),        # GAT packed 8
    (1024, 4096, 100, F32, None, "block"),     # 128 blocks x 4,096
    (2048, 4096, 64, F32, None, "block"),      # GAT packed 64: the same
    (2048, 4097, 64, F32, None, "grid"),       # past one stable bucketing
    (8192, 1000, 100, F32, None, "block"),     # N > E: 131 blocks x 1,000
    (512, 128, 2048, BF16, None, "block"),     # olmoe decode dispatch
    (2, 128, 2048, F32, None, "block"),        # decode combine: 32 blocks
    (10240, 8192, 2048, BF16, None, "grid"),   # MoE dispatch
    (1024, 4096, 100, F32, 1, "block"),        # 1,024 blocks x 4,096: 2^22
    (2048, 4096, 64, F32, 3, "block"),         # 683 x 4,096 (measured)
    (2048, 4096, 64, F32, 1, "grid"),          # 2^23 reads (measured)
    (64, 1024, 100, F32, 16, "block"),         # 4 blocks
    (4096, 4096, 100, F32, 2048, "grid"),      # rows past LOCAL_ROWS
])
def test_launch_form_at_and_around_the_crossover(n, e, d, dtype, rows, want):
    assert tms.launch_form(n, e, d, dtype, False, rows, SMS) == want
    assert tms.launch_form(n, e, d, dtype, True, rows, SMS) == want


def test_launch_form_counts_the_block_forms_reads():
    """ceil(N / rows) blocks of rows (rows: the caller's, or two blocks an
    SM counting a row's chunks) times the chunks of a row, each reading E
    edges; the grid form past CROSSOVER_READS of them, past LOCAL_EDGES
    edges or past LOCAL_ROWS rows a block."""
    r = np.random.default_rng(0)
    for _ in range(300):
        n = int(r.integers(1, 20000))
        e = int(r.integers(0, 6000))
        d = int(r.integers(1, 3000))
        dtype = (F32, BF16)[int(r.integers(2))]
        rows = None if r.random() < 0.5 else int(r.integers(1, 1500))
        sms = int(r.integers(1, 200))
        item = 2 if dtype == BF16 else 4
        chunks = -(-d * item // CHUNK_BYTES)
        rb = rows or max(1, -(-n * chunks // (2 * sms)))
        blocks = -(-n // rb) * chunks
        want = ("grid" if e > tms.LOCAL_EDGES or rb > tms.LOCAL_ROWS
                or blocks * e > tms.CROSSOVER_READS else "block")
        assert tms.launch_form(n, e, d, dtype, False, rows, sms) == want


@pytest.mark.parametrize("n,e", [(1, 0), (64, 1024), (10240, 8192),
                                 (509, 65536)])
def test_scratch_sizes(n, e):
    """counts (N), row_start (N + 1), order (E), the long rows' two counts
    and up to E / 32 + 1 (row, start, length) triples for the grid form;
    nothing for the block."""
    assert tms.scratch_ints(n, e, "grid") == (2 * n + 1 + e + 2
                                              + 3 * (e // 32 + 1))
    assert tms.scratch_ints(n, e, "block") == 0
    # no row can be long past that many: a long row has > 32 edges
    assert e // 33 <= e // 32 + 1


def test_cpu_path_takes_no_form(monkeypatch):
    """On the CPU the wrappers run the plain versions: no form is chosen and
    no scratch allocated."""
    def refuse(*args, **kw):
        raise AssertionError("launch_form consulted on the CPU")
    monkeypatch.setattr(tms, "launch_form", refuse)
    monkeypatch.setattr(tms, "scratch_ints", refuse)
    r = np.random.default_rng(1)
    msg = torch.from_numpy(r.normal(size=(300, 8)).astype(np.float32))
    rcv = torch.from_numpy(r.integers(0, 40, 300).astype(np.int64))
    mask = torch.from_numpy(r.random(300) < 0.8)
    assert torch.equal(tms.mp_scatter(msg, rcv, mask, 40),
                       tms.mp_scatter_ref(msg, rcv, mask, 40))
    multi = tms.mp_scatter_multi(msg, rcv, mask, 40, stats=("sum", "max"))
    assert torch.equal(multi["max"], tms.mp_scatter_multi_ref(
        msg, rcv, mask, 40, ("max",))["max"])


# ---------------------------------------------------------------------------
# a numpy model of both forms
# ---------------------------------------------------------------------------

def owned_row(rcv, mask, n):
    """Each edge's row when some row owns it (unmasked, receiver in
    [0, n)), else -1."""
    return np.where(mask & (rcv >= 0) & (rcv < n), rcv, -1)


def short_limit(d, itemsize, multi):
    """The grid form's warp sort: 128 edges in the one-slice kernels (the
    multi sweep, or a row of at most 32 lanes x 16 bytes), 32 in the wide
    ones (kShort<S>)."""
    one_slice = multi or d * itemsize <= WARP * 16
    return 128 if one_slice else 32


def grid_place(row, n, blocks, rng):
    """``bucket_edges``' phases 1-3: counts, their scan, then each warp's 32
    consecutive edges of a round placed as one run per row by the leader's
    atomicSub, the warps in an order drawn from ``rng``. Returns
    (row_start, order)."""
    counts = np.bincount(row[row >= 0], minlength=n)
    row_start = np.concatenate([[0], np.cumsum(counts)])
    order = np.full(int(row_start[-1]), -1, np.int64)
    left = counts.copy()
    stride = blocks * THREADS
    e = len(row)
    warps = [base + w * WARP for base in range(0, e, stride)
             for w in range(stride // WARP) if base + w * WARP < e]
    for first in (rng.permutation(warps) if warps else []):
        lanes = np.arange(first, min(first + WARP, e))
        for q in np.unique(row[lanes]):
            if q < 0:
                continue
            run = lanes[row[lanes] == q]
            left[q] -= len(run)
            order[row_start[q] + left[q]:row_start[q] + left[q] + len(run)] \
                = run
    assert (left == 0).all() and (order >= 0).all()
    return row_start, order


def sorted_segment(seg, e, window=WINDOW, batch=LIST):
    """``long_rows.cuh::sorted_segment``: for each window of indices the
    bitmap's words, each thread's consecutive words counted and scanned,
    each thread listing its words' set bits at its places, ``batch`` places
    at a time. Returns the batches' concatenation."""
    out = []
    for w0 in range(0, e, window):
        span = min(window, e - w0)
        words = -(-span // 32)
        bitmap = np.zeros(words, np.uint64)
        rel = seg[(seg >= w0) & (seg < w0 + span)] - w0
        for v in rel:
            bitmap[v >> 5] |= np.uint64(1) << np.uint64(v & 31)
        per = -(-words // THREADS)
        mine = []
        for t in range(THREADS):
            lo = min(words, t * per)
            hi = min(words, lo + per)
            mine.append([(k, int(bitmap[k])) for k in range(lo, hi)])
        counts = [sum(bin(b).count("1") for _, b in m) for m in mine]
        base = np.concatenate([[0], np.cumsum(counts)])
        total = int(base[-1])
        for p0 in range(0, total, batch):
            listed = np.full(min(batch, total - p0), -1, np.int64)
            for t in range(THREADS):
                at = int(base[t])
                if not (at < p0 + batch and at + counts[t] > p0):
                    continue
                for k, bits in mine[t]:
                    for bit in range(32):
                        if bits >> bit & 1:
                            if p0 <= at < p0 + batch:
                                listed[at - p0] = w0 + (k << 5) + bit
                            at += 1
            assert (listed >= 0).all()
            out.append(listed)
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def per_stage(cw, itemsize):
    """Entries a stage of the ring holds: chunks of cw elements at a stride
    of their bytes rounded up to 16 (``long_rows::slot_of``)."""
    return STAGE_BYTES // (-(-cw * itemsize // 16) * 16)


def ring_stages(total, stage):
    """The ring's stages: [j0, j0 + cnt) in order (``long_rows::stream``)."""
    return [(j0, min(stage, total - j0)) for j0 in range(0, total, stage)]


def chunk_owners(c0, cw, d, itemsize):
    """{column: owner thread} of a chunk: thread w owns the 4-byte word w
    (4 // itemsize columns) while its first column is in the chunk."""
    per = 4 // itemsize
    return {c: (c - c0) // per for c in range(c0, min(c0 + cw, d))}


class Folds:
    """Per row, the pieces of its columns and who folded each: (columns,
    who, the edges in the order they were folded there). Within a piece
    each column has one owner thread (``chunk_owners``)."""

    def __init__(self):
        self.rows = {}

    def fold(self, who, row, cols, edges):
        self.rows.setdefault(row, []).append(
            (list(cols), who, [int(v) for v in edges]))

    def by(self, row):
        """{column: who} of a row, each column folded by one piece."""
        out = {}
        for cols, who, _ in self.rows.get(row, []):
            for c in cols:
                assert c not in out, f"({row}, {c}) folded twice"
                out[c] = who
        return out


def model_block(rcv, mask, n, d, itemsize, rows):
    """The block form: block (x, y) owns rows [x * rows, ...) and chunk y;
    ``bucket_edges_stable`` lists each of its rows' owned edges in stream
    order; the ring streams the rows' segments one after another and each
    owner folds its columns, row by row."""
    row = owned_row(rcv, mask, n)
    cols = CHUNK_BYTES // itemsize
    folds = Folds()
    for x in range(-(-n // rows)):
        row0, hi = x * rows, min(n, (x + 1) * rows)
        segs = [np.flatnonzero(row == q) for q in range(row0, hi)]
        order = np.concatenate(segs) if segs else np.zeros(0, np.int64)
        starts = np.concatenate([[0], np.cumsum([len(s) for s in segs])])
        for y in range(-(-d // cols)):
            c0 = y * cols
            cw = min(cols, d - c0)
            owners = chunk_owners(c0, cw, d, itemsize)
            # every entry the ring delivers, stage by stage, in order
            delivered = np.concatenate(
                [order[j0:j0 + cnt] for j0, cnt in
                 ring_stages(len(order), per_stage(cw, itemsize))]
                or [np.zeros(0, np.int64)])
            assert all(0 <= w < 128 for w in owners.values())   # owners
            for q in range(hi - row0):
                folds.fold(("block", x, y), row0 + q, owners,
                           delivered[starts[q]:starts[q + 1]])
    return folds


def model_grid(rcv, mask, n, d, itemsize, multi, blocks, rng, *,
               window=WINDOW, batch=LIST):
    """The grid form: placement with racing warps; rows up to the warp's
    sort folded by one warp from the sorted segment (lanes owning columns,
    S slices of 16 bytes a lane); longer rows listed by phase 2 and folded
    as (row, chunk) units by blocks drawn from ``rng``, each owner over the
    bitmap-sorted segment streamed through the ring."""
    row = owned_row(rcv, mask, n)
    row_start, order = grid_place(row, n, blocks, rng)
    limit = short_limit(d, itemsize, multi)
    lens = np.diff(row_start)
    long_rows = [q for q in range(n) if lens[q] > limit]
    folds = Folds()
    warp_cols = WARP * (16 // itemsize) * (1 if limit == 128 else 4)
    for q in range(n):
        if lens[q] > limit:
            continue
        seg = np.sort(order[row_start[q]:row_start[q + 1]])
        for s0 in range(0, d, warp_cols):
            folds.fold(("warp", q, s0), q, range(s0, min(d, s0 + warp_cols)),
                       seg)
    def chunk_cols(q):
        return (SPLIT_CHUNK if lens[q] >= SPLIT_LEN else CHUNK_BYTES) \
            // itemsize
    # phase 2 lists the long rows in no fixed order; any block takes a unit
    units = [(q, y) for q in rng.permutation(long_rows)
             for y in range(-(-d // chunk_cols(q)))]
    for u, (q, y) in enumerate(units):
        cols = chunk_cols(q)
        seg = order[row_start[q]:row_start[q + 1]]
        c0 = y * cols
        cw = min(cols, d - c0)
        whole = sorted_segment(seg, len(rcv), window, batch)
        listed = np.concatenate(
            [whole[j0:j0 + cnt]
             for j0, cnt in ring_stages(len(seg), per_stage(cw, itemsize))]
            or [np.zeros(0, np.int64)])
        folds.fold(("unit", u), int(q), chunk_owners(c0, cw, d, itemsize),
                   listed)
    return folds, [int(q) for q in long_rows], lens


def assert_stream_order(folds, rcv, mask, n, d):
    """Every (row, column) of [0, n) x [0, d) folded by one thread over the
    row's owned edges in stream order (an empty row: no edge, still
    written by its owner)."""
    row = owned_row(rcv, mask, n)
    order = np.argsort(row, kind="stable")
    bounds = np.searchsorted(row[order], np.arange(n + 1))
    for q in range(n):
        want = order[bounds[q]:bounds[q + 1]].tolist()
        assert sorted(folds.by(q)) == list(range(d)), f"row {q}'s columns"
        for _, _, edges in folds.rows[q]:
            assert edges == want, f"row {q} out of stream order"


def case(name, seed=0):
    """(receivers, mask, n, d, itemsize): the owner buckets' edge cases."""
    r = np.random.default_rng(seed)
    if name == "hub":
        e, n = 4096, 256
        rcv = r.integers(0, n, e)
        rcv[r.choice(e, 2500, replace=False)] = n // 3
        return rcv, np.ones(e, bool), n, 100, 4
    if name == "one_row":
        return np.full(2048, 7), r.random(2048) < 0.8, 64, 24, 4
    if name == "n_gt_e":
        return r.integers(0, 3000, 300), r.random(300) < 0.8, 3000, 16, 4
    if name == "out_of_range":
        return (r.integers(-4, 76, 3000), r.random(3000) < 0.8, 64, 40, 4)
    if name == "rows_of_129":
        e = 129 * 40 + 7
        return ((np.arange(e) // 129)[r.permutation(e)], np.ones(e, bool),
                41, 100, 4)
    if name == "rows_of_33_bf16_wide":
        e = 33 * 30
        return ((np.arange(e) // 33)[r.permutation(e)], np.ones(e, bool),
                30, 600, 2)
    if name == "bf16_odd_width":
        e = 900
        rcv = r.integers(0, 20, e)
        rcv[:300] = 3
        return rcv, r.random(e) < 0.9, 20, 261, 2
    assert name == "random"
    e = int(r.integers(500, 3000))
    n = int(r.integers(1, 300))
    rcv = r.integers(-3, n + 3, e)
    rcv[r.random(e) < 0.3] = int(r.integers(0, n))
    return rcv, r.random(e) < 0.85, n, int(r.integers(1, 300)), 4


CASES = ["hub", "one_row", "n_gt_e", "out_of_range", "rows_of_129",
         "rows_of_33_bf16_wide", "bf16_odd_width", "random"]


@pytest.mark.parametrize("name", CASES)
def test_block_form_folds_each_column_once_in_stream_order(name):
    rcv, mask, n, d, item = case(name)
    for rows in (1, 3, 16):
        folds = model_block(rcv, mask, n, d, item, rows)
        assert_stream_order(folds, rcv, mask, n, d)


@pytest.mark.parametrize("name", CASES)
def test_grid_form_folds_each_column_once_in_stream_order(name):
    """Whatever order the warps placed their runs in, and whichever blocks
    take the long rows' units: each (row, column) by one thread, in stream
    order; rows past the warp's sort are units, never a warp's."""
    rcv, mask, n, d, item = case(name)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        for multi in (False, True):
            folds, long_rows, lens = model_grid(rcv, mask, n, d, item, multi,
                                                3, rng)
            assert_stream_order(folds, rcv, mask, n, d)
            limit = short_limit(d, item, multi)
            for q in range(n):
                if lens[q] > limit:
                    assert {w[0] for w in folds.by(q).values()} == {"unit"}
            assert sorted(long_rows) == [q for q in range(n)
                                         if lens[q] > limit]


def test_long_rows_are_units_in_their_shapes():
    """The hub, the one row and the rows of 129 hold rows longer than the
    warp's sort: they are the ones phase 5 takes."""
    for name, want in (("hub", [256 // 3]), ("one_row", [7]),
                       ("rows_of_129", list(range(40)))):
        rcv, mask, n, d, item = case(name)
        _, long_rows, _ = model_grid(rcv, mask, n, d, item, False, 2,
                                     np.random.default_rng(0))
        assert sorted(long_rows) == want


@pytest.mark.parametrize("window,batch", [(64, 8), (96, 5), (WINDOW, LIST)])
def test_sorted_segment_lists_any_placement_in_order(window, batch):
    """The bitmap sort across several windows and list batches: a random
    segment of distinct indices comes out ascending, whole."""
    r = np.random.default_rng(window + batch)
    for e in (1, 33, 700, 5000):
        seg = r.choice(e, size=int(r.integers(0, e + 1)), replace=False)
        got = sorted_segment(seg, e, window, batch)
        assert got.tolist() == sorted(seg.tolist())


@pytest.mark.parametrize("cw,itemsize", [(100, 4), (256, 2), (32, 4),
                                         (4, 4), (63, 2)])
def test_ring_delivers_every_entry_once_in_order(cw, itemsize):
    stage = per_stage(cw, itemsize)
    assert stage * -(-cw * itemsize // 16) * 16 <= STAGE_BYTES
    for total in (0, 1, 15, 16, 17, 33, 129, 5000):
        got = [j for j0, cnt in ring_stages(total, stage)
               for j in range(j0, j0 + cnt)]
        assert got == list(range(total))
