"""The port's ``mp_pipeline`` against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel run in interpret mode and against the JAX
oracle ``mp_pipeline_ref``, on the same numpy-seeded inputs, at the
reference's own kernel tolerance: atol = rtol = 2e-5. The attention sums
agree to that tolerance only (the Pallas kernel rescales online, both
oracles normalise after a two-pass sum). The CUDA kernel is held against
the plain version in a test that needs the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mp_pipeline as tmp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ALL_STATS = tmp.MULTI_STATS
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _problem(e=200, d=8, n=30, seed=0, mask_p=0.8, heads=0):
    """Numpy inputs; the last four destinations receive no edge."""
    r = np.random.default_rng(seed)
    p = {"x": r.normal(size=(n, d)).astype(np.float32),
         "senders": r.integers(0, n, size=e).astype(np.int32),
         "receivers": r.integers(0, max(n - 4, 1), size=e).astype(np.int32),
         "edge_mask": r.random(e) < mask_p}
    if heads:
        p["att_src"] = r.normal(size=(n, heads)).astype(np.float32)
        p["att_dst"] = r.normal(size=(n, heads)).astype(np.float32)
    return p, r


def _phi(r, e, d, *, sw=None, edge_term=False, bias=False, relu=False):
    kw = {"activation": "relu" if relu else "none"}
    if sw == "scalar":
        kw["src_weight"] = r.normal(size=(e,)).astype(np.float32)
    elif sw == "full":
        kw["src_weight"] = r.normal(size=(e, d)).astype(np.float32)
    elif sw == "head":
        kw["src_weight"] = r.normal(size=(e, 4)).astype(np.float32)
    if edge_term:
        kw["edge_term"] = r.normal(size=(e, d)).astype(np.float32)
    if bias:
        kw["bias"] = r.normal(size=(d,)).astype(np.float32)
    return kw


def _port(p, kw, stats, fn=tops.mp_pipeline, device="cpu", **extra):
    t = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
             else v) for k, v in {**p, **kw}.items()}
    args = [t.pop(k) for k in ("x", "senders", "receivers", "edge_mask")]
    args[1], args[2] = args[1].long(), args[2].long()
    n = p["x"].shape[0]
    if fn is tmp.mp_pipeline_ref:
        return fn(*args, n, stats, **t)
    return fn(*args, n, stats=stats, **t, **extra)


def _jax(jops, p, kw, stats, **tiles):
    """The JAX interpret-mode kernel's and oracle's outputs (numpy)."""
    import jax.numpy as jnp
    t = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in {**p, **kw}.items()}
    args = [t.pop(k) for k in ("x", "senders", "receivers", "edge_mask")]
    n = p["x"].shape[0]
    kern = jops.mp_pipeline(*args, n, stats=stats, **t, **tiles)
    ref = jops.mp_pipeline_ref(*args, n, stats, **t)
    return ({k: np.asarray(v) for k, v in kern.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def _check(ours, kern, ref):
    assert set(ours) == set(kern) == set(ref)
    for name, v in ours.items():
        np.testing.assert_allclose(v.numpy(), kern[name], err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(v.numpy(), ref[name], err_msg=name, **TOL)


@pytest.mark.parametrize("e,d,n,edge_tile,banks", [
    (128, 16, 32, 32, 2),
    (200, 8, 30, 64, 4),         # uneven: E % tile != 0, N % banks != 0
    (96, 24, 17, 32, 5),         # uneven bank sizes
])
def test_all_stats_match_reference(jops, e, d, n, edge_tile, banks):
    p, r = _problem(e, d, n, seed=e + n)
    kw = _phi(r, e, d, sw="scalar", edge_term=True, relu=True)
    ours = _port(p, kw, ALL_STATS)
    kern, ref = _jax(jops, p, kw, ALL_STATS, edge_tile=edge_tile,
                     num_banks=banks)
    _check(ours, kern, ref)
    assert tuple(ours) == ALL_STATS
    assert ours["count"].shape == (n, 1)


@pytest.mark.parametrize("phi", [
    dict(),
    dict(edge_term=True, relu=True),
    dict(sw="scalar"),
    dict(sw="full"),
    dict(sw="head"),
    dict(sw="scalar", edge_term=True, bias=True, relu=True),
])
def test_phi_forms_match_reference(jops, phi):
    e, d, n = 128, 8, 24
    p, r = _problem(e, d, n, seed=5)
    kw = _phi(r, e, d, **phi)
    ours = _port(p, kw, ALL_STATS)
    kern, ref = _jax(jops, p, kw, ALL_STATS, edge_tile=32, num_banks=4)
    _check(ours, kern, ref)


@pytest.mark.parametrize("e,d,n,heads,stats", [
    (128, 16, 32, 4, ("sum",)),
    (200, 8, 30, 2, ("sum", "count")),   # uneven E and N
    (96, 24, 17, 3, ("count", "sum")),   # odd head count; order given
])
def test_attention_matches_reference(jops, e, d, n, heads, stats):
    p, _ = _problem(e, d, n, seed=e, heads=heads)
    ours = _port(p, {}, stats)
    kern, ref = _jax(jops, p, {}, stats, edge_tile=32, num_banks=4)
    _check(ours, kern, ref)
    want = tuple(s for s in ALL_STATS if s in stats) + tmp.ATT_STATS
    assert tuple(ours) == want
    assert ours["att_max"].shape == ours["att_denom"].shape == (n, heads)


# Indices outside [0, N) (ROADMAP queue 3's faults 1 and 2): the streams each
# case redraws, and how far past N each stream's bad indices reach.
OUT_OF_RANGE = {"receivers": ("receivers",), "senders": ("senders",),
                "both": ("receivers", "senders")}
PAST_N = {"receivers": 12, "senders": 8}


def out_of_range(p, r, case):
    """Point a quarter of the edges of ``p`` outside [0, N) in each stream
    the case names: half of them at [-4, 0), half at [N, N + PAST_N)."""
    n = p["x"].shape[0]
    e = p["senders"].shape[0]
    for stream in OUT_OF_RANGE[case]:
        pick = r.random(e) < 0.25
        draw = np.where(r.random(e) < 0.5, r.integers(-4, 0, size=e),
                        r.integers(n, n + PAST_N[stream], size=e))
        p[stream] = np.where(pick, draw, p[stream]).astype(np.int32)


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("case", sorted(OUT_OF_RANGE))
def test_out_of_range_indices_follow_the_kernel(jops, case, attention):
    """An edge whose receiver lies outside [0, N) adds nothing; one whose
    sender does gathers a zero row and still counts (its attention source
    half is 0), as the interpret-mode Pallas kernel gives. Its oracle wraps
    or clips senders, so the port holds to the kernel alone."""
    e, d, n = 160, 8, 32
    p, r = _problem(e, d, n, seed=5, heads=2 if attention else 0)
    out_of_range(p, r, case)
    if attention:
        kw, stats = {}, ("sum", "count")
    else:
        kw, stats = _phi(r, e, d, edge_term=True, bias=True, relu=True), \
            ALL_STATS
    ours = _port(p, kw, stats)
    kern, _ = _jax(jops, p, kw, stats, edge_tile=32, num_banks=4)
    assert set(ours) == set(kern)
    for name, v in ours.items():
        np.testing.assert_allclose(v.numpy(), kern[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_tile_keywords_are_accepted_and_change_nothing():
    """``ops.mp_pipeline`` takes the reference's ``edge_tile`` and
    ``num_banks``; they describe the TPU grid and change nothing here."""
    p, r = _problem(200, 8, 30, seed=4)
    kw = _phi(r, 200, 8, sw="scalar", edge_term=True, relu=True)
    a = _port(p, kw, ALL_STATS)
    b = _port(p, kw, ALL_STATS, edge_tile=64, num_banks=2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_empty_destinations_are_exact():
    """Rows no unmasked edge reaches: sum, sumsq and count 0, max -BIG,
    min +BIG; with attention sum 0, att_max -BIG, att_denom 0. Node 0 is
    reached only by masked edges, as padding is."""
    e, d, n = 64, 8, 16
    p, r = _problem(e, d, n, seed=1)
    p["edge_mask"][p["receivers"] == 0] = False
    kw = _phi(r, e, d, sw="full", edge_term=True, bias=True)
    big = np.float32(tmp.BIG)
    empty = [0, n - 4, n - 3, n - 2, n - 1]
    out = _port(p, kw, ALL_STATS)
    for name, want in (("sum", 0.0), ("sumsq", 0.0), ("count", 0.0),
                       ("max", -big), ("min", big)):
        assert (out[name][empty].numpy() == want).all(), name
    assert (out["count"].numpy()[5:n - 4] > 0).any()
    pa, _ = _problem(e, d, n, seed=1, heads=2)
    pa["edge_mask"][pa["receivers"] == 0] = False
    att = _port(pa, {}, ("sum",))
    assert (att["sum"][empty].numpy() == 0.0).all()
    assert (att["att_max"][empty].numpy() == -big).all()
    assert (att["att_denom"][empty].numpy() == 0.0).all()
    assert np.isfinite(att["sum"].numpy()).all()


def test_extreme_logits_stay_finite(jops):
    """Logits of +-1e4: the softmax must neither overflow nor give 0/0."""
    p, _ = _problem(160, 16, 24, seed=3, heads=4)
    p["att_src"] = p["att_src"] * np.float32(1e4)
    p["att_dst"] = p["att_dst"] * np.float32(1e4)
    ours = _port(p, {}, ("sum",))
    kern, ref = _jax(jops, p, {}, ("sum",), edge_tile=32, num_banks=4)
    assert all(np.isfinite(v.numpy()).all() for v in ours.values())
    np.testing.assert_allclose(ours["sum"].numpy(), ref["sum"], **TOL)
    np.testing.assert_allclose(ours["sum"].numpy(), kern["sum"], **TOL)


def test_edge_permutation_invariance():
    p, r = _problem(128, 8, 32, seed=2, heads=2)
    perm = np.random.default_rng(2).permutation(128)
    q = dict(p, senders=p["senders"][perm], receivers=p["receivers"][perm],
             edge_mask=p["edge_mask"][perm])
    a, b = _port(p, {}, ("sum", "count")), _port(q, {}, ("sum", "count"))
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    del p["att_src"], p["att_dst"], q["att_src"], q["att_dst"]
    a, b = _port(p, {}, ALL_STATS), _port(q, {}, ALL_STATS)
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_mp_pipeline_rejects_bad_input():
    p, _ = _problem(heads=2)
    x, snd, rcv, mask = (torch.from_numpy(p[k]) for k in
                         ("x", "senders", "receivers", "edge_mask"))
    snd, rcv = snd.long(), rcv.long()
    a_s, a_d = torch.from_numpy(p["att_src"]), torch.from_numpy(p["att_dst"])
    f = tops.mp_pipeline
    with pytest.raises(ValueError):                  # no statistic
        f(x, snd, rcv, mask, 30, stats=())
    with pytest.raises(ValueError):
        f(x, snd, rcv, mask, 30, stats=("sum",), activation="gelu")
    with pytest.raises(ValueError):                  # wrong node count
        f(x[:10], snd, rcv, mask, 30, stats=("sum",))
    with pytest.raises(ValueError):                  # one half only
        f(x, snd, rcv, mask, 30, stats=("sum",), att_src=a_s)
    with pytest.raises(ValueError):                  # attention needs sum
        f(x, snd, rcv, mask, 30, stats=("count",), att_src=a_s, att_dst=a_d)
    with pytest.raises(ValueError):                  # only sum and count
        f(x, snd, rcv, mask, 30, stats=("sum", "max"), att_src=a_s,
          att_dst=a_d)
    with pytest.raises(ValueError):                  # halves differ
        f(x, snd, rcv, mask, 30, stats=("sum",), att_src=a_s,
          att_dst=a_d[:, :1])
    with pytest.raises(ValueError):                  # H must divide D
        f(x, snd, rcv, mask, 30, stats=("sum",),
          att_src=torch.zeros((30, 3)), att_dst=torch.zeros((30, 3)))
    with pytest.raises(ValueError):                  # width must divide D
        f(x, snd, rcv, mask, 30, stats=("sum",),
          src_weight=torch.zeros((200, 3)))


def test_cpu_path_takes_the_plain_version_and_launches_nothing():
    p, r = _problem(64, 8, 16, seed=9, heads=2)
    before = tmp.mp_pipeline.launches
    ours = _port(p, {}, ("sum", "count"))
    plain = _port(p, {}, ("sum", "count"), fn=tmp.mp_pipeline_ref)
    assert all(torch.equal(ours[k], plain[k]) for k in plain)
    assert tmp.mp_pipeline.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(e=4096, d=100, n=1024, stats=ALL_STATS,
         phi=dict(sw="full", edge_term=True, bias=True, relu=True)),
    dict(e=4096, d=100, n=1024, stats=("sum",), phi=dict(sw="scalar")),
    dict(e=3001, d=64, n=997, stats=ALL_STATS, phi=dict(sw="head")),
    dict(e=4096, d=64, n=1024, heads=4, stats=("sum", "count"), phi={}),
    dict(e=1000, d=300, n=61, heads=4, stats=("sum",), phi={}),
])
def test_cuda_kernel_matches_plain_version(case):
    """The CUDA kernel vs its plain version on the card, bitwise equal
    across rows-per-block and runs. Both are fp32 with sums in another
    order, so they agree to 1e-4 of each output's scale; empty rows are
    exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e, d, n = case["e"], case["d"], case["n"]
    p, r = _problem(e, d, n, seed=e, heads=case.get("heads", 0))
    kw = _phi(r, e, d, **case["phi"])
    before = tmp.mp_pipeline.launches
    outs = [_port(p, kw, case["stats"], device="cuda", rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 16)]
    plain = _port(p, kw, case["stats"], fn=tmp.mp_pipeline_ref,
                  device="cuda")
    torch.cuda.synchronize()
    assert tmp.mp_pipeline.launches == before + len(outs)
    assert tuple(outs[0]) == tuple(plain)
    reached = np.zeros(n, bool)
    reached[p["receivers"][p["edge_mask"]]] = True
    reached = torch.from_numpy(reached).cuda()
    for name, want in plain.items():
        got = outs[0][name]
        assert torch.equal(got[~reached], want[~reached]), name
        scale = max(1.0, float(want[reached].abs().max()))
        torch.testing.assert_close(got[reached], want[reached],
                                   atol=1e-4 * scale, rtol=1e-4, msg=name)
        for o in outs[1:]:
            assert torch.equal(o[name], got), name


@pytest.mark.cuda
@pytest.mark.parametrize("attention", [False, True])
def test_cuda_kernel_follows_the_out_of_range_rules(attention):
    """The CUDA kernel against its plain version on receivers and senders
    outside [0, N): fp32 sums in another order, so 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    e, d, n = 160, 8, 32
    p, r = _problem(e, d, n, seed=5, heads=2 if attention else 0)
    out_of_range(p, r, "both")
    if attention:
        kw, stats = {}, ("sum", "count")
    else:
        kw, stats = _phi(r, e, d, edge_term=True, bias=True, relu=True), \
            ALL_STATS
    out = _port(p, kw, stats, device="cuda")
    plain = _port(p, kw, stats, fn=tmp.mp_pipeline_ref, device="cuda")
    torch.cuda.synchronize()
    for name, want in plain.items():
        torch.testing.assert_close(out[name], want, atol=1e-5, rtol=1e-5,
                                   msg=name)


# The owner buckets' edge cases: a hub row (most edges into one row), every
# edge into one row, more rows than edges, and a row longer than the
# register sort of a bucket's segment (128 edges; a longer one is rebuilt
# from a sweep of the stream).
OWNER_CASES = {
    "hub_row": dict(e=400, n=32, rows=[10], share=0.6),
    "every_edge_to_one_row": dict(e=160, n=16, rows=[3], share=1.0),
    "more_rows_than_edges": dict(e=40, n=200, rows=[], share=0.0),
    "row_past_the_sort_limit": dict(e=300, n=24, rows=[7], share=0.7),
}


def owner_case(name, d=8, heads=0, seed=11):
    """``_problem`` with ``share`` of the receivers moved to ``rows``."""
    spec = OWNER_CASES[name]
    p, r = _problem(spec["e"], d, spec["n"], seed=seed, heads=heads)
    if spec["rows"]:
        pick = r.random(spec["e"]) < spec["share"]
        p["receivers"] = np.where(pick, spec["rows"][0],
                                  p["receivers"]).astype(np.int32)
    return p, r


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("case", sorted(OWNER_CASES))
def test_owner_bucket_cases_match_the_kernel(jops, case, attention):
    """The owner buckets' edge cases against the interpret-mode Pallas
    kernel at 1e-5: all five statistics with a full src_weight, edge term,
    bias and relu, or GAT's attention (H=2) with the count."""
    p, r = owner_case(case, heads=2 if attention else 0)
    e, d = p["senders"].shape[0], p["x"].shape[1]
    if attention:
        kw, stats = {}, ("sum", "count")
    else:
        kw = _phi(r, e, d, sw="full", edge_term=True, bias=True, relu=True)
        stats = ALL_STATS
    ours = _port(p, kw, stats)
    kern, _ = _jax(jops, p, kw, stats, edge_tile=32, num_banks=4)
    assert set(ours) == set(kern)
    for name, v in ours.items():
        np.testing.assert_allclose(v.numpy(), kern[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    longest = np.bincount(p["receivers"][p["edge_mask"]]).max()
    assert case != "row_past_the_sort_limit" or longest > 128


@pytest.mark.cuda
@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("case", sorted(OWNER_CASES))
def test_cuda_owner_bucket_cases_are_bitwise_across_rows(case, attention):
    """The owner buckets' edge cases on the card: the kernel against its
    plain version (fp32 sums in another order: 1e-4 of each output's
    scale, empty rows exact), bitwise equal across runs and at 1, 3, 8 and
    16 rows per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p, r = owner_case(case, d=64, heads=4 if attention else 0)
    e, d = p["senders"].shape[0], p["x"].shape[1]
    if attention:
        kw, stats = {}, ("sum", "count")
    else:
        kw = _phi(r, e, d, sw="full", edge_term=True, bias=True, relu=True)
        stats = ALL_STATS
    outs = [_port(p, kw, stats, device="cuda", rows_per_block=rpb)
            for rpb in (None, None, 1, 3, 8, 16)]
    plain = _port(p, kw, stats, fn=tmp.mp_pipeline_ref, device="cuda")
    torch.cuda.synchronize()
    for name, want in plain.items():
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(outs[0][name], want, atol=1e-4 * scale,
                                   rtol=1e-4, msg=name)
        for o in outs[1:]:
            assert torch.equal(o[name], outs[0][name]), name
