"""The port's ``layer_fused`` (self, scalers and field epilogues) against
the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel run in interpret mode and against the JAX
oracle ``layer_fused_ref``, on the same numpy-seeded inputs and with the
reference's own tolerances (2e-4 for the GIN form's kernel and for the
scalers and field forms, as ``tests/test_scheduler_executor.py`` holds
them; 2e-5 else). The CUDA kernel is held against the plain version in a
test that needs the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import layer_fused as tlf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


@pytest.fixture(scope="module")
def jops():
    """The JAX package's kernel ops (absent where JAX is not installed, as
    on a machine that only runs the CUDA tests)."""
    pytest.importorskip("jax")
    return pytest.importorskip("repro.kernels.ops")


def _problem(e=200, d=8, n=30, seed=0, mask_p=0.8):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    snd = r.integers(0, n, size=e).astype(np.int32)
    rcv = r.integers(0, max(n - 4, 1), size=e).astype(np.int32)
    mask = r.random(e) < mask_p
    return x, snd, rcv, mask


def _off_by_4_bytes(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def _port(x, snd, rcv, mask, n, kw, fn=tops.layer_fused, device="cpu",
          weights_off_4_bytes=False, **extra):
    to_t = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
                else v) for k, v in kw.items()}
    if weights_off_4_bytes:
        to_t.update({k: _off_by_4_bytes(to_t[k])
                     for k in ("w1", "b1", "w2", "b2") if k in to_t})
    return fn(torch.from_numpy(x).to(device),
              torch.from_numpy(snd.astype(np.int64)).to(device),
              torch.from_numpy(rcv.astype(np.int64)).to(device),
              torch.from_numpy(mask).to(device), n, **to_t, **extra)


def _both(x, snd, rcv, mask, n, kw):
    """The port's output on the CPU, and the JAX side's args and kwargs."""
    out = _port(x, snd, rcv, mask, n, kw)
    import jax.numpy as jnp
    to_j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    jargs = (jnp.asarray(x), jnp.asarray(snd), jnp.asarray(rcv),
             jnp.asarray(mask), n)
    return out.cpu().numpy(), jargs, to_j


def _gin_kw(r, e, d, d_ff=None):
    d_ff = d_ff or 2 * d
    return dict(w1=r.normal(size=(d, d_ff)).astype(np.float32),
                b1=r.normal(size=(d_ff,)).astype(np.float32),
                w2=r.normal(size=(d_ff, d)).astype(np.float32),
                b2=r.normal(size=(d,)).astype(np.float32),
                edge_term=r.normal(size=(e, d)).astype(np.float32),
                phi_activation="relu", self_coeff=np.float32(1.25))


def _degrees(rcv, mask, n):
    return np.bincount(rcv[mask], minlength=n).astype(np.float32)


def _pna_kw(r, x, rcv, mask, n, e, n_scalers=3, d_ff=None):
    """PNA's scalers form: node_input and edge_term of width D, relu phi,
    the degree scalers and the shared degrees, w1 over D + S·4·D."""
    d = x.shape[1]
    kw = dict(node_input=r.normal(size=(n, d)).astype(np.float32),
              edge_term=r.normal(size=(e, d)).astype(np.float32),
              phi_activation="relu",
              scalers=r.normal(size=(n, n_scalers)).astype(np.float32),
              degrees=_degrees(rcv, mask, n),
              w1=r.normal(size=(d + n_scalers * 4 * d, d_ff or d)
                          ).astype(np.float32),
              b1=r.normal(size=(d_ff or d,)).astype(np.float32))
    if d_ff is None:
        kw["out_activation"] = "relu"
    else:
        kw["w2"] = r.normal(size=(d_ff, d)).astype(np.float32)
        kw["b2"] = r.normal(size=(d,)).astype(np.float32)
    return kw


def _dgn_kw(r, x, snd, rcv, mask, n, e):
    """DGN's field form: the stacked [x | x] gather buffer, the full
    (E, 2·D_x) [1 | w] src_weight from a random field, its per-destination
    sums, the shared degrees, w1 over 3·D_x."""
    d_x = x.shape[1]
    w = r.normal(size=(e,)).astype(np.float32)
    lane_w = np.concatenate(
        [np.ones((e, d_x), np.float32),
         np.broadcast_to(w[:, None], (e, d_x))], axis=-1)
    wsum = np.zeros(n, np.float32)
    np.add.at(wsum, rcv[mask], w[mask])
    return dict(node_input=np.concatenate([x, x], axis=-1),
                src_weight=np.ascontiguousarray(lane_w),
                field_wsum=wsum, degrees=_degrees(rcv, mask, n),
                w1=r.normal(size=(3 * d_x, d_x)).astype(np.float32),
                b1=r.normal(size=(d_x,)).astype(np.float32),
                out_activation="relu")


@pytest.mark.parametrize("e,d,n,edge_tile,banks", [
    (128, 16, 32, 32, 2),
    (200, 8, 30, 64, 4),         # uneven: E % tile != 0, N % banks != 0
    (96, 24, 17, 32, 5),         # uneven bank sizes
])
def test_gin_form_matches_reference(jops, e, d, n, edge_tile, banks):
    """GIN form: phi=relu(src+e), scalar self term, 2-layer MLP."""
    r = np.random.default_rng(e + n)
    x, snd, rcv, mask = _problem(e, d, n, seed=e + n)
    kw = _gin_kw(r, e, d)
    kw["self_coeff"] = 1.25
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=edge_tile, num_banks=banks,
                            **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    assert ours.shape == (n, d)


def test_gcn_form_matches_reference(jops):
    """GCN form: phi=src*norm, per-node self term, single dense, out relu,
    D_out != D."""
    e, d, n = 200, 8, 30
    r = np.random.default_rng(1)
    x, snd, rcv, mask = _problem(e, d, n, seed=2)
    kw = dict(w1=r.normal(size=(d, 5)).astype(np.float32),
              b1=r.normal(size=(5,)).astype(np.float32),
              src_weight=r.normal(size=(e,)).astype(np.float32),
              self_coeff=r.normal(size=(n,)).astype(np.float32),
              out_activation="relu")
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=64, num_banks=3, **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    assert ours.shape == (n, 5)


def test_no_self_term_bias_and_full_src_weight_match_reference(jops):
    e, d, n = 128, 8, 24
    r = np.random.default_rng(3)
    x, snd, rcv, mask = _problem(e, d, n, seed=5)
    kw = dict(w1=r.normal(size=(d, d)).astype(np.float32),
              b1=r.normal(size=(d,)).astype(np.float32),
              phi_bias=r.normal(size=(d,)).astype(np.float32),
              src_weight=r.normal(size=(e, d)).astype(np.float32))
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=32, num_banks=4, **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_head_broadcast_src_weight_and_node_input_match_reference(jops):
    """(E, H) per-head lanes broadcast over D/H lanes; a separate gather
    buffer (node_input) with the self term on x."""
    e, d, n, h = 128, 16, 24, 4
    r = np.random.default_rng(4)
    x, snd, rcv, mask = _problem(e, d, n, seed=7)
    kw = dict(w1=r.normal(size=(d, d)).astype(np.float32),
              b1=r.normal(size=(d,)).astype(np.float32),
              src_weight=r.normal(size=(e, h)).astype(np.float32),
              node_input=r.normal(size=(n, d)).astype(np.float32),
              self_coeff=np.float32(0.5))
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=32, num_banks=4, **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("e,d,n,edge_tile,banks", [
    (128, 16, 32, 32, 2),
    (200, 8, 30, 64, 4),         # uneven: E % tile != 0, N % banks != 0
    (96, 8, 17, 32, 5),          # uneven bank sizes + empty destinations
])
def test_pna_form_matches_reference(jops, e, d, n, edge_tile, banks):
    """PNA's scalers form: mean, std, max and min from the sum, sum of
    squares and keyed extrema, the degree scalers, one dense layer with
    out relu; the last four destinations get no edge."""
    r = np.random.default_rng(e + 1)
    x, snd, rcv, mask = _problem(e, d, n, seed=e)
    kw = _pna_kw(r, x, rcv, mask, n, e)
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=edge_tile, num_banks=banks,
                            **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)
    assert ours.shape == (n, d)


def test_pna_form_two_layer_mlp_matches_reference(jops):
    e, d, n = 160, 8, 24
    r = np.random.default_rng(9)
    x, snd, rcv, mask = _problem(e, d, n, seed=3)
    kw = _pna_kw(r, x, rcv, mask, n, e, d_ff=2 * d)
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=32, num_banks=4, **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("e,d,n,edge_tile,banks", [
    (128, 16, 32, 32, 2),
    (200, 8, 30, 64, 4),
    (96, 8, 17, 32, 5),
])
def test_dgn_form_matches_reference(jops, e, d, n, edge_tile, banks):
    """DGN's field form: one sum over the stacked [x | x·w] buffer with a
    full src_weight, the mean half and |s1 - x·wsum|, one dense layer with
    out relu; the last four destinations get no edge."""
    r = np.random.default_rng(e + 2)
    x, snd, rcv, mask = _problem(e, d, n, seed=e + 5)
    kw = _dgn_kw(r, x, snd, rcv, mask, n, e)
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=edge_tile, num_banks=banks,
                            **jkw)
    ref = jops.layer_fused_ref(*jargs, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)
    assert ours.shape == (n, d)


def _glorot(r, d_in, d_out):
    return (r.normal(size=(d_in, d_out)) * np.sqrt(2.0 / (d_in + d_out))
            ).astype(np.float32)


@pytest.mark.parametrize("form", ["gin", "pna", "dgn"])
def test_paper_width_matches_the_kernel(jops, form):
    """Each form at its paper width, at small N: GIN's self form with its
    MLP 100 -> 200 -> 100, PNA's scalers form at D=80 (w1 over 1,040) and
    DGN's field form at D_x=100 (w1 over 300), against the interpret-mode
    Pallas kernel at 2e-4 (its sums and products run in another order);
    weights scaled as the models initialise them."""
    e, n = 96, 20
    r = np.random.default_rng(11)
    d = 80 if form == "pna" else 100
    x, snd, rcv, mask = _problem(e, d, n, seed=12)
    if form == "gin":
        kw = _gin_kw(r, e, d)
        kw.update(w1=_glorot(r, d, 2 * d), w2=_glorot(r, 2 * d, d))
    elif form == "pna":
        kw = _pna_kw(r, x, rcv, mask, n, e)
        kw["w1"] = _glorot(r, 13 * d, d)
    else:
        kw = _dgn_kw(r, x, snd, rcv, mask, n, e)
        kw["w1"] = _glorot(r, 3 * d, d)
    ours, jargs, jkw = _both(x, snd, rcv, mask, n, kw)
    kern = jops.layer_fused(*jargs, edge_tile=32, num_banks=4, **jkw)
    np.testing.assert_allclose(ours, kern, atol=2e-4, rtol=2e-4)
    assert ours.shape == (n, d)


def _out_of_range_problem(case, d=8, d_ff=16, d_out=None):
    """ROADMAP queue 3's input (default_rng(5), N=32, E=160, D=8, the self
    form with self_coeff 1.5 and w1 8->16), with a quarter of the edges'
    receivers, senders or both redrawn outside [0, N): half at [-4, 0),
    half at [N, N + 12) (receivers) or [N, N + 8) (senders). Other widths
    (D, d_ff, and a second dense layer d_ff -> d_out) on request."""
    e, n = 160, 32
    r = np.random.default_rng(5)
    x, snd, rcv, mask = _problem(e, d, n, seed=5)
    streams = {"receivers": (rcv, 12), "senders": (snd, 8)}
    for name in (("receivers", "senders") if case == "both" else (case,)):
        idx, past = streams[name]
        pick = r.random(e) < 0.25
        draw = np.where(r.random(e) < 0.5, r.integers(-4, 0, size=e),
                        r.integers(n, n + past, size=e))
        idx[:] = np.where(pick, draw, idx)
    kw = dict(w1=r.normal(size=(d, d_ff)).astype(np.float32),
              b1=r.normal(size=(d_ff,)).astype(np.float32),
              edge_term=r.normal(size=(e, d)).astype(np.float32),
              phi_activation="relu", self_coeff=np.float32(1.5))
    if d_out is not None:
        kw["w1"] = _glorot(r, d, d_ff)
        kw["w2"] = _glorot(r, d_ff, d_out)
        kw["b2"] = r.normal(size=(d_out,)).astype(np.float32)
    return (x, snd, rcv, mask, n), kw


@pytest.mark.parametrize("case", ["receivers", "senders", "both"])
def test_out_of_range_indices_follow_the_kernel(jops, case):
    """A receiver outside [0, N) adds nothing; a sender there gathers a
    zero row of y and still counts, as the interpret-mode Pallas kernel
    gives."""
    args, kw = _out_of_range_problem(case)
    out, jargs, jkw = _both(*args, kw)
    kern = np.asarray(jops.layer_fused(*jargs, **jkw, edge_tile=32,
                                       num_banks=4))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=1e-5)


def test_tile_keywords_are_accepted_and_change_nothing():
    """``ops.layer_fused`` takes the reference's ``edge_tile`` and
    ``num_banks``; they describe the TPU grid and change nothing here."""
    r = np.random.default_rng(7)
    x, snd, rcv, mask = _problem(200, 8, 30, seed=7)
    kw = _gin_kw(r, 200, 8)
    a = _port(x, snd, rcv, mask, 30, kw)
    b = _port(x, snd, rcv, mask, 30, kw, edge_tile=64, num_banks=2)
    assert torch.equal(a, b)


def test_layer_fused_rejects_bad_input():
    x, snd, rcv, mask = (torch.from_numpy(a) for a in _problem())
    snd, rcv = snd.long(), rcv.long()
    w1 = torch.zeros((8, 8))
    b1 = torch.zeros((8,))
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         phi_activation="gelu")
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         out_activation="tanh")
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         w2=torch.zeros((8, 8)))       # w2 without b2
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=torch.zeros((4, 8)),
                         b1=b1)
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         self_coeff=torch.zeros((7,)))
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 29, w1=w1, b1=b1)
    with pytest.raises(ValueError):                  # width must divide D
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         src_weight=torch.zeros((200, 3)))
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         self_coeff=1.0, scalers=torch.zeros((30, 3)),
                         degrees=torch.zeros((30,)))
    deg = torch.zeros((30,))
    wide = torch.zeros((8 + 3 * 4 * 8, 8))
    with pytest.raises(ValueError):                  # scalers need degrees
        tops.layer_fused(x, snd, rcv, mask, 30, w1=wide, b1=b1,
                         scalers=torch.zeros((30, 3)))
    with pytest.raises(ValueError):                  # field needs degrees
        tops.layer_fused(x, snd, rcv, mask, 30, w1=torch.zeros((24, 8)),
                         b1=b1, node_input=torch.cat([x, x], -1),
                         field_wsum=deg)
    with pytest.raises(ValueError):                  # wrong contraction
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         scalers=torch.zeros((30, 3)), degrees=deg)
    with pytest.raises(ValueError):
        tops.layer_fused(x, snd, rcv, mask, 30, w1=w1, b1=b1,
                         node_input=torch.cat([x, x], -1), field_wsum=deg,
                         degrees=deg)
    with pytest.raises(ValueError):                  # field buffer not 2·D_x
        tops.layer_fused(x, snd, rcv, mask, 30, w1=torch.zeros((24, 8)),
                         b1=b1, field_wsum=deg, degrees=deg)
    with pytest.raises(ValueError):                  # scalers rows
        tops.layer_fused(x, snd, rcv, mask, 30, w1=wide, b1=b1,
                         scalers=torch.zeros((29, 3)), degrees=deg)
    with pytest.raises(ValueError):                  # mutually exclusive
        tops.layer_fused(x, snd, rcv, mask, 30, w1=wide, b1=b1,
                         scalers=torch.zeros((30, 3)), degrees=deg,
                         field_wsum=deg)


def test_cpu_path_takes_the_plain_version_and_launches_nothing():
    e, d, n = 64, 8, 16
    r = np.random.default_rng(9)
    x, snd, rcv, mask = _problem(e, d, n, seed=9)
    kw = _gin_kw(r, e, d)
    before = tlf.layer_fused.launches
    ours = _port(x, snd, rcv, mask, n, kw)
    plain = _port(x, snd, rcv, mask, n, kw, fn=tlf.layer_fused_ref)
    assert torch.equal(ours, plain)
    assert tlf.layer_fused.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gin", "pna", "dgn"])
@pytest.mark.parametrize("e,d,n,d_ff", [
    (4096, 100, 1024, None), (1000, 100, 61, None), (333, 300, 45, None),
    (2048, 160, 256, None),      # PNA's w1 2,080 x 160 (1.33 MB): the ring
    (3001, 9, 997, 25),          # ragged: k * n_dim and biases off 4 floats
])
def test_cuda_kernel_matches_plain_version(e, d, n, d_ff, form):
    """The CUDA kernel vs its plain version on the card, in GIN's self
    form, PNA's scalers form and DGN's field form (at D = 300 the field's
    stacked buffer is 600 wide), bitwise equal across rows-per-block and
    runs, and with the weights and biases as views off 4 bytes (staged 4
    bytes a copy instead of in bulk). Both are fp32 with sums in another
    order, so they agree to 1e-4 of the output's scale. With an identity w1
    (every output one product by 1 among zeros, exact on both sides) the
    output is the epilogue's input row z itself: the empty destinations' z
    must be equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(e)
    x, snd, rcv, mask = _problem(e, d, n, seed=e)
    if form == "gin":
        kw = _gin_kw(r, e, d, d_ff)
    elif form == "pna":
        kw = _pna_kw(r, x, rcv, mask, n, e)
    else:
        kw = _dgn_kw(r, x, snd, rcv, mask, n, e)
    before = tlf.layer_fused.launches
    outs = [_port(x, snd, rcv, mask, n, kw, device="cuda",
                  rows_per_block=rpb) for rpb in (None, None, 1, 3, 8, 16)]
    outs.append(_port(x, snd, rcv, mask, n, kw, device="cuda",
                      weights_off_4_bytes=True))
    plain = _port(x, snd, rcv, mask, n, kw, fn=tlf.layer_fused_ref,
                  device="cuda")
    torch.cuda.synchronize()
    assert tlf.layer_fused.launches == before + len(outs)
    scale = float(plain.abs().max())
    torch.testing.assert_close(outs[0], plain, atol=1e-4 * scale, rtol=1e-4)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    if form != "gin":
        d_in = kw["w1"].shape[0]
        probe = {k: v for k, v in kw.items() if k not in ("w2", "b2")}
        probe.update(w1=np.eye(d_in, dtype=np.float32),
                     b1=np.zeros(d_in, np.float32), out_activation="none")
        z = _port(x, snd, rcv, mask, n, probe, device="cuda")
        z_plain = _port(x, snd, rcv, mask, n, probe, fn=tlf.layer_fused_ref,
                        device="cuda")
        empty = torch.from_numpy(_degrees(rcv, mask, n) == 0).cuda()
        assert bool(empty.any())
        assert torch.equal(z[empty], z_plain[empty])
        torch.testing.assert_close(z, z_plain, rtol=1e-4,
                                   atol=1e-4 * float(z_plain.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d,d_ff,d_out", [
    (8, 16, None),
    (9, 25, 9),                  # ragged widths, two dense layers
    (8, 300, 200),               # w2 300 x 200 (240 KB): the ring
])
def test_cuda_kernel_follows_the_out_of_range_rules(d, d_ff, d_out):
    """The CUDA kernel against its plain version on receivers and senders
    outside [0, N): fp32 sums and products in another order, so 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, kw = _out_of_range_problem("both", d, d_ff, d_out)
    out = _port(*args, kw, device="cuda")
    plain = _port(*args, kw, fn=tlf.layer_fused_ref, device="cuda")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)
