"""Model-parallel serving on the port's mesh, on ``devices="cpu"``
positions: tensor, sequence, vocab and expert parallelism in the prefill
and decode steps (``launch/steps.py::make_prefill_step`` /
``make_decode_step`` with ``rules, mesh``).

Each case runs a prefill and two decode steps of a reduced model in
float32, from the reference's ``init`` (key 0, carried over as a JAX
checkpoint), and holds the logits and the caches three ways:

  * against the port's unsharded steps on the same weights, within 1e-5
    of their scale (float32 sums over the positions in another order);
  * against the reference's unsharded steps at atol = rtol = 1e-5;
  * against the reference's sharded steps (GSPMD) at the reference's own
    tolerances: 3e-3 (``tests/test_distributed.py::
    test_decode_seq_sharded_cache_matches``) and, for expert parallelism,
    2e-3 at capacity factor 64 (``test_moe_expert_parallel_matches_local``).

The cases: llama3-8b on (1, 2) (heads, ff and vocab split, the prefill's
residual split by sequence, the Megatron-SP MLP, the cache split by KV
heads), on (2, 2) (the batch split too), with one KV head (the cache split
by sequence, the prompt past the first position's rows: flash-decoding
over the positions), and at a prompt length
the model axis does not divide (the residual whole); olmoe-1b-7b on
(1, 4) (two experts a bank); mamba2-2.7b on (1, 4) (the SSD's heads and
the cached state split, the mixer's weights whole) and recurrentgemma-2b
on (2, 2) (the RG-LRU's width, its state and conv window split, the local
attention's one KV head with its cache split by sequence). The caches
compared are every tensor of the first layer group's: K / V, the SSM
state and conv window, the RG-LRU state and conv window. The reference's
sharded steps cannot serve the indivisible length (its hand-scheduled MLP
is a ``shard_map`` over the sequence), so that case has no third
comparison.

The JAX side runs in one subprocess with four fake host devices.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.archs import REDUCED  # noqa: E402
from repro_torch.distributed.collectives import (all_gather,  # noqa: E402
                                                 axis_index, pmean,
                                                 psum_scatter, shard_map)
from repro_torch.distributed.sharding import (P, ParamDef,  # noqa: E402
                                              ShardingRules, device_put,
                                              logical_constraint, make_mesh,
                                              map_defs, param_shardings)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import (build_rules,  # noqa: E402
                                      make_decode_step, make_prefill_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

B, MAX, STEPS = 4, 32, 2
# (arch, mesh shape, prompt length, config changes, capacity factor of the
# comparison with the reference's sharded steps)
CASES = {
    "tp": ("llama3-8b", (1, 2), 16, {}, None),
    "tp_dp": ("llama3-8b", (2, 2), 16, {}, None),
    "seq_cache": ("llama3-8b", (1, 2), 20, {"num_kv_heads": 1}, None),
    "ragged": ("llama3-8b", (1, 2), 15, {}, None),
    "ep": ("olmoe-1b-7b", (1, 4), 16, {}, 64.0),
    "ssm": ("mamba2-2.7b", (1, 4), 16, {}, None),
    # the prompt at least the local window and the conv's three rows
    "hybrid": ("recurrentgemma-2b", (2, 2), 20, {}, None),
}
NO_SHARDED_REF = {"ragged"}
# the sharded steps against the port's unsharded ones, of the scale
SCALE_TOL = 1e-5
# against the reference's unsharded steps (ROADMAP)
REF_TOL = dict(atol=1e-5, rtol=1e-5)
# against the reference's sharded steps: its own tolerances; its sharded
# SSM and hybrid steps are its unsharded ones to float32 rounding (7e-7 of
# the scale on the CPU), so the unsharded tolerance holds there
SHARDED_REF_TOL = {"llama3-8b": 3e-3, "olmoe-1b-7b": 2e-3,
                   "mamba2-2.7b": 1e-5, "recurrentgemma-2b": 1e-5}
# the cases whose parameter and cache placement is held against the
# reference's
PLACEMENT_CASES = ("tp", "ep", "ssm")

JAX_SERVE = """
import json
import jax, numpy as np, jax.numpy as jnp
from repro.checkpoint import checkpoint as ckpt
from repro.configs.archs import REDUCED
from repro.distributed.sharding import init_params, param_shardings
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_rules, make_decode_step, make_prefill_step
from repro.models import lm
root, cases, B, MAX, STEPS = ROOT, CASES, BATCH, MAXLEN, NSTEPS
no_sharded, placements = NO_SHARDED, PLACEMENTS
saved, index_maps = set(), {}

def index_map(shardings, leaves, mesh):
    coords = {d: c for c, d in np.ndenumerate(mesh.devices)}
    maps = []
    for sh, leaf in zip(shardings, leaves):
        per = {}
        for dev, idx in sh.devices_indices_map(leaf.shape).items():
            per[','.join(map(str, coords[dev]))] = [
                [sl.start or 0, leaf.shape[j] if sl.stop is None
                 else sl.stop] for j, sl in enumerate(idx)]
        maps.append({'shape': list(leaf.shape), 'pieces': per})
    return maps

def tensors(cache):
    return {f: np.asarray(getattr(cache, f)) for f in cache._fields
            if f != 'length'}

def serve(cfg, toks, s, params, caches, rules=None, mesh=None):
    pre = jax.jit(make_prefill_step(cfg, rules and rules[0], mesh))
    dec = jax.jit(make_decode_step(cfg, rules and rules[1], mesh))
    lg, caches = pre(params, caches, {'tokens': toks[:, :s]})
    out = [np.asarray(lg)]
    for i in range(STEPS):
        lg, caches = dec(params, caches,
                         {'token': toks[:, s + i:s + i + 1],
                          'position': jnp.asarray(s + i, jnp.int32)})
        out.append(np.asarray(lg))
    return out, tensors(caches['groups'][0])

for name, (arch, shape, s, kw, cf) in cases.items():
    cfg = REDUCED[arch].replace(**kw)
    tag = arch + ''.join(f'-{k}{v}' for k, v in sorted(kw.items()))
    pdefs = lm.lm_param_defs(cfg)
    params = init_params(jax.random.PRNGKey(0), pdefs)
    if tag not in saved:
        ckpt.save(f'{root}/{tag}', 0, params)
        saved.add(tag)
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, s + STEPS)),
                       jnp.int32)
    cdefs = lm.lm_cache_defs(cfg, B, MAX)
    logits, cache = serve(cfg, toks, s, params,
                          init_params(jax.random.PRNGKey(0), cdefs))
    np.savez(f'{root}/{name}-unsharded.npz', *logits, **cache)
    mesh = make_host_mesh(*shape)
    if name in placements:
        rules = build_rules(cfg, mesh, 'prefill', global_batch=B)
        zeros = init_params(jax.random.PRNGKey(0), cdefs)
        flat = jax.tree_util.tree_flatten_with_path(zeros)[0]
        keep = [getattr(path[-1], 'name', None) != 'length'
                for path, _ in flat]
        cmaps = index_map(jax.tree.leaves(param_shardings(cdefs, rules,
                                                          mesh)),
                          [leaf for _, leaf in flat], mesh)
        index_maps[name] = {
            'params': index_map(jax.tree.leaves(param_shardings(
                pdefs, rules, mesh)), jax.tree.leaves(params), mesh),
            'caches': [m for m, k in zip(cmaps, keep) if k]}
    if name in no_sharded:
        continue
    if cf:
        cfg = cfg.replace(capacity_factor=cf)
    rules = (build_rules(cfg, mesh, 'prefill', global_batch=B),
             build_rules(cfg, mesh, 'decode', global_batch=B))
    params_s = jax.device_put(params, param_shardings(pdefs, rules[0], mesh))
    caches_s = jax.device_put(init_params(jax.random.PRNGKey(0), cdefs),
                              param_shardings(cdefs, rules[0], mesh))
    with mesh:
        logits, cache = serve(cfg, toks, s, params_s, caches_s, rules, mesh)
    np.savez(f'{root}/{name}-sharded.npz', *logits, **cache)
json.dump(index_maps, open(f'{root}/placements.json', 'w'))
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's checkpoints (JAX ``init``, key 0), its unsharded and
    sharded steps' logits and caches, and its parameter placements, from
    one subprocess."""
    root = tmp_path_factory.mktemp("model_parallel_ref")
    code = (JAX_SERVE.replace("ROOT", repr(str(root)))
            .replace("CASES", repr(CASES)).replace("BATCH", str(B))
            .replace("MAXLEN", str(MAX)).replace("NSTEPS", str(STEPS))
            .replace("NO_SHARDED", repr(NO_SHARDED_REF))
            .replace("PLACEMENTS", repr(PLACEMENT_CASES)))
    run_with_devices(code, n=4)
    return root


def _cfg(name, cf=None):
    arch, _, _, kw, _ = CASES[name]
    cfg = REDUCED[arch].replace(**kw)
    return cfg.replace(capacity_factor=cf) if cf else cfg


def _params(root, name):
    arch, _, _, kw, _ = CASES[name]
    tag = arch + "".join(f"-{k}{v}" for k, v in sorted(kw.items()))
    like = map_defs(lambda d: torch.empty(0), lm.lm_param_defs(_cfg(name)))
    _, params, _ = ckpt.restore_latest(root / tag, like)
    return params


def _tokens(cfg, s):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, s + STEPS)).astype(np.int32))


def _serve(cfg, params, s, mesh=None):
    """The port's prefill and STEPS decode steps: ([logits], {name: every
    tensor of the first layer group's cache, whole})."""
    rules = (None, None) if mesh is None else (
        build_rules(cfg, mesh, "prefill", global_batch=B),
        build_rules(cfg, mesh, "decode", global_batch=B))
    pre = make_prefill_step(cfg, rules[0], mesh)
    dec = make_decode_step(cfg, rules[1], mesh)
    toks = _tokens(cfg, s)
    lg, caches = pre(params, lm.init_caches(cfg, B, MAX, "cpu"),
                     {"tokens": toks[:, :s]})
    out = [lg]
    for i in range(STEPS):
        lg, caches = dec(params, caches, {"token": toks[:, s + i:s + i + 1],
                                          "position": s + i})
        out.append(lg)
    first = caches["groups"][0]
    assert first.length == s + STEPS
    return [t.numpy() for t in out], {
        f: (t.gather() if mesh is not None else t).numpy()
        for f, t in zip(first._fields, first) if f != "length"}


def _of_scale(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_steps_match_unsharded_and_reference(ref, name):
    arch, shape, s, _, cf = CASES[name]
    cfg = _cfg(name)
    params = _params(ref, name)
    mesh = make_host_mesh(*shape, devices="cpu")
    logits, cache = _serve(cfg, params, s, mesh)
    want, wcache = _serve(cfg, params, s)
    assert sorted(cache) == sorted(wcache) and cache
    for a, b in zip(logits + [cache[f] for f in sorted(cache)],
                    want + [wcache[f] for f in sorted(cache)]):
        assert a.shape == b.shape and np.all(np.isfinite(a))
        _of_scale(a, b, SCALE_TOL)
    data = np.load(ref / f"{name}-unsharded.npz")
    for i, a in enumerate(logits):
        np.testing.assert_allclose(a, data[f"arr_{i}"], **REF_TOL)
    for f, a in cache.items():
        np.testing.assert_allclose(a, data[f], **REF_TOL)
    if name in NO_SHARDED_REF:
        return
    if cf:
        logits, cache = _serve(_cfg(name, cf), params, s, mesh)
    data = np.load(ref / f"{name}-sharded.npz")
    tol = SHARDED_REF_TOL[arch]
    for i, a in enumerate(logits):
        np.testing.assert_allclose(a, data[f"arr_{i}"], atol=tol, rtol=tol)
    for f, a in cache.items():
        np.testing.assert_allclose(a, data[f], atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_every_dense_and_moe_arch_serves_on_a_model_axis(arch):
    """Every arch of every family (qwen's ``dp_only`` profile folds the
    model axis into the batch; gemma2's windows and softcaps, tied
    embeddings and post norms; internvl's prefix embeddings; musicgen's
    sinusoidal positions, layernorm and plain MLP; arctic's dense
    residual; mamba2's SSD split by heads; recurrentgemma's RG-LRU split
    by width beside its local attention) on (1, 2), its own reduced
    weights: the prefill and two decode steps within 1e-5 of the scale of
    its unsharded steps."""
    cfg = REDUCED[arch]
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = make_host_mesh(1, 2, devices="cpu")
    s = 16
    batch = {"tokens": _tokens(cfg, s)[:, :s]}
    if cfg.prefix_len:
        batch["prefix_embed"] = torch.randn(
            B, cfg.prefix_len, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    runs = []
    for m in (None, mesh):
        rules = (None, None) if m is None else (
            build_rules(cfg, m, "prefill", global_batch=B),
            build_rules(cfg, m, "decode", global_batch=B))
        lg, caches = make_prefill_step(cfg, rules[0], m)(
            params, lm.init_caches(cfg, B, MAX, "cpu"), batch)
        out = [lg]
        for i in range(STEPS):
            lg, caches = make_decode_step(cfg, rules[1], m)(
                params, caches, {"token": _tokens(cfg, s)[:, s + i:s + i + 1],
                                 "position": s + i})
            out.append(lg)
        runs.append(out)
    for a, b in zip(*reversed(runs)):
        _of_scale(a.numpy(), b.numpy(), SCALE_TOL)


@pytest.mark.parametrize("name", PLACEMENT_CASES)
def test_weights_carried_across_are_the_reference_pieces(ref, name):
    """The JAX ``init`` carried over and placed by the port's rules: every
    position's piece is, bitwise, the block of the whole leaf that the
    reference's sharding gives the same position (the weights a rule
    repeats, such as Mamba2's mixer, whole on every position); each
    tensor of the caches (K / V, the SSM state and conv window) is split
    into the reference's blocks. Both trees have a split leaf."""
    arch, shape, _, _, _ = CASES[name]
    cfg = _cfg(name)
    mesh = make_host_mesh(*shape, devices="cpu")
    rules = build_rules(cfg, mesh, "prefill", global_batch=B)
    params = _params(ref, name)
    placed = device_put(params, param_shardings(lm.lm_param_defs(cfg),
                                                rules, mesh))
    maps = json.loads((ref / "placements.json").read_text())[name]
    leaves, pieces = tree_leaves(params), tree_leaves(placed)
    assert len(maps["params"]) == len(leaves) == len(pieces)
    split = 0
    for whole, sharded, m in zip(leaves, pieces, maps["params"]):
        assert list(whole.shape) == m["shape"]
        for pos in mesh.positions():
            block = tuple(slice(a, b) for a, b in
                          m["pieces"][",".join(map(str, pos))])
            piece = sharded.pieces[pos]
            split += piece.shape != whole.shape
            assert torch.equal(piece, whole[block])
    assert split > 0
    cdefs = lm.lm_cache_defs(cfg, B, MAX)
    cache = [(d.shape, rules.sharding(mesh, *d.logical_axes))
             for d in tree_leaves(cdefs) if isinstance(d, ParamDef)]
    assert len(cache) == len(maps["caches"])
    split = 0
    for (shape, sharding), m in zip(cache, maps["caches"]):
        assert list(shape) == m["shape"]
        for pos, block in sharding.blocks(shape).items():
            got = [[sl.start, sl.stop] for sl in block]
            split += got != [[0, n] for n in shape]
            assert got == m["pieces"][",".join(map(str, pos))]
    assert split > 0


@pytest.mark.parametrize("k", [2, 4])
def test_new_collectives_are_their_definitions(k):
    """``psum_scatter``, tiled ``all_gather`` and ``pmean``
    on k positions, bitwise against their definitions: the fold in
    position order, then the position's block."""
    mesh = make_mesh((k,), ("m",), devices="cpu")
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(k, 3, 4 * k, 5)).astype(np.float32))
    total = x[0].clone()
    for i in range(1, k):
        total = total + x[i]

    def local(v):
        v = v[0]
        i = axis_index("m")
        return (psum_scatter(v, "m", scatter_dimension=1)[None],
                all_gather(v, "m", axis=1, tiled=True)[None],
                all_gather(v, "m", axis=2)[None],
                pmean(v, "m")[None], torch.tensor([i]))
    out = shard_map(local, mesh=mesh, in_specs=(P("m"),),
                    out_specs=(P("m"),) * 5)(x)
    scat, gath, stacked, mean, idx = (o.gather() for o in out)
    w = 4
    for i in range(k):
        assert torch.equal(scat[i], total[:, i * w:(i + 1) * w])
        assert torch.equal(gath[i], torch.cat(list(x), dim=1))
        assert torch.equal(stacked[i], torch.stack(list(x), dim=2))
        assert torch.equal(mean[i], total / k)
    assert idx.tolist() == list(range(k))
    with pytest.raises(ValueError, match="does not divide"):
        shard_map(lambda v: psum_scatter(v, "m", scatter_dimension=2),
                  mesh=mesh, in_specs=(P("m"),), out_specs=P("m"))(
            torch.zeros(k, 2, k + 1))


def test_logical_constraint_checks_the_local_piece():
    """Inside a position the local tensor must be its piece (a wrong one
    raises, naming the axes); outside a shard_map a mesh raises; without a
    mesh it is a no-op."""
    mesh = make_host_mesh(1, 2, devices="cpu")
    rules = ShardingRules(table={"batch": "data", "seq_sp": "model",
                                 "embed": None})
    x = torch.zeros(4, 16, 8)
    assert logical_constraint(x, "batch", "seq_sp", "embed", rules=None,
                              mesh=None) is x
    with pytest.raises(NotImplementedError, match="outside shard_map"):
        logical_constraint(x, "batch", "seq_sp", "embed", rules=rules,
                           mesh=mesh, shape=(4, 16, 8))

    def local(v, rows):
        return logical_constraint(v[:, :rows], "batch", "seq_sp", "embed",
                                  rules=rules, mesh=mesh, shape=(4, 16, 8))
    out = shard_map(lambda v: local(v, 8), mesh=mesh, in_specs=(P(),),
                    out_specs=P(None, "model"))(x)
    assert out.shape == (4, 16, 8)
    with pytest.raises(ValueError, match="seq_sp"):
        shard_map(lambda v: local(v, 16), mesh=mesh, in_specs=(P(),),
                  out_specs=P(None, "model"))(x)


def test_vocab_sharded_embedding_is_the_whole_lookup():
    """The vocab-parallel lookup (rows in range, zeros elsewhere, psum) is
    bitwise the gather from the whole table, tokens at both ends of every
    range included."""
    cfg = REDUCED["llama3-8b"]
    mesh = make_host_mesh(1, 4, devices="cpu")
    rules = build_rules(cfg, mesh, "decode")
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(cfg.vocab_pad, cfg.d_model, generator=gen)
    v_loc = cfg.vocab_pad // 4
    edges = [i * v_loc + j for i in range(4) for j in (0, v_loc - 1)]
    tokens = torch.tensor([edges, list(range(8))], dtype=torch.int32)
    want = lm._embed({"embed": table}, tokens, cfg, None)
    got = shard_map(lambda t, tk: lm._embed({"embed": t}, tk, cfg, None,
                                            rules=rules, mesh=mesh),
                    mesh=mesh, in_specs=(P("model"), P()),
                    out_specs=P())(table, tokens)
    for piece in got.pieces.flat:
        assert torch.equal(piece, want)


@pytest.mark.parametrize("tied", [False, True])
def test_vocab_sharded_unembedding_masks_by_the_global_column(tied):
    """The unembedding of a vocabulary padded past its size (500 of 512)
    on (1, 4): each position's columns, the padding masked by the global
    column index (only the last position holds any), gathered: the whole
    unembedding's logits within 1e-6 of their scale, the padding -1e30."""
    cfg = REDUCED["llama3-8b"].replace(vocab_size=500, tie_embeddings=tied)
    mesh = make_host_mesh(1, 4, devices="cpu")
    rules = build_rules(cfg, mesh, "decode")
    gen = torch.Generator().manual_seed(4)
    params = {"embed": torch.randn(cfg.vocab_pad, cfg.d_model,
                                   generator=gen),
              "unembed": torch.randn(cfg.d_model, cfg.vocab_pad,
                                     generator=gen)}
    x = torch.randn(2, 3, cfg.d_model, generator=gen)
    want = lm._unembed(params, x, cfg)
    specs = {"embed": P("model"), "unembed": P(None, "model")}
    got = shard_map(lambda p, v: lm._unembed(p, v, cfg, rules, mesh),
                    mesh=mesh, in_specs=(specs, P()),
                    out_specs=P())(params, x).gather()
    assert torch.all(got[..., cfg.vocab_size:] == -1e30)
    _of_scale(got[..., :cfg.vocab_size].numpy(),
              want[..., :cfg.vocab_size].numpy(), 1e-6)


@pytest.mark.parametrize("arch", ["deepseek-67b"])
def test_serving_steps_refuse_what_is_not_ported(arch):
    """Nothing is refused any more. FSDP is ported: deepseek-67b on
    (2, 1), its weights split over the data axis and gathered just in
    time, serves a prefill and two decode steps within 1e-5 of the scale
    of its unsharded steps, the caches too."""
    cfg = REDUCED[arch]
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = make_host_mesh(2, 1, devices="cpu")
    rules = build_rules(cfg, mesh, "prefill", global_batch=B)
    assert any("data" in rules.spec(*d.logical_axes)
               for d in tree_leaves(lm.lm_param_defs(cfg)))
    logits, cache = _serve(cfg, params, 16, mesh)
    want, wcache = _serve(cfg, params, 16)
    for a, b in zip(logits + [cache["k"], cache["v"]],
                    want + [wcache["k"], wcache["v"]]):
        _of_scale(a, b, SCALE_TOL)
