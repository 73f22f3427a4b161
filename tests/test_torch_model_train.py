"""Training under the model axis on the port's mesh, on ``devices="cpu"``
positions: the sharded train step (``launch/steps.py::
make_sharded_train_step``) with the rule tables of ``build_rules(cfg,
mesh, "train")``: tensor, sequence, vocab and expert parallelism over
``model`` and FSDP over ``data``.

* Each collective's backward (``distributed/collectives.py``: the
  transpose ``grad`` runs between the segments of a position's graph)
  against autograd of the collective's unsharded definition, a loss that
  adds a weighted term of every position's output; also through
  ``checkpoint``'s remat.
* The repair: under grad a collective's output is a function of its own
  position's graph only (before it, a position's result held the other
  positions' graphs).
* The sharded step against the port's unsharded step from the same
  weights and batch: every arch of every family (mamba2's SSD split by
  heads, recurrentgemma's RG-LRU split by width among them) on (1, 2),
  (2, 1) and (2, 2), the loss at 1e-5 and every gradient within 1e-5 of
  the gradients' scale (AdamW's first moment after a step at learning
  rate 0, m = (1 - b1) g; for Adafactor its factored moments ``vr`` /
  ``vc``); two steps' losses and Adafactor's updated weights in the cases
  the reference runs.
* Against the reference's sharded step (GSPMD, ``tests/
  test_distributed.py::test_sharded_train_step_matches_unsharded``'s
  recipe) from the same weights (the JAX ``init``, carried over as a JAX
  checkpoint): llama3-8b and deepseek-67b (FSDP) on (2, 2) and
  mamba2-2.7b on (1, 2) at 1e-5 on two steps' losses and the grad norm;
  olmoe-1b-7b on (1, 2) at the capacity
  factor of the reference's expert-parallel test (64: its sharded MoE
  routes each shard's tokens as groups of their own) at its 2e-2.
* ``global_norm`` and Adafactor on split leaves against the whole leaves.
* The ``Trainer`` on a (2, 2) mesh with FSDP, its checkpoint resumed on
  another mesh; recurrentgemma-2b's on a (1, 2) model axis restored onto
  (1, 1) through ``elastic_restore``; a rendezvous that never completes
  failing by name.

The card's case (two positions on one card) is in
``tests/test_torch_model_train_card.py``.

The JAX side runs in one subprocess with four fake host devices.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.archs import REDUCED  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed.sharding import (P, Sharded,  # noqa: E402
                                              make_mesh, map_defs,
                                              zeros_like_defs)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_rules, make_train_step  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim.optimizers import (get_optimizer,  # noqa: E402
                                          tree_leaves)

B, S = 8, 32
# the sharded step against the port's unsharded step: float32 sums over
# the positions in other orders (measured on the CPU: up to 1.4e-7
# relative on the losses, 8.9e-7 of the scale on the gradients)
TOL = 1e-5
# against the reference's sharded MoE step: the reference's own tolerance
# for a sharded step (tests/test_distributed.py)
REF_MOE_TOL = 2e-2
ARCHS = sorted(REDUCED)
MESHES = ((1, 2), (2, 1), (2, 2))
# the two-step cases (arch, mesh shape)
CASES = (("llama3-8b", (1, 2)), ("llama3-8b", (2, 2)),
         ("deepseek-67b", (2, 2)), ("gemma2-27b", (2, 2)),
         ("olmoe-1b-7b", (1, 2)), ("arctic-480b", (2, 2)),
         ("recurrentgemma-2b", (2, 2)), ("mamba2-2.7b", (1, 2)))
# the comparison with the reference's sharded step: mesh, capacity factor
REF_CASES = {"llama3-8b": ((2, 2), None), "deepseek-67b": ((2, 2), None),
             "olmoe-1b-7b": ((1, 2), 64.0), "mamba2-2.7b": ((1, 2), None)}

JAX_TRAIN = """
import json, sys
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as ckpt
from repro.configs.archs import REDUCED
from repro.configs.base import ShapeConfig, TrainConfig
from repro.distributed.sharding import init_params, param_shardings
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import batch_defs, build_rules, make_train_step
from repro.models import lm
from repro.optim.optimizers import get_optimizer
root, cases, B, S = ROOT, CASES, BATCH, SEQ
out = {}
for arch, (shape, cf) in cases.items():
    cfg = REDUCED[arch]
    if cf:
        cfg = cfg.replace(capacity_factor=cf)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)), jnp.int32)
             for k in ('tokens', 'labels')}
    pdefs = lm.lm_param_defs(cfg)
    odefs = get_optimizer(cfg.optimizer).state_defs(pdefs)
    params = init_params(jax.random.PRNGKey(0), pdefs)
    ostate = init_params(jax.random.PRNGKey(0), odefs)
    ckpt.save(f'{root}/{arch}', 0, {'params': params, 'opt': ostate})
    mesh = make_host_mesh(*shape)
    rules = build_rules(cfg, mesh, 'train', global_batch=B)
    p_sh = param_shardings(pdefs, rules, mesh)
    o_sh = param_shardings(odefs, rules, mesh)
    b_sh = param_shardings(batch_defs(cfg, ShapeConfig('t', S, B, 'train')),
                           rules, mesh)
    step = jax.jit(make_train_step(cfg, tcfg, rules, mesh),
                   in_shardings=(p_sh, o_sh, b_sh),
                   out_shardings=(p_sh, o_sh, NamedSharding(mesh, P())))
    p, o = jax.device_put(params, p_sh), jax.device_put(ostate, o_sh)
    bs = {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(2):
        p, o, m = step(p, o, bs)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    out[arch] = {'losses': losses, 'grad_norms': norms}
json.dump(out, open(f'{root}/sharded.json', 'w'))
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's checkpoints (JAX ``init``, key 0) and its sharded
    steps' losses and grad norms, from one subprocess."""
    root = tmp_path_factory.mktemp("model_train_ref")
    code = (JAX_TRAIN.replace("ROOT", repr(str(root)))
            .replace("CASES", repr(REF_CASES)).replace("BATCH", str(B))
            .replace("SEQ", str(S)))
    run_with_devices(code, n=4)
    return root, json.loads((root / "sharded.json").read_text())


def _batch(cfg):
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.prefix_len:
        batch["prefix_embed"] = torch.randn(
            B, cfg.prefix_len, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    return batch


def _fresh(cfg):
    """The port's seed-0 parameters (requiring grad) and zero state."""
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    odefs = get_optimizer(cfg.optimizer).state_defs(lm.lm_param_defs(cfg))
    return params, zeros_like_defs(odefs, "cpu")


def _restored(root, arch):
    """The reference's initial parameters and optimizer state as the
    port's tensors (params requiring grad)."""
    cfg = REDUCED[arch]
    pdefs = lm.lm_param_defs(cfg)
    like = map_defs(lambda d: torch.empty(0),
                    {"params": pdefs,
                     "opt": get_optimizer(cfg.optimizer).state_defs(pdefs)})
    _, tree, _ = ckpt.restore_latest(root / arch, like)
    for p in tree_leaves(tree["params"]):
        p.requires_grad_(True)
    return tree["params"], tree["opt"]


def _steps(cfg, tcfg, shape, params, opt_state, n):
    mesh = None if shape is None else make_host_mesh(*shape, devices="cpu")
    rules = None if mesh is None else build_rules(cfg, mesh, "train",
                                                  global_batch=B)
    step = make_train_step(cfg, tcfg, rules, mesh)
    batch, metrics = _batch(cfg), []
    for _ in range(n):
        params, opt_state, m = step(params, opt_state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt_state, metrics


def _whole(x):
    return (x.gather() if isinstance(x, Sharded) else x).detach()


def _of_scale(got, want, tol=TOL):
    got = [_whole(x) for x in tree_leaves(got)]
    want = [_whole(x) for x in tree_leaves(want)]
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst <= tol * scale, (worst, scale)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a process: the positions are threads of their
    own, and under the suite's six workers torch's thread pools
    oversubscribe the CPUs (the file took 270 s in a full run at the
    default, 45 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FROZEN = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                     grad_clip=1e9)
LIVE = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _moments(o):
    return o["m"] if "m" in o else {"vr": o["vr"], "vc": o["vc"]}


# ---------------------------------------------------------------------------
# the collectives' transposes
# ---------------------------------------------------------------------------

def _unsharded(name, xs, k):
    """The collective's definition on the stacked values (k, ...): every
    position's output, stacked."""
    if name in ("psum", "checkpoint"):
        return torch.stack([xs.sum(0)] * k)
    if name == "pmean":
        return torch.stack([xs.sum(0) / k] * k)
    if name == "psum_scatter":
        w = xs.shape[2] // k
        return torch.stack([xs.sum(0)[:, i * w:(i + 1) * w]
                            for i in range(k)])
    if name == "all_gather_tiled":
        return torch.stack([torch.cat(list(xs), dim=1)] * k)
    if name == "all_gather":
        return torch.stack([torch.stack(list(xs), dim=0)] * k)
    if name == "ppermute":                     # a ring shift by one
        return torch.roll(xs, 1, dims=0)
    raise ValueError(name)


def _sharded(name, x, k):
    if name == "psum":
        return col.psum(x, "m")
    if name == "pmean":
        return col.pmean(x, "m")
    if name == "psum_scatter":
        return col.psum_scatter(x, "m", scatter_dimension=1)
    if name == "all_gather_tiled":
        return col.all_gather(x, "m", axis=1, tiled=True)
    if name == "all_gather":
        return col.all_gather(x, "m", axis=0)
    if name == "ppermute":
        return col.ppermute(x, "m", [(i, (i + 1) % k) for i in range(k)])
    if name == "checkpoint":       # a psum inside a remat'd function
        return col.checkpoint(lambda t: col.psum(t * 1.0, "m"), x)
    raise ValueError(name)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["psum", "pmean", "psum_scatter",
                                  "all_gather_tiled", "all_gather",
                                  "ppermute", "checkpoint"])
def test_collective_backward_is_the_definitions_gradient(name, k):
    """Each position p holds x_p; the global loss adds sum(w_p * y_p)
    over the positions, y = the collective. ``col.grad`` of each
    position's term with respect to its x_p: autograd of the unsharded
    definition, within float32 rounding."""
    mesh = make_mesh((k,), ("m",), devices="cpu")
    rng = np.random.default_rng(k)
    xs = torch.from_numpy(rng.normal(size=(k, 3, 4 * k)).astype(np.float32))
    xs_ref = xs.clone().requires_grad_()
    ys = _unsharded(name, xs_ref, k)
    ws = torch.from_numpy(rng.normal(size=ys.shape).astype(np.float32))
    want, = torch.autograd.grad((ws * ys).sum(), xs_ref)

    def local(x, w):
        x = x[0].clone().requires_grad_()
        y = _sharded(name, x, k)
        g, = col.grad((w[0] * y).sum(), [x])
        return g[None]
    got = col.shard_map(local, mesh=mesh, in_specs=(P("m"), P("m")),
                        out_specs=P("m"))(xs, ws).gather()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _reached(t):
    """The leaves whose gradient accumulators the graph of ``t`` reaches
    (``t`` itself if it is a leaf)."""
    if t.grad_fn is None:
        return [t]
    seen, out, todo = set(), [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        if hasattr(fn, "variable"):
            out.append(fn.variable)
        todo.extend(f for f, _ in fn.next_functions)
    return out


@pytest.mark.parametrize("name", ["psum", "psum_scatter",
                                  "all_gather_tiled"])
def test_a_collective_under_grad_keeps_to_its_own_graph(name):
    """Under grad mode a collective's output on a position reaches no
    other position's tensors: at the parent, the fold on the first
    position added the others' tensors themselves and the others took a
    clone of its sum, each joining every position's graph; all_gather
    concatenated them."""
    k = 2
    mesh = make_mesh((k,), ("m",), devices="cpu")
    xs = torch.randn(k, 3, 4 * k, generator=torch.Generator().manual_seed(0))
    mine = {}

    def local(x):
        x = x[0].clone().requires_grad_()
        mine[col.axis_index("m")] = x
        ids = [id(v) for v in _reached(_sharded(name, x, k))][:4]
        return torch.tensor([ids + [-1] * (4 - len(ids))])
    out = col.shard_map(local, mesh=mesh, in_specs=(P("m"),),
                        out_specs=P("m"))(xs).gather()
    for i in range(k):
        reached = set(out[i].tolist()) - {-1}
        others = {id(mine[j]) for j in range(k) if j != i}
        assert not reached & others, (i, name)


# ---------------------------------------------------------------------------
# the sharded step against the unsharded one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_trains_on_every_mesh(arch, shape):
    """One step at learning rate 0 from the port's seed-0 state: the loss
    at 1e-5, every gradient within 1e-5 of the gradients' scale (read from
    the optimizer's moments), the parameters untouched, every position's
    pieces finite."""
    cfg = REDUCED[arch]
    _, o1, m1 = _steps(cfg, FROZEN, None, *_fresh(cfg), n=1)
    p2, o2, m2 = _steps(cfg, FROZEN, shape, *_fresh(cfg), n=1)
    np.testing.assert_allclose(m2[0]["loss"], m1[0]["loss"], rtol=TOL)
    np.testing.assert_allclose(m2[0]["grad_norm"], m1[0]["grad_norm"],
                               rtol=TOL)
    _of_scale(_moments(o2), _moments(o1))
    p0, _ = _fresh(cfg)
    for a, b in zip(tree_leaves(p0), tree_leaves(p2)):
        assert torch.equal(a.detach(), _whole(b))


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_two_steps_match_the_unsharded_step(arch, shape):
    """Two steps at learning rate 1e-3: both losses and grad norms at 1e-5.
    With Adafactor (arctic-480b) also the updated weights and ``vr`` /
    ``vc`` within 1e-5 of their scale: its update divides by the factored
    moments and the update's RMS over the whole leaf. AdamW's weights are
    not compared: where a gradient is near zero its step is lr times the
    sign of the noise, up to 2e-3 apart for any two roundings."""
    cfg = REDUCED[arch]
    p1, o1, m1 = _steps(cfg, LIVE, None, *_fresh(cfg), n=2)
    p2, o2, m2 = _steps(cfg, LIVE, shape, *_fresh(cfg), n=2)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in m2],
                                   [m[key] for m in m1], rtol=TOL)
    if cfg.optimizer == "adafactor":
        _of_scale(p2, p1)
        _of_scale(_moments(o2), _moments(o1))


@pytest.mark.parametrize("arch", sorted(REF_CASES))
def test_sharded_step_matches_reference_sharded_step(ref, arch):
    root, sharded = ref
    shape, cf = REF_CASES[arch]
    cfg = REDUCED[arch]
    if cf:
        cfg = cfg.replace(capacity_factor=cf)
    _, _, ms = _steps(cfg, LIVE, shape, *_restored(root, arch), n=2)
    got = [m["loss"] for m in ms] + [ms[0]["grad_norm"]]
    want = sharded[arch]["losses"] + sharded[arch]["grad_norms"][:1]
    if cf:
        assert np.all(np.abs(np.asarray(got) - want) < REF_MOE_TOL), (got,
                                                                     want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL)


# ---------------------------------------------------------------------------
# the optimizers on pieces
# ---------------------------------------------------------------------------

# (shape, spec) of the leaves: replicated, split by one axis, by both, a
# stacked leaf split on its last two dimensions, a vector
LEAVES = (((8, 6), P()), ((8, 6), P("data")), ((8, 6), P(None, "model")),
          ((8, 6), P("data", "model")), ((2, 4, 6), P(None, "model", "data")),
          ((6,), P("model")))


def _split_run(fn, leaves, specs):
    """``fn(pieces)`` once a position of a (2, 2) mesh, each leaf split by
    its spec: the outputs' pieces (leaves like the inputs, then scalars)."""
    mesh = make_host_mesh(2, 2, devices="cpu")
    return col.shard_map(fn, mesh=mesh, in_specs=(list(specs),),
                         out_specs=P())(leaves)


def test_global_norm_of_split_leaves_counts_each_element_once():
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(s, generator=gen) for s, _ in LEAVES]
    specs = [sp for _, sp in LEAVES]
    want = opt.global_norm(leaves)
    got = _split_run(lambda ls: opt.global_norm(ls, specs)[None],
                     leaves, specs)
    for piece in got.pieces.flat:
        np.testing.assert_allclose(float(piece[0]), float(want), rtol=1e-6)


def test_adafactor_on_split_leaves_is_the_whole_update():
    """Two Adafactor updates of pieces (row and column means and the
    update RMS over the whole leaf) against the whole leaves: parameters,
    ``vr`` and ``vc`` within 1e-6 of their scale on every position."""
    gen = torch.Generator().manual_seed(1)
    defs = [opt.ParamDef(s, tuple(f"a{i}" for i in range(len(s))),
                         dtype=torch.float32) for s, _ in LEAVES]
    specs = [sp for _, sp in LEAVES]
    params = [torch.randn(d.shape, generator=gen) for d in defs]
    grads = [[torch.randn(d.shape, generator=gen) for d in defs]
             for _ in range(2)]
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    state_defs = opt.adafactor_state_defs(defs)

    def whole():
        p = [t.clone() for t in params]
        st = zeros_like_defs(state_defs, "cpu")
        for g in grads:
            p, st, _ = opt.adafactor_update(p, g, st, tcfg)
        return p, st
    want_p, want_s = whole()
    # the state's specs: vr drops the last dimension, vc the one before it
    vr_specs = [P(*(list(sp) + [None] * len(d.shape))[:len(d.shape) - 1])
                if opt._factored(d.shape) else sp
                for d, sp in zip(defs, specs)]
    vc_specs = [P(*((list(sp) + [None] * len(d.shape))[:len(d.shape) - 2]
                    + (list(sp) + [None] * len(d.shape))[len(d.shape) - 1:
                                                         len(d.shape)]))
                if opt._factored(d.shape) else P() for d, sp in zip(defs,
                                                                    specs)]
    mesh = make_host_mesh(2, 2, devices="cpu")

    def local(p, g0, g1, vr, vc):
        # each position updates its own copies (the pieces of a replicated
        # input are views of one tensor)
        st = {"step": torch.zeros((), dtype=torch.int32),
              "vr": [t.clone() for t in vr], "vc": [t.clone() for t in vc]}
        p = [t.clone() for t in p]
        for g in (g0, g1):
            p, st, _ = opt.adafactor_update(p, g, st, tcfg, specs=specs)
        return p, st["vr"], st["vc"]
    zeros = zeros_like_defs(state_defs, "cpu")
    got_p, got_vr, got_vc = col.shard_map(
        local, mesh=mesh,
        in_specs=(specs, specs, specs, vr_specs, vc_specs),
        out_specs=(specs, vr_specs, vc_specs))(
        params, grads[0], grads[1], zeros["vr"], zeros["vc"])
    for got, want in ((got_p, want_p), (got_vr, want_s["vr"]),
                      (got_vc, want_s["vc"])):
        for g, w in zip(got, want):
            for piece in g.pieces.flat:
                assert piece.shape == g.pieces.flat[0].shape
            _of_scale([g], [w], tol=1e-6)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def test_trainer_with_fsdp_and_a_model_axis(tmp_path):
    """deepseek-67b on (2, 2) (FSDP over data, the model axis) trains with
    the one-position run's losses at 1e-5; its checkpoint (one unsharded
    copy, the JAX format) resumes on a (1, 2) mesh, each position owning
    its pieces, and trains on with the one-position losses."""
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=2,
              checkpoint_every=0, seed=2)
    cfg = REDUCED["deepseek-67b"]
    one = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                  device="cpu").run(3, log_every=100)
    tr = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                 mesh=make_host_mesh(2, 2, devices="cpu"),
                 ckpt_dir=str(tmp_path))
    two = tr.run(2, log_every=100)
    split = [leaf for leaf in tree_leaves(tr.params)
             if leaf.pieces.flat[0].shape != leaf.shape]
    assert split and all(leaf.sharding.spec != P() for leaf in split)
    back = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                   mesh=make_host_mesh(1, 2, devices="cpu"),
                   ckpt_dir=str(tmp_path))
    assert back.try_resume() and back.step == 2
    for leaf in tree_leaves(back.params):
        assert len({t.data_ptr() for t in leaf.pieces.flat}) == 2
    last = back.run(1, log_every=100)
    np.testing.assert_allclose(two["losses"] + last["losses"],
                               one["losses"], rtol=TOL)


def test_trainer_on_a_model_axis_restores_onto_one_position(tmp_path):
    """recurrentgemma-2b on (1, 2) (the RG-LRU's width, the MLP's ff, the
    heads and the vocabulary split) trains two steps and saves its split
    state as one unsharded JAX-format checkpoint; ``elastic_restore``
    puts it on a (1, 1) mesh bitwise, and that run's next step and the
    mesh's two give the one-position run's losses at 1e-5."""
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=2,
              checkpoint_every=0, seed=3)
    cfg = REDUCED["recurrentgemma-2b"]
    one = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                  device="cpu").run(3, log_every=100)
    tr = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                 mesh=make_host_mesh(1, 2, devices="cpu"),
                 ckpt_dir=str(tmp_path))
    two = tr.run(2, log_every=100)
    assert any(leaf.pieces.flat[0].shape != leaf.shape
               for leaf in tree_leaves(tr.params))
    back = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=16,
                   mesh=make_host_mesh(1, 1, devices="cpu"),
                   ckpt_dir=str(tmp_path))
    assert back.try_resume() and back.step == 2
    for state in ("params", "opt_state"):
        for a, b in zip(tree_leaves(getattr(tr, state)),
                        tree_leaves(getattr(back, state))):
            assert torch.equal(_whole(a), _whole(b))
    last = back.run(1, log_every=100)
    np.testing.assert_allclose(two["losses"] + last["losses"],
                               one["losses"], rtol=TOL)


def test_a_sharded_step_leaves_nothing_to_the_cyclic_collector():
    """A reduced deepseek-67b step on (2, 2) (FSDP, remat) frees every
    tensor it made when its results are dropped, none left to the cyclic
    collector (a recursive closure in ``tree_unflatten`` once held every
    leaf list of a step: 52.5 GB on the card)."""
    import gc
    cfg = REDUCED["deepseek-67b"].replace(remat=True)
    step = make_train_step(cfg, LIVE, build_rules(
        cfg, make_host_mesh(2, 2, devices="cpu"), "train", global_batch=B),
        make_host_mesh(2, 2, devices="cpu"))
    gc.collect()
    gc.disable()
    try:
        alive = {id(o) for o in gc.get_objects()
                 if isinstance(o, torch.Tensor)}
        params, opt_state = _fresh(cfg)
        out = step(params, opt_state, _batch(cfg))
        del params, opt_state, out
        left = [o for o in gc.get_objects()
                if isinstance(o, torch.Tensor) and id(o) not in alive]
    finally:
        gc.enable()
    assert not left, len(left)


def test_a_rendezvous_that_never_completes_fails_by_name():
    """A position that never joins the second collective: with a
    rendezvous timeout the others fail naming it, and ``shard_map``
    returns even though that position's thread never does."""
    mesh = make_mesh((2,), ("m",), devices="cpu")
    never = threading.Event()

    def local(x):
        x = col.psum(x, "m")
        if col.axis_index("m") == 1:
            never.wait(30)              # held outside any rendezvous
        return col.all_gather(x, "m")
    with col.rendezvous_timeout(0.5):
        with pytest.raises((TimeoutError, RuntimeError),
                           match="all_gather|did not return"):
            col.shard_map(local, mesh=mesh, in_specs=(P(),),
                          out_specs=P())(torch.zeros(3))
    never.set()
