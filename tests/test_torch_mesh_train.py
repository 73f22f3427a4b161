"""Data-parallel training on the port's mesh, elastic restore and
compressed data parallelism, on ``devices="cpu"`` positions.

The DP step (``launch/steps.py::make_sharded_train_step`` under a table
that splits no weight) is held two ways:

  * against the port's unsharded step on the same weights and batch: the
    two steps' losses at 1e-5, and every gradient within 1e-5 of the
    gradients' scale (read from AdamW's first moment after one step at
    learning rate 0, m = (1 - b1) g);
  * against the reference from the same weights (the JAX ``init``,
    carried over as a JAX checkpoint): its unsharded step's losses at 1e-5,
    and its sharded step (GSPMD, ``tests/test_distributed.py::
    test_sharded_train_step_matches_unsharded``'s recipe) at that test's
    2e-2 on the loss: qwen1.5-0.5b on a (2, 2) mesh (its ``dp_only``
    profile folds ``model`` into the batch), olmoe-1b-7b on (4, 1) (with
    ``model`` of size 1 its experts are whole on every position). The
    reference's sharded MoE routes each shard's tokens as their own groups,
    with a capacity of their own and the aux averaged over shards, where
    the port routes the global groups; so for olmoe the sharded comparison
    runs at the capacity factor of the reference's expert-parallel test
    (64, no token dropped), as ``test_moe_expert_parallel_matches_local``
    does.

The JAX side runs in one subprocess with four fake host devices, which
writes the checkpoints and the losses.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.archs import REDUCED  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed.collectives import shard_map  # noqa: E402
from repro_torch.distributed.elastic import elastic_restore  # noqa: E402
from repro_torch.distributed.sharding import (P, Sharded,  # noqa: E402
                                              device_put, make_mesh,
                                              map_defs, param_shardings,
                                              zeros_like_defs)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build_rules, make_train_step  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.compression import ef_compressed_psum  # noqa: E402
from repro_torch.optim.optimizers import (get_optimizer,  # noqa: E402
                                          tree_leaves)

B, S = 8, 32
# the DP step against the port's unsharded step: float32 sums over the
# shards in another order (measured on the CPU: 7.7e-8 relative on the
# losses, 1.1e-7 of the scale on the gradients)
DP_TOL = 1e-5
# against the reference's sharded step: the reference's own tolerance for
# a sharded step (tests/test_distributed.py)
REF_LOSS_TOL = 2e-2
CASES = {"qwen1.5-0.5b": (2, 2), "olmoe-1b-7b": (4, 1)}
# the capacity factor of the sharded comparison (None: the config's)
SHARDED_CF = {"qwen1.5-0.5b": None, "olmoe-1b-7b": 64.0}

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
root, cases, cfs, B, S = sys.argv[1], CASES, SHARDED_CF, BATCH, SEQ
out = {}
for arch, shape in cases.items():
    cfg = REDUCED[arch]
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)), jnp.int32)
             for k in ('tokens', 'labels')}
    pdefs = lm.lm_param_defs(cfg)
    odefs = get_optimizer(cfg.optimizer).state_defs(pdefs)
    params = init_params(jax.random.PRNGKey(0), pdefs)
    ostate = init_params(jax.random.PRNGKey(0), odefs)
    ckpt.save(f'{root}/{arch}', 0, {'params': params, 'opt': ostate})
    step0 = jax.jit(make_train_step(cfg, tcfg, None, None))
    p, o, losses = params, ostate, []
    for _ in range(2):
        p, o, m = step0(p, o, batch)
        losses.append(float(m['loss']))
    out[arch + '|unsharded'] = losses
    if cfs[arch]:
        cfg = cfg.replace(capacity_factor=cfs[arch])
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
    losses = []
    for _ in range(2):
        p, o, m = step(p, o, bs)
        losses.append(float(m['loss']))
    out[arch + '|sharded'] = losses
    if arch == 'qwen1.5-0.5b':
        # the reference's elastic case: parameters saved from a (4, 1) mesh
        mesh_a = make_host_mesh(4, 1)
        rules_a = build_rules(cfg, mesh_a, 'train', global_batch=4)
        ckpt.save(f'{root}/elastic', 3,
                  jax.device_put(params, param_shardings(pdefs, rules_a,
                                                         mesh_a)))
json.dump(out, open(f'{root}/losses.json', 'w'))
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's checkpoints (JAX ``init``, key 0) and its sharded
    steps' losses, from one subprocess."""
    root = tmp_path_factory.mktemp("mesh_train_ref")
    code = (JAX_TRAIN.replace("sys.argv[1]", repr(str(root)))
            .replace("CASES", repr(CASES))
            .replace("SHARDED_CF", repr(SHARDED_CF)).replace("BATCH", str(B))
            .replace("SEQ", str(S)))
    run_with_devices(code, n=4)
    return root, json.loads((root / "losses.json").read_text())


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _like(cfg):
    pdefs = lm.lm_param_defs(cfg)
    return map_defs(lambda d: torch.empty(0),
                    {"params": pdefs,
                     "opt": get_optimizer(cfg.optimizer).state_defs(pdefs)})


def _state(root, arch):
    """The reference's initial parameters and optimizer state as the
    port's tensors (params requiring grad)."""
    cfg = REDUCED[arch]
    _, tree, _ = ckpt.restore_latest(root / arch, _like(cfg))
    for p in tree_leaves(tree["params"]):
        p.requires_grad_(True)
    return tree["params"], tree["opt"]


def _steps(cfg, tcfg, mesh, params, opt_state, n=2):
    rules = None if mesh is None else build_rules(cfg, mesh, "train",
                                                  global_batch=B)
    step = make_train_step(cfg, tcfg, rules, mesh)
    batch, losses = _batch(cfg), []
    for _ in range(n):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def _whole(x):
    return (x.gather() if isinstance(x, Sharded) else x).detach()


@pytest.mark.parametrize("arch", sorted(CASES))
def test_dp_step_matches_unsharded_step(ref, arch):
    """Two steps' losses at 1e-5; after one step at learning rate 0 every
    gradient (AdamW's m / (1 - b1)) within 1e-5 of the gradients' scale,
    and the parameters untouched; the replicas bitwise equal."""
    root, _ = ref
    cfg = REDUCED[arch]
    mesh = make_host_mesh(*CASES[arch], devices="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    _, _, want = _steps(cfg, tcfg, None, *_state(root, arch))
    params, _, got = _steps(cfg, tcfg, mesh, *_state(root, arch))
    np.testing.assert_allclose(got, want, rtol=DP_TOL)
    for leaf in tree_leaves(params):
        assert all(torch.equal(t, leaf.pieces.flat[0])
                   for t in leaf.pieces.flat)

    frozen = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                         grad_clip=1e9)
    _, o1, _ = _steps(cfg, frozen, None, *_state(root, arch), n=1)
    p2, o2, _ = _steps(cfg, frozen, mesh, *_state(root, arch), n=1)
    m1 = [_whole(x) for x in tree_leaves(o1["m"])]
    m2 = [_whole(x) for x in tree_leaves(o2["m"])]
    scale = max(float(m.abs().max()) for m in m1)
    worst = max(float((a - b).abs().max()) for a, b in zip(m1, m2))
    assert worst <= DP_TOL * scale, (worst, scale)
    p0, _ = _state(root, arch)
    for a, b in zip(tree_leaves(p0), tree_leaves(p2)):
        assert torch.equal(a.detach(), _whole(b))


@pytest.mark.parametrize("arch", sorted(CASES))
def test_dp_step_matches_reference_steps(ref, arch):
    root, losses = ref
    cfg = REDUCED[arch]
    mesh = make_host_mesh(*CASES[arch], devices="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    _, _, got = _steps(cfg, tcfg, mesh, *_state(root, arch))
    np.testing.assert_allclose(got, losses[arch + "|unsharded"], rtol=DP_TOL)
    if SHARDED_CF[arch]:
        cfg = cfg.replace(capacity_factor=SHARDED_CF[arch])
        _, _, got = _steps(cfg, tcfg, mesh, *_state(root, arch))
    want = losses[arch + "|sharded"]
    assert np.all(np.abs(np.asarray(got) - want) < REF_LOSS_TOL), (got, want)


def test_microbatches_inside_and_across_shards(ref):
    """k = 4 microbatches on 2 shards (each shard two whole ones) and k = 2
    on 4 (each microbatch over two shards, the MoE's groups across them):
    the unsharded step's losses at 1e-5."""
    root, _ = ref
    cfg = REDUCED["olmoe-1b-7b"]
    for k, shape in ((4, (2, 1)), (2, (4, 1))):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10, microbatches=k)
        _, _, want = _steps(cfg, tcfg, None, *_state(root, "olmoe-1b-7b"))
        _, _, got = _steps(cfg, tcfg, make_host_mesh(*shape, devices="cpu"),
                           *_state(root, "olmoe-1b-7b"))
        np.testing.assert_allclose(got, want, rtol=DP_TOL)
    with pytest.raises(NotImplementedError, match="microbatches"):
        make_train_step(cfg, TrainConfig(microbatches=3), None,
                        make_host_mesh(2, 1, devices="cpu"))


def test_a_rule_table_that_splits_a_weight_raises():
    """Every family trains on a model axis (tests/test_torch_model_train.py
    holds each against the unsharded step); what raises is a rule table
    whose mesh axis does not divide the dimension it splits. mamba2 with
    two SSD heads on a model axis of 4: its weights place (the heads are
    split in the activations), and the step fails with ``ValueError``
    naming the heads' dimension and the axis, before any update."""
    mesh = make_host_mesh(1, 4, devices="cpu")
    cfg = REDUCED["mamba2-2.7b"].replace(ssm_head_dim=64)
    assert cfg.ssm_heads == 2
    step = make_train_step(cfg, TrainConfig(),
                           build_rules(cfg, mesh, "train", global_batch=B),
                           mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt_state = zeros_like_defs(get_optimizer(cfg.optimizer).state_defs(
        lm.lm_param_defs(cfg)), "cpu")
    batch = {k: torch.zeros((B, S), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match=r"dim 2 .* does not divide by "
                                         r"axes \('model',\) \(4\)"):
        step(params, opt_state, batch)


def test_elastic_restore_across_meshes(ref, tmp_path):
    """The reference's case: parameters saved from a (4, 1) mesh restored
    onto (2, 2), bitwise, every position owning its piece; both the port's
    own checkpoint and the reference's."""
    root, _ = ref
    cfg = REDUCED["qwen1.5-0.5b"]
    pdefs = lm.lm_param_defs(cfg)
    params, _ = _state(root, "qwen1.5-0.5b")
    mesh_a = make_host_mesh(4, 1, devices="cpu")
    rules_a = build_rules(cfg, mesh_a, "train", global_batch=4)
    ckpt.save(tmp_path, 3, device_put(params,
                                      param_shardings(pdefs, rules_a,
                                                      mesh_a)))
    mesh_b = make_host_mesh(2, 2, devices="cpu")
    rules_b = build_rules(cfg, mesh_b, "train", global_batch=4)
    like = map_defs(lambda d: torch.empty(0), pdefs)
    for where in (tmp_path, root / "elastic"):
        step, restored, _ = elastic_restore(where, pdefs, rules_b, mesh_b,
                                            like)
        assert step == 3
        for a, b in zip(tree_leaves(params), tree_leaves(restored)):
            assert isinstance(b, Sharded) and b.mesh is mesh_b
            ptrs = {t.data_ptr() for t in b.pieces.flat}
            assert len(ptrs) == mesh_b.size
            for t in b.pieces.flat:
                assert torch.equal(t, a.detach())


def test_restore_rejects_shardings_of_another_structure(ref):
    root, _ = ref
    cfg = REDUCED["qwen1.5-0.5b"]
    mesh = make_host_mesh(2, 1, devices="cpu")
    like = _like(cfg)
    wrong = {"params": param_shardings(lm.lm_param_defs(cfg),
                                       build_rules(cfg, mesh, "train"),
                                       mesh)}
    with pytest.raises(ValueError, match="shardings"):
        ckpt.restore_latest(root / "qwen1.5-0.5b", like, shardings=wrong)


def test_compressed_dp_training_converges():
    """The reference's ``test_compressed_dp_training_converges``: 1-D least
    squares on a (4,) mesh, gradients reduced by ``ef_compressed_psum``
    with each position's error feedback, 200 steps to loss < 1e-3."""
    mesh = make_mesh((4,), ("pod",), devices="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    true_w = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    y = x @ true_w

    def local(w, err, xb, yb):
        w = w.detach().requires_grad_()
        g, = torch.autograd.grad(torch.mean((xb @ w - yb) ** 2), w)
        g_sum, e2 = ef_compressed_psum(g, err[0], "pod")
        return (w - 0.05 * g_sum / 4).detach(), e2[None]
    step = shard_map(local, mesh=mesh,
                     in_specs=(P(), P("pod"), P("pod"), P("pod")),
                     out_specs=(P(), P("pod")))
    w, err = torch.zeros(8), torch.zeros(4, 8)
    for _ in range(200):
        w, err = step(w, err, x, y)
        w, err = w.gather(), err.gather()
    final = float(torch.mean((x @ w - y) ** 2))
    assert final < 1e-3, final


def test_trainer_data_parallel_matches_one_position(tmp_path):
    """``--data-parallel 2`` trains reduced qwen1.5-0.5b on the CPU with the
    losses of the one-position run; its checkpoint (one unsharded copy)
    resumes on one position."""
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=2,
              checkpoint_every=0, seed=2)
    cfg = REDUCED["qwen1.5-0.5b"]
    one = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=32,
                  device="cpu").run(3, log_every=100)
    mesh = make_host_mesh(2, 1, devices="cpu")
    dp = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=32,
                 mesh=mesh, ckpt_dir=str(tmp_path)).run(3, log_every=100)
    np.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-5)
    back = Trainer(cfg, TrainConfig(**kw), global_batch=4, seq_len=32,
                   device="cpu", ckpt_dir=str(tmp_path))
    assert back.try_resume() and back.step == 3
    train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--data-parallel",
                "2", "--steps", "2", "--batch", "4", "--seq", "32",
                "--device", "cpu"])


def test_trainer_with_a_mesh_starts_from_replicated_state():
    cfg = REDUCED["qwen1.5-0.5b"]
    mesh = make_host_mesh(2, 2, devices="cpu")
    tr = Trainer(cfg, TrainConfig(seed=1), global_batch=4, seq_len=16,
                 mesh=mesh)
    tr.init_state()
    for leaf in tree_leaves(tr.params):
        assert isinstance(leaf, Sharded) and leaf.sharding.spec == P()
        assert all(t.requires_grad for t in leaf.pieces.flat)
        assert len({t.data_ptr() for t in leaf.pieces.flat}) == mesh.size
    zeros = zeros_like_defs(tr.odefs, "cpu")
    for a, b in zip(tree_leaves(zeros), tree_leaves(tr.opt_state)):
        assert torch.equal(a, b.gather())
