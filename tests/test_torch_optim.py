"""The port's optimizers against ``repro/optim/optimizers.py``.

``lr_schedule``, ``clip_by_global_norm``, one AdamW and one Adafactor
update on the same trees (random parameters, gradients and a state some
steps in, both factored and unfactored leaves, float32 and bfloat16
parameters), the factored state's shapes, and the reference's quadratic
test. float32 at 1e-6 relative (the same arithmetic, leaf by leaf), a
bfloat16 parameter within one bf16 unit of the reference's (both round one
float32 value). Also ``checkpoint/convert.py::opt_state_from_jax`` on a
reduced LM's AdamW and Adafactor states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.distributed.sharding import ParamDef as JDef  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed.sharding import ParamDef  # noqa: E402
from repro_torch.distributed.sharding import zeros_like_defs  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

SHAPES = {"w": (8, 6), "b": (6,), "e": (3, 4, 5), "col": (7, 1)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              SHAPES.items()}
    grads = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in
             SHAPES.items()}
    return params, grads


def _jtree(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _ttree(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dtype)
            for k, v in tree.items()}


def test_lr_schedule_matches_reference():
    cfg = TrainConfig(learning_rate=0.3, warmup_steps=10, total_steps=100)
    jcfg = JTrainConfig(learning_rate=0.3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        ours = topt.lr_schedule(torch.tensor(s, dtype=torch.int32), cfg)
        ref = jopt.lr_schedule(jnp.asarray(s, jnp.int32), jcfg)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    lrs = [float(topt.lr_schedule(torch.tensor(s), cfg))
           for s in range(0, 101, 10)]
    assert lrs[0] < lrs[1] == max(lrs) and lrs[-1] < 0.2 * lrs[1]


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _trees(1)
    ours, gn = topt.clip_by_global_norm(_ttree(grads), max_norm)
    ref, rgn = jopt.clip_by_global_norm(_jtree(grads), max_norm)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


def _state(name, params, seed, step):
    """The same optimizer state on both sides, a few steps in."""
    rng = np.random.default_rng(seed)
    jdefs = {k: JDef(v.shape, (None,) * v.ndim, dtype=jnp.float32)
             for k, v in params.items()}
    jsd = jopt.get_optimizer(name).state_defs(jdefs)
    state = {"step": np.int32(step)}
    for key in jsd:
        if key == "step":
            continue
        state[key] = {k: np.abs(rng.normal(size=d.shape)).astype(np.float32)
                      * 0.1 for k, d in jsd[key].items()}
    jstate = {"step": jnp.asarray(step, jnp.int32),
              **{key: _jtree(v) for key, v in state.items() if key != "step"}}
    tstate = {"step": torch.tensor(step, dtype=torch.int32),
              **{key: _ttree(v) for key, v in state.items() if key != "step"}}
    return jstate, tstate


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_one_update_matches_reference(name, pdtype):
    params, grads = _trees(2)
    cfg = TrainConfig(learning_rate=0.01, warmup_steps=3, total_steps=50,
                      weight_decay=0.1, grad_clip=1.0)
    jcfg = JTrainConfig(learning_rate=0.01, warmup_steps=3, total_steps=50,
                        weight_decay=0.1, grad_clip=1.0)
    jstate, tstate = _state(name, params, seed=3, step=4)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if pdtype == "bfloat16"
              else (jnp.float32, torch.float32))
    jparams, jnew = jopt.get_optimizer(name).update(
        _jtree(params, jd), _jtree(grads, jd), jstate, jcfg)[:2]
    tparams = _ttree(params, td)
    tp, tnew, metrics = topt.get_optimizer(name).update(
        tparams, _ttree(grads, td), tstate, cfg)
    assert tp is tparams                      # updated in place
    assert int(tnew["step"]) == 5 and tnew["step"].dtype == torch.int32
    for k in params:
        assert tp[k].dtype == td
        rtol = 1e-6 if pdtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jparams[k], np.float32),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    for key in tnew:
        if key == "step":
            continue
        for k in params:
            np.testing.assert_allclose(tnew[key][k].numpy(),
                                       np.asarray(jnew[key][k]), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{key}/{k}")
    assert float(metrics["grad_norm"]) > 0 and float(metrics["lr"]) > 0


def test_adafactor_state_is_factored():
    defs = {"w": ParamDef((64, 32), dtype=torch.bfloat16),
            "e": ParamDef((4, 64, 32), dtype=torch.bfloat16),
            "b": ParamDef((32,), dtype=torch.bfloat16)}
    sd = topt.adafactor_state_defs(defs)
    assert sd["vr"]["w"].shape == (64,) and sd["vc"]["w"].shape == (32,)
    assert sd["vr"]["e"].shape == (4, 64) and sd["vc"]["e"].shape == (4, 32)
    assert sd["vr"]["b"].shape == (32,) and sd["vc"]["b"].shape == (1,)
    assert sd["step"].dtype == torch.int32
    assert all(d.dtype == torch.float32 for d in
               (sd["vr"]["w"], sd["vc"]["w"]))
    full = topt.adamw_state_defs(defs)
    assert full["v"]["w"].shape == (64, 32)
    assert full["m"]["w"].dtype == torch.float32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    """The reference's quadratic: 60 steps toward 0.5 from a random start
    must cut the loss by 5x."""
    cfg = TrainConfig(learning_rate=0.05, warmup_steps=1, total_steps=200,
                      weight_decay=0.0)
    opt = topt.get_optimizer(name)
    defs = {"w": ParamDef((8, 8), dtype=torch.float32),
            "b": ParamDef((8,), init="zeros", dtype=torch.float32)}
    gen = torch.Generator().manual_seed(0)
    from repro_torch.distributed.sharding import init_params
    params = init_params(gen, defs, "cpu")
    state = zeros_like_defs(opt.state_defs(defs), "cpu")

    def loss_fn(p):
        return sum(((v - 0.5) ** 2).sum() for v in p.values())
    l0 = float(loss_fn(params))
    for _ in range(60):
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        g = torch.autograd.grad(loss_fn(leaves), list(leaves.values()))
        params, state, extras = opt.update(
            params, dict(zip(leaves, g)), state, cfg)
    assert float(loss_fn(params)) < 0.2 * l0
    assert float(extras["grad_norm"]) >= 0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "arctic-480b"])
def test_opt_state_from_jax_carries_the_state_over(arch):
    """``checkpoint/convert.py::opt_state_from_jax``: a JAX optimizer state
    of a reduced LM (AdamW for qwen, Adafactor for arctic), filled with
    seeded values, comes over leaf for leaf with the port's dtypes; a
    misshapen leaf raises ``ValueError``."""
    from repro.configs import archs as jarchs
    from repro.distributed.sharding import init_params as jinit
    from repro.models import lm as jlm
    from repro_torch.checkpoint.convert import opt_state_from_jax
    from repro_torch.configs import archs as tarchs
    jcfg, tcfg = jarchs.REDUCED[arch], tarchs.REDUCED[arch]
    jdefs = jopt.get_optimizer(jcfg.optimizer).state_defs(
        jlm.lm_param_defs(jcfg))
    rng = np.random.default_rng(7)
    state = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=np.shape(a)).astype(
            np.asarray(a).dtype) if np.asarray(a).dtype != np.int32
        else np.int32(9), jinit(jax.random.PRNGKey(0), jdefs))
    ours = opt_state_from_jax(state, tcfg, "cpu")
    assert ours["step"].dtype == torch.int32 and int(ours["step"]) == 9
    theirs = jax.tree.leaves(state)
    mine = topt.tree_leaves(ours)
    assert len(theirs) == len(mine)
    for a, b in zip(mine, theirs):
        if a.dtype != torch.int32:
            assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = "m" if jcfg.optimizer == "adamw" else "vr"
    state[key]["final_norm"]["scale"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        opt_state_from_jax(state, tcfg, "cpu")
