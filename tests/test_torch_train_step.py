"""The port's train step: per-layer remat, microbatches, every arch.

* per-layer remat (``torch.utils.checkpoint`` around each block) on equals
  remat off bitwise on the CPU;
* two microbatches (float32 gradient sums divided by 2) equal one batch;
* one ``make_train_step`` step of each of the 10 reduced architectures,
  the twin of ``tests/test_models_smoke.py``'s train step;
* ``batch_defs`` against the reference's, and the serving steps
  (``make_prefill_step``, ``make_decode_step``) against ``lm.prefill`` /
  ``lm.decode_step``.

Weights are the JAX ``init`` carried over by ``lm_params_from_jax``, as in
``test_torch_lm_loss.py``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.convert import lm_params_from_jax  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed.sharding import zeros_like_defs  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.optimizers import (get_optimizer,  # noqa: E402
                                          tree_leaves, tree_unflatten)


def _batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "mask": (rng.random((b, s)) < 0.8).astype(np.float32),
    }
    if cfg.prefix_len:
        batch["prefix_embed"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _models(arch, seed=0):
    jcfg, tcfg = jarchs.REDUCED[arch], tarchs.REDUCED[arch]
    jp = jinit(jax.random.PRNGKey(seed), jlm.lm_param_defs(jcfg))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b",
                                  "recurrentgemma-2b"])
def test_remat_on_equals_remat_off_bitwise(arch):
    """Per-layer remat (``torch.utils.checkpoint`` around each block)
    recomputes the same values in the backward: loss and gradients bitwise
    those without it."""
    _, tcfg, _, tp = _models(arch)
    batch = _torch_batch(_batch(tcfg, seed=9))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    out = []
    for remat in (False, True):
        loss, _ = tlm.lm_loss(tp, batch, tcfg.replace(remat=remat))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _train_once(tcfg, tp, batch, microbatches):
    params = tree_unflatten(tp, [p.detach().clone().requires_grad_()
                                 for p in tree_leaves(tp)])
    tr = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10,
                     microbatches=microbatches)
    state = zeros_like_defs(get_optimizer(tcfg.optimizer).state_defs(
        tlm.lm_param_defs(tcfg)), "cpu")
    step = make_train_step(tcfg, tr)
    params, state, metrics = step(params, state, batch)
    return params, state, metrics


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b",
                                  "mamba2-2.7b"])
def test_two_microbatches_equal_one_batch(arch):
    """Gradients summed in float32 over two halves and divided by 2 against
    the whole batch's (full masks, so each half's mean weighs its tokens
    as the whole batch's does): the same update to float32 rounding, and
    the metrics averaged. (Not an MoE: its capacity follows the tokens a
    group holds, so half a batch routes otherwise, in both packages.)"""
    _, tcfg, _, tp = _models(arch)
    batch = _batch(tcfg, seed=2, b=4)
    batch["mask"] = np.ones_like(batch["mask"])
    batch = _torch_batch(batch)
    p1, s1, m1 = _train_once(tcfg, tp, batch, 1)
    p2, s2, m2 = _train_once(tcfg, tp, batch, 2)
    assert int(s1["step"]) == int(s2["step"]) == 1
    for k in ("loss", "xent", "z_loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(tarchs.REDUCED))
def test_one_train_step_of_every_arch(arch):
    """The twin of ``tests/test_models_smoke.py``'s train step: finite
    metrics, the step counter at 1, and the parameters moved."""
    _, tcfg, _, tp = _models(arch)
    batch = _torch_batch(_batch(tcfg, seed=4))
    before = [p.detach().clone() for p in tree_leaves(tp)]
    params, state, metrics = _train_once(tcfg, tp, batch, 1)
    assert int(state["step"]) == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))


def test_batch_defs_match_the_reference():
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.steps import batch_defs as jdefs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import batch_defs
    for arch in ("qwen1.5-0.5b", "internvl2-2b"):
        ours = batch_defs(tarchs.REDUCED[arch],
                          ShapeConfig("train", 32, 4, "train"))
        ref = jdefs(jarchs.REDUCED[arch], JShape("train", 32, 4, "train"))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].shape == ref[k].shape


def test_serving_steps_are_prefill_and_decode():
    """``make_prefill_step`` / ``make_decode_step`` against ``lm.prefill``
    / ``lm.decode_step`` on fresh caches: the same logits, bitwise, and no
    graph."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    _, tcfg, _, tp = _models("recurrentgemma-2b")
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 12)))
    token = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 1)))
    for p in tree_leaves(tp):
        p.requires_grad_()
    out = []
    for prefill, decode in (
            (make_prefill_step(tcfg), make_decode_step(tcfg)),
            (lambda p, c, b: tlm.prefill(p, b["tokens"], c, tcfg),
             lambda p, c, i: tlm.decode_step(p, i["token"], c, tcfg,
                                             position=int(i["position"])))):
        caches = tlm.init_caches(tcfg, 2, 16, "cpu")
        # the steps bring their own no_grad; the direct calls are given one
        with torch.no_grad() if out else contextlib.nullcontext():
            first, caches = prefill(tp, caches, {"tokens": prompt})
            step, caches = decode(tp, caches, {"token": token,
                                               "position": torch.tensor(12)})
        out.append((first, step))
    assert out[0][0].grad_fn is None
    for a, b in zip(*out):
        assert torch.equal(a, b)
