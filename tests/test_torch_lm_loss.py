"""The port's training loss and its gradients against the JAX package's.

``repro_torch/models/lm.py::lm_loss`` (chunked cross-entropy under
checkpoint, the padded vocabulary masked, the final softcap, the z-loss,
the router's aux loss, ``mask`` and ``prefix_embed``) against
``repro/models/lm.py::lm_loss`` on the same JAX weights
(``lm_params_from_jax``) and the same seeded numpy batch, float32 on the
CPU:

* all 10 reduced architectures: the loss and its three parts, and every
  parameter leaf gets a finite gradient;
* ``jax.grad`` parity, leaf by leaf at 1e-5 of each leaf's gradient scale,
  for qwen (dense, tied), gemma2 (softcaps, window, post-norms), olmoe
  (the MoE through the kernels' backward), mamba2 (SSD), recurrentgemma
  (the RG-LRU, whose scan had to be repaired) and internvl2
  (``prefix_embed``).

``test_torch_train_step.py`` holds the train step built on it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import init_params as jinit  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.convert import lm_params_from_jax  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

TOL = 1e-5
GRAD_ARCHS = ("qwen1.5-0.5b", "gemma2-27b", "olmoe-1b-7b", "mamba2-2.7b",
              "recurrentgemma-2b", "internvl2-2b")


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


def _close(ours, ref, tol=TOL, what=""):
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1e-30, float(np.abs(ref).max()))
    err = float(np.abs(ours.detach().float().numpy() - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", sorted(tarchs.REDUCED))
def test_loss_matches_and_every_leaf_gets_a_gradient(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(jcfg, seed=len(arch))
    jtotal, jparts = jlm.lm_loss(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jcfg)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    total, parts = tlm.lm_loss(tp, _torch_batch(batch), tcfg)
    _close(total, jtotal, what="total")
    for k in ("xent", "aux", "z_loss"):
        assert parts[k].dtype == torch.float32 and parts[k].shape == ()
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=TOL, atol=1e-7)
    grads = torch.autograd.grad(total, leaves)
    for g, p in zip(grads, leaves):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
    assert any(bool(g.any()) for g in grads)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_grad(arch):
    jcfg, tcfg, jp, tp = _models(arch, seed=3)
    batch = _batch(jcfg, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: jlm.lm_loss(p, jb, jcfg)[0])(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    total, _ = tlm.lm_loss(tp, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(total, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        assert g.shape == r.shape
        _close(g, r, what=f"leaf {i}")


def test_loss_chunks_change_nothing_but_rounding():
    jcfg, tcfg, jp, tp = _models("gemma2-27b")
    batch = _torch_batch(_batch(jcfg, seed=5))
    one, _ = tlm.lm_loss(tp, batch, tcfg, loss_chunks=1)
    eight, _ = tlm.lm_loss(tp, batch, tcfg, loss_chunks=8)
    odd, _ = tlm.lm_loss(tp, batch, tcfg, loss_chunks=5)   # lowered to 4
    for x in (eight, odd):
        np.testing.assert_allclose(float(x), float(one), rtol=1e-6)
