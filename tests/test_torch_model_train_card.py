"""Training under the model axis on the card (``cuda`` marker; the test
decides inside itself whether there is a card and skips where there is
none). No JAX here: the card's machine has none.

Two positions of a (1, 2) mesh share one card, so autograd runs both
positions' backward nodes on the card's one worker thread. The sharded
step must never wait at a rendezvous there (``distributed/collectives.py
::grad`` runs each collective's transpose in the position's own thread),
which the CPU cannot show: there autograd runs a backward in the calling
thread. The steps run under a 60 s rendezvous timeout, so a deadlock
fails naming the collective instead of hanging: a reduced llama3-8b and
a reduced recurrentgemma-2b (the RG-LRU split by width), each against
the unsharded step on the card.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import REDUCED
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.collectives import rendezvous_timeout
from repro_torch.distributed.sharding import zeros_like_defs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_rules, make_train_step
from repro_torch.models import lm
from repro_torch.optim.optimizers import get_optimizer, tree_leaves

B, S = 8, 32
# the sharded step against the unsharded one on the card: float32 sums
# over the positions in other orders, of the gradients' scale
TOL = 1e-5


def _step_against_unsharded(cfg):
    """One step of ``cfg`` at learning rate 0 unsharded, then on a (1, 2)
    mesh of two positions of the card under the 60 s rendezvous timeout:
    the loss within TOL of the unsharded step's and every gradient
    (AdamW's first moment) within TOL of the gradients' scale."""
    torch.backends.cuda.matmul.allow_tf32 = False
    frozen = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                         grad_clip=1e9)

    def fresh():
        params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        odefs = get_optimizer(cfg.optimizer).state_defs(
            lm.lm_param_defs(cfg))
        return params, zeros_like_defs(odefs, "cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int32)).cuda()
             for k in ("tokens", "labels")}
    _, o1, m1 = make_train_step(cfg, frozen)(*fresh(), batch)
    mesh = make_host_mesh(1, 2, devices=["cuda:0", "cuda:0"])
    step = make_train_step(cfg, frozen, build_rules(cfg, mesh, "train",
                                                    global_batch=B), mesh)
    with rendezvous_timeout(60.0):
        _, o2, m2 = step(*fresh(), batch)
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=TOL)
    want = [t.detach() for t in tree_leaves(o1["m"])]
    got = [t.gather("cuda").detach() for t in tree_leaves(o2["m"])]
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst <= TOL * scale, (worst, scale)


@pytest.mark.cuda
def test_model_axis_step_on_one_card_does_not_deadlock():
    """A reduced llama3-8b step (per-layer remat, float32, TF32 off) with
    two positions on one card under the rendezvous timeout: it finishes,
    and its loss and every gradient (AdamW's first moment after a step at
    learning rate 0) agree with the unsharded step's within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _step_against_unsharded(REDUCED["llama3-8b"].replace(remat=True))


@pytest.mark.cuda
def test_hybrid_model_axis_step_on_one_card(monkeypatch):
    """A reduced recurrentgemma-2b step (the RG-LRU split by width, its
    local attention's heads over one KV head; remat, float32) on (1, 2) on
    one card under the rendezvous timeout, against the unsharded step
    within 1e-5. Every rendezvous of the step, its backward's transposes
    and remat recomputes included, is met in a position's own thread,
    never on autograd's worker thread, and each position launches
    ``flash_attention_bwd`` twice for its one local layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.distributed import collectives
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    threads, exchange = set(), collectives._exchange

    def recorded(*args, **kwargs):
        threads.add(threading.current_thread().name)
        return exchange(*args, **kwargs)
    monkeypatch.setattr(collectives, "_exchange", recorded)
    cfg = REDUCED["recurrentgemma-2b"].replace(remat=True)
    flash_attention_bwd.launches = 0
    _step_against_unsharded(cfg)
    # one local layer: 2 launches unsharded, 2 on each of the 2 positions
    assert flash_attention_bwd.launches == 6
    assert threads and all(t.startswith("shard_map") for t in threads), \
        threads
