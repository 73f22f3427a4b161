"""The port's ``Trainer``: resume, loss falls, and checkpoints shared with
the JAX package's ``Trainer``.

The first two are the twins of ``tests/test_checkpoint.py``'s
``test_trainer_resume`` and ``test_trainer_loss_decreases`` (the CPU, the
same configs and steps). The cross-package test: the JAX ``Trainer`` runs
3 steps and saves; the port resumes from that directory and runs 3 more,
while the JAX ``Trainer`` resumes from a copy and runs the same 3; the
losses agree, the final parameters agree, and the JAX ``Trainer`` resumes
from the port's checkpoint.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.archs import REDUCED  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

# The two packages' losses on the same weights and tokens: float32 sums in
# other orders, through 3 AdamW steps (measured on the CPU: 7.2e-8
# relative at most)
LOSS_RTOL = 1e-5
# The final parameters after 3 AdamW steps from the same state. AdamW
# divides m by sqrt(v): where a gradient is near 0 the two packages'
# rounding differences are scaled up toward a step of lr (5e-3 here), so
# the bound is a share of the learning rate, not of the values (measured on
# the CPU: 7.5e-5 absolute, 1.5% of lr; held at 4% of it)
PARAM_ATOL = 2e-4


def test_trainer_resume(tmp_path):
    """Train, 'crash', resume: the step counter and state continue."""
    cfg = REDUCED["qwen1.5-0.5b"]
    tcfg = TrainConfig(learning_rate=5e-3, total_steps=40, warmup_steps=2,
                       checkpoint_every=5, seed=1)
    tr = Trainer(cfg, tcfg, global_batch=4, seq_len=32, device="cpu",
                 ckpt_dir=str(tmp_path))
    out1 = tr.run(6, log_every=100)
    assert out1["final_step"] == 6

    tr2 = Trainer(cfg, tcfg, global_batch=4, seq_len=32, device="cpu",
                  ckpt_dir=str(tmp_path))
    assert tr2.try_resume()
    assert tr2.step == 6          # final on-exit save wins over periodic 5
    assert int(tr2.opt_state["step"]) == 6
    for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
        assert torch.equal(a.detach(), b.detach()) and b.requires_grad
    out2 = tr2.run(3, log_every=100)
    assert out2["final_step"] == 9


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: beside the suite's other workers,
    torch's default of a thread per core in every worker oversubscribes
    the cores, and the 50 steps ran 20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trainer_loss_decreases(one_thread):
    cfg = REDUCED["qwen1.5-0.5b"]
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=60, warmup_steps=5,
                       checkpoint_every=0, seed=0)
    tr = Trainer(cfg, tcfg, global_batch=8, seq_len=64, device="cpu",
                 ckpt_dir=None)
    out = tr.run(50, log_every=1000)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.3, (first, last)


def test_trainer_saves_on_a_crash(tmp_path):
    """A step that raises: the last good state is saved, then the error
    propagates."""
    cfg = REDUCED["qwen1.5-0.5b"]
    tcfg = TrainConfig(total_steps=10, warmup_steps=1, checkpoint_every=0)
    tr = Trainer(cfg, tcfg, global_batch=2, seq_len=16, device="cpu",
                 ckpt_dir=str(tmp_path))
    real = tr.step_fn
    calls = []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected")
        return real(*a)
    tr.step_fn = flaky
    with pytest.raises(RuntimeError, match="injected"):
        tr.run(5)
    assert jckpt.list_steps(tmp_path) == [2]


def test_trainer_main_refuses_a_mesh(capsys):
    """``--model-parallel 2`` refuses no family any more: a ``tp``-profile
    arch and an SSM model (its SSD split by heads) each train two steps
    on the model axis to the end."""
    from repro_torch.launch import train
    for arch in ("llama3-8b", "mamba2-2.7b"):
        train.main(["--arch", arch, "--reduced", "--model-parallel", "2",
                    "--steps", "2", "--batch", "4", "--seq", "32",
                    "--device", "cpu"])
        assert "done: step=2" in capsys.readouterr().out


def test_checkpoints_cross_between_the_packages(tmp_path):
    arch = "qwen1.5-0.5b"
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=2,
              checkpoint_every=0, seed=2)
    a, b = tmp_path / "a", tmp_path / "b"
    jt = JTrainer(jarchs.REDUCED[arch], JTrainConfig(**kw), global_batch=4,
                  seq_len=32, ckpt_dir=str(a))
    assert jt.run(3, log_every=100)["final_step"] == 3
    shutil.copytree(a, b)

    ours = Trainer(REDUCED[arch], TrainConfig(**kw), global_batch=4,
                   seq_len=32, device="cpu", ckpt_dir=str(a))
    out = ours.run(3, log_every=100)            # resumes from JAX's step 3
    assert out["final_step"] == 6
    jt2 = JTrainer(jarchs.REDUCED[arch], JTrainConfig(**kw), global_batch=4,
                   seq_len=32, ckpt_dir=str(b))
    ref = jt2.run(3, log_every=100)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL)

    # both packages' parameters after step 6, leaf for leaf
    theirs = jax.tree.leaves(jt2.params)
    mine = tree_leaves(ours.params)
    assert len(theirs) == len(mine)
    for x, y in zip(mine, theirs):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   atol=PARAM_ATOL, rtol=0)
    assert sorted(jckpt.list_steps(a)) == [3, 6]

    # and the JAX Trainer resumes from the port's checkpoint
    jt3 = JTrainer(jarchs.REDUCED[arch], JTrainConfig(**kw), global_batch=4,
                   seq_len=32, ckpt_dir=str(a))
    assert jt3.try_resume() and jt3.step == 6
    assert int(jt3.opt_state["step"]) == 6
    for x, y in zip(mine, jax.tree.leaves(jt3.params)):
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(y))
