"""The port's checkpoints (``repro_torch/checkpoint/checkpoint.py``) against
``tests/test_checkpoint.py`` and against the JAX package's own format.

The reference's cases on a tree of tensors (round trip, ``keep_n``, a
corrupt newest step falling back, a torn write never seen), then interop:
a GIN or PNA parameter tree written by ``repro.checkpoint`` restores
bitwise through the port and the reverse, with the same leaf keys, file
names, shapes, dtypes and CRCs in both manifests; both refuse a leaf whose
CRC does not match; a bfloat16 leaf crosses bitwise both ways, written as
the same bytes; an opaque dtype the port cannot read raises.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_numpy,  # noqa: E402
                                            params_to_numpy)
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.tensor(3.5)},
            "layers": [torch.randn(3, generator=g),
                       torch.randn(2, 2, generator=g)]}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._leaf_paths(tree)]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def _small(name):
    cfg = JCFG[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _jax_params(name):
    cfg = _small(name)
    return jmake(cfg).init(jax.random.PRNGKey(0), cfg)


# ---------------------------------------------------------------------------
# the reference's cases, on tensors
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 7, t, extra={"note": "x"})
    restored, extra = ckpt.restore(tmp_path, 7, t)
    _assert_bitwise(t, restored)
    assert extra == {"note": "x"}
    assert isinstance(restored["layers"], list)


def test_keep_n_prunes(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(tmp_path, s, t, keep_n=3)
    assert ckpt.list_steps(tmp_path) == [3, 4, 5]


def test_corrupt_latest_falls_back(tmp_path):
    t0, t1 = _tree(0), _tree(1)
    ckpt.save(tmp_path, 1, t0)
    ckpt.save(tmp_path, 2, t1)
    victim = next((tmp_path / "step_0000000002").glob("leaf_*.npy"))
    victim.write_bytes(b"garbage")
    step, tree, _ = ckpt.restore_latest(tmp_path, t0)
    assert step == 1
    _assert_bitwise(t0, tree)


def test_torn_write_invisible(tmp_path):
    """A tmp dir from a crashed writer is never picked up."""
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    (tmp_path / ".tmp_step_0000000002").mkdir()
    assert ckpt.restore_latest(tmp_path, t)[0] == 1
    assert ckpt.list_steps(tmp_path) == [1]


def test_restore_latest_of_nothing_and_shardings(tmp_path):
    """``shardings=`` places each restored leaf on its mesh sharding (every
    position owning its block, bitwise the saved values; a ``None``
    sharding restores as without); shardings of another structure than
    ``like`` raise ``ValueError``."""
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  Sharded, make_mesh)
    t = _tree()
    assert ckpt.restore_latest(tmp_path / "none", t) is None
    ckpt.save(tmp_path, 1, t)
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    rows, whole = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    sh = {"a": rows, "nested": {"b": whole, "c": None},
          "layers": [whole, NamedSharding(mesh, P("model", "data"))]}
    tree, _ = ckpt.restore(tmp_path, 1, t, shardings=sh)
    assert not isinstance(tree["nested"]["c"], Sharded)
    _assert_bitwise(t, {**tree, "a": tree["a"].gather(),
                        "nested": {**tree["nested"],
                                   "b": tree["nested"]["b"].gather()},
                        "layers": [x.gather() for x in tree["layers"]]})
    np.testing.assert_array_equal(tree["a"].pieces[1, 0].numpy(),
                                  t["a"][4:].numpy())
    np.testing.assert_array_equal(tree["layers"][1].pieces[0, 1].numpy(),
                                  t["layers"][1][1:, :1].numpy())
    for wrong in (t, {**sh, "nested": {"b": whole}},
                  {**sh, "layers": [whole]}):
        with pytest.raises(ValueError, match="shardings"):
            ckpt.restore(tmp_path, 1, t, shardings=wrong)
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, 2, t)


def test_leaf_keys_are_the_reference_keys():
    """Keys and order as ``jax.tree_util.tree_flatten_with_path`` gives
    them: dict keys sorted and bracketed, list indices, NamedTuple fields
    as attributes, None an empty subtree."""
    from collections import namedtuple
    nt = namedtuple("NT", ["a", "b"])
    tree = {"w1": 1, "layers": [{"b": 2, "a": 3}, (4, 5)], "nt": nt(6, 7),
            "c": None, "z": 8}
    want = [k for k, _ in jckpt._leaf_paths(tree)]
    assert [k for k, _ in ckpt._leaf_paths(tree)] == want
    assert [v for _, v in ckpt._leaf_paths(tree)] == [3, 2, 4, 5, 6, 7, 1, 8]


# ---------------------------------------------------------------------------
# interop with the JAX package's checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gin", "pna"])
def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, name):
    jparams = _jax_params(name)
    jckpt.save(tmp_path / "jax", 3, jparams, extra={"from": "jax"})
    host = jax.tree_util.tree_map(np.asarray, jparams)
    like = params_from_numpy(host, device="cpu")
    got, extra = ckpt.restore(tmp_path / "jax", 3, like)
    assert extra == {"from": "jax"}
    want = params_from_numpy(host, device="cpu")
    _assert_bitwise(want, got)
    # the port's tree has the JAX tree's nesting: it serves directly
    cfg = PAPER_GNN_CONFIGS[name].replace(**{
        k: getattr(_small(name), k) for k in ("num_layers", "hidden_dim",
                                             "head_mlp")})
    ref = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert [k for k, _ in ckpt._leaf_paths(ref)] == [
        k for k, _ in ckpt._leaf_paths(got)]


@pytest.mark.parametrize("name", ["gin", "pna"])
def test_port_checkpoint_restores_bitwise_in_jax(tmp_path, name):
    jparams = _jax_params(name)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    ckpt.save(tmp_path / "port", 4, tparams, extra={"from": "port"})
    got, extra = jckpt.restore(tmp_path / "port", 4, jparams)
    assert extra == {"from": "port"}
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(got)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["gin", "pna"])
def test_both_packages_write_the_same_files(tmp_path, name):
    """The same tree saved by each package: equal manifests (keys, file
    names, shapes, dtypes, CRCs) and byte-equal leaf files."""
    jparams = _jax_params(name)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    jdir = jckpt.save(tmp_path / "jax", 1, jparams)
    tdir = ckpt.save(tmp_path / "port", 1, tparams)
    assert _manifest(jdir) == _manifest(tdir)
    for f in sorted(jdir.glob("leaf_*.npy")):
        assert f.read_bytes() == (tdir / f.name).read_bytes(), f.name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_sides_refuse_a_bad_crc(tmp_path, writer):
    """A leaf whose bytes changed but still parse as an array: the CRC
    fails, restore raises on both sides and restore_latest falls back."""
    jparams = _jax_params("gin")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    save = jckpt.save if writer == "jax" else ckpt.save
    save(tmp_path, 1, jparams if writer == "jax" else tparams)
    path = save(tmp_path, 2, jparams if writer == "jax" else tparams)
    victim = sorted(path.glob("leaf_*.npy"))[0]
    arr = np.load(victim)
    np.save(victim, arr + np.ones_like(arr))
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, 2, tparams)
    with pytest.raises(IOError):
        jckpt.restore(tmp_path, 2, jparams)
    assert ckpt.restore_latest(tmp_path, tparams)[0] == 1
    assert jckpt.restore_latest(tmp_path, jparams)[0] == 1


def test_bf16_leaves_cross_bitwise_both_ways(tmp_path):
    """A bfloat16 leaf written by JAX (an ml_dtypes array, '<V2' in the
    .npy header) restores into torch.bfloat16 bitwise, and the port writes
    it back as the same bytes, so the JAX side's CRC checks too."""
    r = np.random.default_rng(0)
    jtree = {"w": jnp.asarray(r.standard_normal((5, 3)), jnp.bfloat16),
             "b": jnp.asarray(r.standard_normal(3), jnp.float32)}
    jdir = jckpt.save(tmp_path / "jax", 1, jtree)
    like = {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
            "b": torch.zeros(3)}
    got, _ = ckpt.restore(tmp_path / "jax", 1, like)
    assert got["w"].dtype == torch.bfloat16
    want = np.asarray(jtree["w"]).view(np.uint16)
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy()
                                  .view(np.uint16), want)
    tdir = ckpt.save(tmp_path / "port", 1, got)
    assert _manifest(tdir) == _manifest(jdir)
    for f in sorted(jdir.glob("leaf_*.npy")):
        assert f.read_bytes() == (tdir / f.name).read_bytes(), f.name
    assert jckpt._validate(tdir) is not None
    again, _ = ckpt.restore(tmp_path / "port", 1, like)
    assert torch.equal(again["w"].view(torch.int16),
                       got["w"].view(torch.int16))


def test_an_opaque_dtype_the_port_cannot_read_raises(tmp_path):
    jtree = {"w": jnp.asarray(np.ones(4), ml_dtypes.float8_e4m3fn)}
    jckpt.save(tmp_path, 1, jtree)
    with pytest.raises(ValueError, match="cannot be read"):
        ckpt.restore(tmp_path, 1, {"w": torch.zeros(4)})


def test_params_to_numpy_round_trip_through_a_checkpoint(tmp_path):
    """The port's own serving params (random, from a seed) survive a
    save / restore bitwise, also read back as numpy."""
    cfg = PAPER_GNN_CONFIGS["gat"]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    ckpt.save(tmp_path, 1, params)
    got, _ = ckpt.restore(tmp_path, 1, params)
    _assert_bitwise(params, got)
    a, b = params_to_numpy(params), params_to_numpy(got)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_cuda_restore_lands_on_like_devices(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    like = {"a": t["a"].cuda(), "nested": t["nested"], "layers": [
        t["layers"][0].cuda(), t["layers"][1]]}
    got, _ = ckpt.restore(tmp_path, 1, like)
    assert got["a"].device.type == "cuda"
    assert got["layers"][0].device.type == "cuda"
    assert got["nested"]["b"].device.type == "cpu"
    assert torch.equal(got["a"].cpu(), t["a"])
