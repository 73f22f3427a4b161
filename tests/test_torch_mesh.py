"""The port's mesh against the JAX package's: collectives, GPipe,
compression, placements and ``remesh_plan``.

The JAX side runs as ``tests/test_distributed.py`` runs it: in one
subprocess with four fake host devices (``conftest.py::run_with_devices``),
which computes every case of this file and returns them in one ``.npz``.
The port runs the same inputs on ``devices="cpu"`` positions, one thread a
position. The collectives and the compression are held bitwise (the
reference's ring shifts, mask + psum broadcasts, absmax int8 quantisation,
int32 sums and ``pmax`` of the scales are exact in float32); the GPipe
schedule at 1e-5, the tolerance of ``test_pipeline_parallel_matches_
sequential``; placements and ``remesh_plan`` spec for spec and message for
message.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed.sharding import ParamDef as JParamDef  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import get_optimizer as jget  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.elastic import remesh_plan  # noqa: E402
from repro_torch.distributed.pipeline import (broadcast_from,  # noqa: E402
                                              pipeline_apply, ring_shift)
from repro_torch.distributed.sharding import (P, ParamDef,  # noqa: E402
                                              abstract_params, make_mesh,
                                              make_rules, param_count,
                                              param_specs)
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.steps import build_rules  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer as tget  # noqa: E402

# the GPipe schedule against the reference: float32 products in another
# order (tests/test_distributed.py's own tolerance)
PIPE_TOL = 1e-5
MESHES = ((4, 1), (2, 2), (1, 4))


def _inputs():
    """Every case's inputs, from seeds, as numpy."""
    rng = np.random.default_rng(0)
    return {
        "ring": rng.normal(size=(4, 3, 5)).astype(np.float32),
        "bcast": rng.normal(size=(4, 2, 3)).astype(np.float32),
        "quant": rng.normal(size=(4, 64)).astype(np.float32)
        * np.array([[1.0], [3e-3], [250.0], [0.0]], np.float32),
        "err": rng.normal(size=(4, 64)).astype(np.float32) * 1e-2,
        "tree_a": rng.normal(size=(4, 8, 3)).astype(np.float32),
        "tree_b": rng.normal(size=(4, 5)).astype(np.float32) * 7.0,
        "err_a": rng.normal(size=(4, 8, 3)).astype(np.float32) * 1e-3,
        "err_b": rng.normal(size=(4, 5)).astype(np.float32) * 1e-3,
        "pipe2_w": rng.normal(size=(2, 16, 16)).astype(np.float32) * 0.3,
        "pipe2_x": rng.normal(size=(4, 8, 16)).astype(np.float32),
        "pipe4_w": rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.3,
        "pipe4_x": rng.normal(size=(3, 4, 8)).astype(np.float32),
    }


JAX_CASES = """
import json, sys
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.archs import ARCHS
from repro.distributed.elastic import remesh_plan
from repro.distributed.pipeline import broadcast_from, pipeline_apply, ring_shift
from repro.distributed.sharding import ParamDef, compat_shard_map, make_rules
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_rules
from repro.models import lm
from repro.optim.compression import (compressed_psum, ef_compressed_psum,
                                     quantize_int8, tree_ef_compressed_psum)
inp = dict(np.load(sys.argv[1]))
out = {}
devs = np.array(jax.devices())
ring = Mesh(devs[:4], ('ring',))
def smap(f, ins, outs):
    return jax.jit(compat_shard_map(f, mesh=ring, in_specs=ins, out_specs=outs))
for s in range(1, 4):
    out[f'ring_{s}'] = smap(lambda x: ring_shift(x, 'ring', steps=s),
                            (P('ring'),), P('ring'))(inp['ring'])
for src in range(4):
    out[f'bcast_{src}'] = smap(lambda x: broadcast_from(x, 'ring', src),
                               (P('ring'),), P('ring'))(inp['bcast'])
def quant(x):
    q, s = quantize_int8(x[0])
    return q[None], s[None]
out['quant_q'], out['quant_s'] = smap(quant, (P('ring'),),
                                      (P('ring'), P('ring')))(inp['quant'])
out['cpsum'] = smap(lambda x: compressed_psum(x[0], 'ring')[None],
                    (P('ring'),), P('ring'))(inp['quant'])
def ef(x, e):
    r, e2 = ef_compressed_psum(x[0], e[0], 'ring')
    return r[None], e2[None]
out['ef_red'], out['ef_err'] = smap(ef, (P('ring'), P('ring')),
                                    (P('ring'), P('ring')))(inp['quant'], inp['err'])
def tree_ef(a, b, ea, eb):
    g = {'a': a[0], 'b': [b[0]]}
    e = {'a': ea[0], 'b': [eb[0]]}
    r, e2 = tree_ef_compressed_psum(g, e, 'ring')
    return r['a'][None], r['b'][0][None], e2['a'][None], e2['b'][0][None]
res = smap(tree_ef, (P('ring'),) * 4, (P('ring'),) * 4)(
    inp['tree_a'], inp['tree_b'], inp['err_a'], inp['err_b'])
for name, v in zip(('tree_ra', 'tree_rb', 'tree_ea', 'tree_eb'), res):
    out[name] = v
stage = lambda w, x: jnp.tanh(x @ w)
out['pipe2'] = pipeline_apply(stage, inp['pipe2_w'], inp['pipe2_x'],
                              mesh=Mesh(devs[:2], ('pod',)), axis_name='pod')
out['pipe4'] = pipeline_apply(stage, inp['pipe4_w'], inp['pipe4_x'],
                              mesh=Mesh(devs[:4], ('pod',)), axis_name='pod')
out = {k: np.asarray(v) for k, v in out.items()}

def spec_lists(tree):
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, 'spec'))
    return [[list(e) if isinstance(e, tuple) else e for e in s.spec]
            for s in leaves]
plans = {}
for name in sorted(ARCHS):
    cfg = ARCHS[name]
    for shape in MESHES:
        mesh = make_host_mesh(*shape)
        rules = build_rules(cfg, mesh, 'train', global_batch=8)
        key = f'{name}|{shape[0]}x{shape[1]}'
        try:
            plans[key] = spec_lists(remesh_plan(lm.lm_param_defs(cfg), rules,
                                                mesh))
        except ValueError as e:
            plans[key] = str(e)
odd = {'w': ParamDef((6, 5), ('embed', 'heads')),
       'v': ParamDef((4, 6), ('heads', None))}
for shape in MESHES:
    try:
        remesh_plan(odd, make_rules(), make_host_mesh(*shape))
        plans[f'odd|{shape}'] = 'ok'
    except ValueError as e:
        plans[f'odd|{shape}'] = str(e)
out['plans'] = np.frombuffer(json.dumps(plans).encode(), np.uint8)
np.savez(sys.argv[2], **out)
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs of every case, from one subprocess."""
    d = tmp_path_factory.mktemp("mesh_ref")
    np.savez(d / "in.npz", **_inputs())
    code = (JAX_CASES.replace("sys.argv[1]", repr(str(d / "in.npz")))
            .replace("sys.argv[2]", repr(str(d / "out.npz")))
            .replace("MESHES", repr(MESHES)))
    run_with_devices(code, n=4)
    return dict(np.load(d / "out.npz"))


@pytest.fixture
def ring():
    return make_mesh((4,), ("ring",), devices="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _smap(mesh, f, ins, outs):
    return coll.shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs)


# ---------------------------------------------------------------------------
# collectives, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 3])
def test_ring_shift_bitwise(ref, ring, steps):
    got = _smap(ring, lambda x: ring_shift(x, "ring", steps=steps),
                (P("ring"),), P("ring"))(_t(_inputs()["ring"]))
    np.testing.assert_array_equal(np.asarray(got), ref[f"ring_{steps}"])


@pytest.mark.parametrize("src", [0, 1, 2, 3])
def test_broadcast_from_bitwise(ref, ring, src):
    got = _smap(ring, lambda x: broadcast_from(x, "ring", src),
                (P("ring"),), P("ring"))(_t(_inputs()["bcast"]))
    np.testing.assert_array_equal(np.asarray(got), ref[f"bcast_{src}"])


def test_psum_pmax_fixed_order_and_axis_queries():
    """psum / pmax over one axis and over both of a (2, 2) mesh, bitwise
    the fold in position order; axis_index and axis_size as JAX gives
    them."""
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    x = _t(np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32))

    def f(v):
        return (coll.psum(v, "model"), coll.pmax(v, ("data", "model")),
                torch.tensor([[coll.axis_index("data"),
                               coll.axis_index(("data", "model")),
                               coll.axis_size(("data", "model"))]]))
    s, m, idx = _smap(mesh, f, (P(("data", "model")),),
                      (P(("data", "model")), P(("data", "model")),
                       P(("data", "model"))))(x)
    pairs = [x[0:1] + x[1:2]] * 2 + [x[2:3] + x[3:4]] * 2
    np.testing.assert_array_equal(np.asarray(s), torch.cat(pairs).numpy())
    top = torch.maximum(torch.maximum(torch.maximum(x[0], x[1]), x[2]), x[3])
    np.testing.assert_array_equal(np.asarray(m), top.expand(4, 6).numpy())
    np.testing.assert_array_equal(np.asarray(idx), [[0, 0, 4], [0, 1, 4],
                                                    [1, 2, 4], [1, 3, 4]])


def test_ppermute_unmatched_destination_gets_zeros(ring):
    x = _t(np.arange(4, dtype=np.float32).reshape(4, 1) + 1)
    got = _smap(ring, lambda v: coll.ppermute(v, "ring", [(0, 2), (1, 0)]),
                (P("ring"),), P("ring"))(x)
    np.testing.assert_array_equal(np.asarray(got).ravel(), [2, 0, 1, 0])


def test_quantize_and_compressed_psum_bitwise(ref, ring):
    """Absmax int8 per position (an all-zero row takes the 1e-12 floor),
    the int32 psum and the pmax of the scales: the reference's bits."""
    x = _t(_inputs()["quant"])

    def quant(v):
        q, s = tcomp.quantize_int8(v[0])
        return q[None], s[None]
    q, s = _smap(ring, quant, (P("ring"),), (P("ring"), P("ring")))(x)
    np.testing.assert_array_equal(np.asarray(q), ref["quant_q"])
    np.testing.assert_array_equal(np.asarray(s), ref["quant_s"])
    deq = tcomp.dequantize_int8(torch.from_numpy(ref["quant_q"]),
                                torch.from_numpy(ref["quant_s"])[:, None])
    assert float((deq - x).abs().max()) <= float(ref["quant_s"].max()) / 2
    got = _smap(ring, lambda v: tcomp.compressed_psum(v[0], "ring")[None],
                (P("ring"),), P("ring"))(x)
    np.testing.assert_array_equal(np.asarray(got), ref["cpsum"])


def _check_error_buffer(got, want, x, err):
    """The new error buffer against the reference's: equal, or one rounding
    of q * scale apart where the reference's compiled program fused
    ``corrected - q * scale`` into one multiply-add (per element, as its
    CPU code generation decides)."""
    corrected = x + err
    q, scale = tcomp.quantize_int8(torch.from_numpy(corrected))
    prod = np.abs(q.numpy().astype(np.float32) * scale.numpy())
    np.testing.assert_array_less(np.abs(got - want),
                                 np.spacing(prod) * 1.0001 + 1e-45)
    assert np.array_equal(got, want) or not np.array_equal(got, corrected)


def test_ef_compressed_psum_bitwise(ref, ring):
    inp = _inputs()

    def ef(v, e):
        r, e2 = tcomp.ef_compressed_psum(v[0], e[0], "ring")
        return r[None], e2[None]
    red, err = _smap(ring, ef, (P("ring"), P("ring")),
                     (P("ring"), P("ring")))(_t(inp["quant"]), _t(inp["err"]))
    np.testing.assert_array_equal(np.asarray(red), ref["ef_red"])
    for i in range(4):
        _check_error_buffer(np.asarray(err)[i], ref["ef_err"][i],
                            inp["quant"][i], inp["err"][i])


def test_tree_ef_compressed_psum_bitwise(ref, ring):
    inp = _inputs()

    def tree_ef(a, b, ea, eb):
        r, e2 = tcomp.tree_ef_compressed_psum(
            {"a": a[0], "b": [b[0]]}, {"a": ea[0], "b": [eb[0]]}, "ring")
        return r["a"][None], r["b"][0][None], e2["a"][None], e2["b"][0][None]
    got = _smap(ring, tree_ef, (P("ring"),) * 4, (P("ring"),) * 4)(
        *(_t(inp[k]) for k in ("tree_a", "tree_b", "err_a", "err_b")))
    np.testing.assert_array_equal(np.asarray(got[0]), ref["tree_ra"])
    np.testing.assert_array_equal(np.asarray(got[1]), ref["tree_rb"])
    for v, name, x, e in ((got[2], "tree_ea", "tree_a", "err_a"),
                          (got[3], "tree_eb", "tree_b", "err_b")):
        for i in range(4):
            _check_error_buffer(np.asarray(v)[i], ref[name][i],
                                inp[x][i], inp[e][i])


# ---------------------------------------------------------------------------
# the GPipe schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["pipe2", "pipe4"])
def test_pipeline_apply_matches_reference(ref, case):
    """The 2-stage case (4 microbatches) and the uneven 4-stage one (3
    microbatches): every microbatch out once, as the reference's."""
    inp = _inputs()
    w, x = _t(inp[f"{case}_w"]), _t(inp[f"{case}_x"])
    mesh = make_mesh((w.shape[0],), ("pod",), devices="cpu")
    got = pipeline_apply(lambda p, v: torch.tanh(v @ p), w, x, mesh=mesh,
                         axis_name="pod")
    np.testing.assert_allclose(np.asarray(got), ref[case], rtol=PIPE_TOL,
                               atol=PIPE_TOL)
    seq = x
    for s in range(w.shape[0]):
        seq = torch.tanh(seq @ w[s])
    np.testing.assert_allclose(np.asarray(got), seq.numpy(), rtol=PIPE_TOL,
                               atol=PIPE_TOL)


def test_pipeline_runs_every_stage_at_every_step():
    """n_micro + n_stages - 1 steps, each stage's function at each: 4 x
    (3 + 3) calls for 3 microbatches through 4 stages, bubbles included."""
    calls = []
    lock = threading.Lock()

    def stage(p, v):
        with lock:
            calls.append(coll.axis_index("pod"))
        return v + p
    mesh = make_mesh((4,), ("pod",), devices="cpu")
    out = pipeline_apply(stage, torch.ones(4, 1), torch.zeros(3, 2, 1),
                         mesh=mesh, axis_name="pod")
    assert sorted(calls) == sorted(list(range(4)) * 6)
    np.testing.assert_array_equal(np.asarray(out), np.full((3, 2, 1), 4.0))


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

def test_a_failing_position_raises_in_the_caller_and_frees_the_rest(ring):
    before = threading.active_count()

    def fails_at_two(v):
        if coll.axis_index("ring") == 2:
            raise ValueError("position 2 failed")
        return coll.psum(v, "ring")
    with pytest.raises(ValueError, match="position 2 failed"):
        _smap(ring, fails_at_two, (P("ring"),), P())(torch.ones(4, 1))

    def returns_early(v):
        if coll.axis_index("ring") == 1:
            return v
        return coll.psum(v, "ring")
    with pytest.raises(RuntimeError, match=r"position \(1,\) returned"):
        _smap(ring, returns_early, (P("ring"),), P())(torch.ones(4, 1))
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="inside shard_map"):
        coll.psum(torch.ones(1), "ring")


def test_shard_map_runs_each_position_in_its_own_thread_in_grad_mode(ring):
    seen = {}

    def f(v):
        seen[coll.axis_index("ring")] = (threading.current_thread(),
                                         torch.is_grad_enabled())
        return v
    with torch.no_grad():
        _smap(ring, f, (P("ring"),), P("ring"))(torch.ones(4, 1))
    assert len({id(t) for t, _ in seen.values()}) == 4
    assert threading.main_thread() not in {t for t, _ in seen.values()}
    assert not any(g for _, g in seen.values())


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _jax_defs(defs):
    leaves = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, JParamDef))[0]
    return [(jax.tree_util.keystr(p), tuple(d.shape), tuple(d.axes),
             d.opt_axes, np.dtype(d.dtype).name) for p, d in leaves
            if not jax.tree_util.keystr(p).endswith(".length")]


def _port_defs(defs):
    return [(tuple(d.shape), tuple(d.logical_axes), d.opt_axes,
             str(d.dtype).split(".")[-1]) for d in _leaves(defs)
            if isinstance(d, ParamDef)]


@pytest.mark.parametrize("arch", sorted(tarchs.ARCHS))
def test_definitions_carry_the_reference_axes(arch):
    """lm_param_defs, opt.state_defs and lm_cache_defs at full size: shape,
    logical axes, opt_axes and dtype leaf by leaf, in the reference's
    order (defs only: nothing is allocated). The reference's cache
    ``length`` leaves are plain lengths in the port."""
    jc, tc = jarchs.ARCHS[arch], tarchs.ARCHS[arch]
    jp, tp = jlm.lm_param_defs(jc), tlm.lm_param_defs(tc)
    pairs = [(jp, tp),
             (jget(jc.optimizer).state_defs(jp),
              tget(tc.optimizer).state_defs(tp)),
             (jlm.lm_cache_defs(jc, 2, 128), tlm.lm_cache_defs(tc, 2, 128))]
    for j, t in pairs:
        want = [x[1:] for x in _jax_defs(j)]
        assert _port_defs(t) == want
    assert param_count(tp) == sum(np.prod(x[1]) for x in _jax_defs(jp))
    meta = [x for x in _leaves(abstract_params(tp))
            if isinstance(x, torch.Tensor)]
    assert meta and all(x.device.type == "meta" for x in meta)


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", sorted(tarchs.ARCHS))
def test_remesh_plan_matches_reference(ref, arch):
    """``build_rules(..., "train")`` and ``remesh_plan`` of the full
    definitions on host meshes (4,1), (2,2), (1,4): the reference's specs,
    or its message where a dimension does not divide."""
    plans = json.loads(bytes(ref["plans"]).decode())
    cfg = tarchs.ARCHS[arch]
    for shape in MESHES:
        mesh = make_host_mesh(*shape, devices="meta")
        rules = build_rules(cfg, mesh, "train", global_batch=8)
        want = plans[f"{arch}|{shape[0]}x{shape[1]}"]
        try:
            got = [[list(e) if isinstance(e, tuple) else e for e in s.spec]
                   for s in _leaves(remesh_plan(tlm.lm_param_defs(cfg),
                                                rules, mesh))]
        except ValueError as e:
            got = str(e)
        assert got == want, (shape, got if isinstance(got, str) else "")


def test_remesh_plan_indivisible_raises_the_reference_message(ref):
    plans = json.loads(bytes(ref["plans"]).decode())
    odd = {"w": ParamDef((6, 5), ("embed", "heads")),
           "v": ParamDef((4, 6), ("heads", None))}
    for shape in MESHES:
        want = plans[f"odd|{shape}"]
        mesh = make_host_mesh(*shape, devices="meta")
        if want == "ok":
            remesh_plan(odd, make_rules(), mesh)
            continue
        with pytest.raises(ValueError) as e:
            remesh_plan(odd, make_rules(), mesh)
        assert str(e.value) == want
    assert any(v != "ok" for k, v in plans.items() if k.startswith("odd"))


def test_production_mesh_plans_llama3_8b_without_hardware():
    cfg = tarchs.ARCHS["llama3-8b"]
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.size == (512 if multi else 256)
        assert {d.type for d in mesh.devices.flat} == {"meta"}
        rules = build_rules(cfg, mesh, "train")
        specs = remesh_plan(tlm.lm_param_defs(cfg), rules, mesh)
        assert specs["embed"].spec == P("model", None)
    assert param_specs(tlm.lm_param_defs(cfg), rules)["embed"] == P("model")
