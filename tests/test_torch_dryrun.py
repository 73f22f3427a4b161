"""The port's dry run on meta meshes against the reference's compiled
lowering.

Reduced llama3-8b, olmoe-1b-7b, mamba2-2.7b and recurrentgemma-2b
(``configs/archs.py::reduced``; 64 tokens, batch 8) run their prefill and
decode steps, and llama3-8b its training step, once under the counter
(``counter.py``) on (1, 1) and (2, 2) meshes of ``meta`` positions,
through ``launch/steps.py::lowering_bundle``. The reference's figures come
from one subprocess with four fake host devices, which runs while the
port counts. Held:

  * every position of a cell does the same products, kernels and
    collectives and holds the same arguments (the splits are even); the
    op bytes and the peak within 1% (the MoE's token shards each sum the
    counts of the shards before theirs, and the position whose piece of
    a sequence-split cache holds the new token writes it); the kernels
    the path reaches declare their launches; only the (2, 2) mesh runs
    collectives, each over a group of 2 or 4;
  * per-device argument bytes equal the reference's: exactly its
    ``memory_analysis().argument_size_in_bytes`` in the training cell. In
    the serving cells the reference's caches also carry an int32
    ``length`` a layer, and its decode a scalar position (a Python int in
    the port): the port's bytes plus those equal the sum of the
    reference's shard sizes (params, caches, inputs) in every serving
    cell, and that sum is ``argument_size_in_bytes`` in every serving
    cell but two, where XLA drops an argument the step does not read:
    recurrentgemma-2b's prefill (the conv states it overwrites) and
    mamba2-2.7b's decode (the position);
  * the two-point extrapolation to depth 4 equals a full depth-4 run:
    exactly for the FLOPs, the bytes, the kernels' work, the collectives
    and the argument, output and donated bytes. The peak is an estimate:
    never below the full run's and at most 10% above it. Measured: equal
    for the training step (no remat: the saved activations grow by a
    layer's each layer); 6.6% over for the prefill, whose transient peak
    is one layer's at any depth but grows from the first layer to the
    second (at full width, where the weights and caches dominate, the
    share is far smaller);
  * the port's FLOPs against the reference's ``measured_costs`` flops at
    the same cell: XLA counts every elementwise op (norms, RoPE, the
    softmax), and the reference's prefill computes every position's
    logits and its coarsened attention chunk every (query, key) pair,
    where the port's prefill computes the last position's logits and its
    kernel the visible pairs. Measured shares of XLA's count: 0.515
    (llama3-8b prefill), 0.818 (mamba2-2.7b prefill); held within
    [0.5, 1.0];
  * the collectives record their kind, group and result bytes;
  * where the query heads do not divide the model axis, the sharded
    steps equal the reference's sharded steps (the same subprocess) and
    the port's unsharded steps.
"""

import concurrent.futures
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402
from repro_torch.configs.archs import REDUCED  # noqa: E402
from repro_torch.configs.base import SHAPES, TrainConfig  # noqa: E402
from repro_torch.distributed.collectives import (all_gather,  # noqa: E402
                                                 pmax, ppermute, psum,
                                                 psum_scatter, shard_map)
from repro_torch.distributed.sharding import P, make_mesh  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.counter import Counter  # noqa: E402
from repro_torch.launch.steps import lowering_bundle  # noqa: E402

SEQ, BATCH = 64, 8
ARCHS = ("llama3-8b", "olmoe-1b-7b", "mamba2-2.7b", "recurrentgemma-2b")
CELLS = [(a, s) for a in ARCHS for s in ("prefill_32k", "decode_32k")] \
    + [("llama3-8b", "train_4k")]
MESHES = ((1, 1), (2, 2))
FLOP_CELLS = (("llama3-8b", "prefill_32k"), ("mamba2-2.7b", "prefill_32k"))
FLOP_SHARE = (0.5, 1.0)
# the kernels each family's steps reach
ATTENTION = {"llama3-8b", "olmoe-1b-7b", "recurrentgemma-2b"}
# the serving cells where XLA drops an argument the step does not read
PRUNED = {("recurrentgemma-2b", "prefill_32k"), ("mamba2-2.7b", "decode_32k")}


def _kernels(arch, shape):
    """The kernels a cell's step reaches: the flash forward in a prefill
    or a training step of an attention family (decode attends by plain
    products) and its backward in training; the MoE's dispatch and
    combine."""
    k = set()
    if arch in ATTENTION and shape != "decode_32k":
        k.add("flash_attention")
        if shape == "train_4k":
            k.add("flash_attention_bwd")
    if arch == "olmoe-1b-7b":
        k |= {"mp_scatter", "gather_rows"}
    return k

JAX_FIGURES = r"""
import json, math
import jax
import numpy as np
from repro.configs.archs import REDUCED
from repro.configs.base import SHAPES, TrainConfig
from repro.distributed.sharding import param_shardings
from repro.launch.hlo_cost import measured_costs
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import (build_rules, decode_input_defs,
                                lowering_bundle, prefill_input_defs)
from repro.models import lm

out = {"args": {}, "length": {}, "shards": {}, "flops": {}}
mesh = make_host_mesh(2, 2)
for arch, sn in __CELLS__:
    cfg = REDUCED[arch]
    shape = SHAPES[sn].replace(seq_len=__SEQ__, global_batch=__BATCH__)
    with mesh:
        jitted, args = lowering_bundle(cfg, shape, mesh, tcfg=TrainConfig())
        ma = jitted.lower(*args).compile().memory_analysis()
    key = arch + "/" + sn
    out["args"][key] = ma.argument_size_in_bytes
    if shape.kind != "train":
        rules = build_rules(cfg, mesh, shape.kind, global_batch=__BATCH__)
        isdef = lambda x: hasattr(x, "logical_axes")
        length = shards = 0
        inputs = (prefill_input_defs if shape.kind == "prefill"
                  else decode_input_defs)(cfg, shape)
        for defs in (lm.lm_param_defs(cfg),
                     lm.lm_cache_defs(cfg, __BATCH__, __SEQ__), inputs):
            sh = jax.tree.leaves(param_shardings(defs, rules, mesh),
                                 is_leaf=lambda x: hasattr(x, "spec"))
            flat = jax.tree_util.tree_flatten_with_path(defs,
                                                        is_leaf=isdef)[0]
            for (path, d), s in zip(flat, sh):
                n = math.prod(s.shard_shape(d.shape)) * np.dtype(
                    d.dtype).itemsize
                shards += n
                if getattr(path[-1], "name", None) == "length":
                    length += n
        out["length"][key] = length
        out["shards"][key] = shards
for arch, sn in __FLOP_CELLS__:
    shape = SHAPES[sn].replace(seq_len=__SEQ__, global_batch=__BATCH__)
    out["flops"][arch + "/" + sn] = measured_costs(
        REDUCED[arch], shape, mesh, TrainConfig())["flops"]
print("FIGURES" + json.dumps(out))
"""

# the reference's sharded steps where the query heads do not divide the
# model axis (GSPMD pads the heads): its initial state, logits, loss and
# first moments (the gradients scaled by 1 - b1 at a learning rate of 0)
WHOLE_Q_JAX = r"""
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as ckpt
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import init_params
from repro.launch.steps import batch_defs, make_decode_step, make_prefill_step
from repro.launch.steps import make_train_step
from repro.optim.optimizers import get_optimizer
root = __ROOT__
cfg = REDUCED["recurrentgemma-2b"].replace(**__WQ_CFG__)
B, S, MAX = __WQ_SHAPE__
toks = jnp.asarray(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (B, S + 1)), jnp.int32)
pdefs = lm.lm_param_defs(cfg)
odefs = get_optimizer(cfg.optimizer).state_defs(pdefs)
params = init_params(jax.random.PRNGKey(0), pdefs)
ostate = init_params(jax.random.PRNGKey(0), odefs)
ckpt.save(root + "/wq-init", 0, {"params": params, "opt": ostate})
mesh = make_host_mesh(*__WQ_MESH__)
cdefs = lm.lm_cache_defs(cfg, B, MAX)
rp = build_rules(cfg, mesh, "prefill", global_batch=B)
rd = build_rules(cfg, mesh, "decode", global_batch=B)
ps = jax.device_put(params, param_shardings(pdefs, rp, mesh))
cs = jax.device_put(init_params(jax.random.PRNGKey(0), cdefs),
                    param_shardings(cdefs, rp, mesh))
with mesh:
    lg0, caches = jax.jit(make_prefill_step(cfg, rp, mesh))(
        ps, cs, {"tokens": toks[:, :S]})
    lg1, _ = jax.jit(make_decode_step(cfg, rd, mesh))(
        ps, caches, {"token": toks[:, S:],
                     "position": jnp.asarray(S, jnp.int32)})
tcfg = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                   grad_clip=1e9)
rt = build_rules(cfg, mesh, "train", global_batch=B)
p_sh = param_shardings(pdefs, rt, mesh)
o_sh = param_shardings(odefs, rt, mesh)
b_sh = param_shardings(batch_defs(cfg, ShapeConfig("t", S, B, "train")),
                       rt, mesh)
step = jax.jit(make_train_step(cfg, tcfg, rt, mesh),
               in_shardings=(p_sh, o_sh, b_sh),
               out_shardings=(p_sh, o_sh, NamedSharding(mesh, P())))
batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
_, o, m = step(jax.device_put(params, p_sh), jax.device_put(ostate, o_sh),
               {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()})
ckpt.save(root + "/wq-moments", 0, o["m"])
np.savez(root + "/wq-sharded.npz", prefill=np.asarray(lg0),
         decode=np.asarray(lg1), loss=np.asarray(m["loss"]))
"""
# recurrentgemma-2b's 10 query heads on the production mesh's 16-way
# model axis, reduced: 6 heads of 16 columns on a 4-way axis, each
# position holding a head and a half
WQ_CFG = {"num_layers": 3, "num_heads": 6}
WQ_MESH = (1, 4)
WQ_SHAPE = (2, 16, 24)          # batch, prompt, cache rows


def _shape(name):
    return SHAPES[name].replace(seq_len=SEQ, global_batch=BATCH)


def _count(cfg, shape_name, mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), devices="meta")
    step, args = lowering_bundle(cfg, _shape(shape_name), mesh,
                                 tcfg=TrainConfig())
    with Counter() as c:
        step(*args)
    return {pos: c.records[pos].as_dict() for pos in mesh.positions()}


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """{(arch, shape, mesh): {position: record}} for every cell, and the
    reference's figures, computed alongside in a subprocess, which also
    leaves the reference's sharded steps of ``WQ_CFG`` in a folder."""
    root = tmp_path_factory.mktemp("dryrun_ref")
    code = ((JAX_FIGURES + WHOLE_Q_JAX)
            .replace("__FLOP_CELLS__", repr(FLOP_CELLS))
            .replace("__CELLS__", repr(CELLS))
            .replace("__SEQ__", str(SEQ)).replace("__BATCH__", str(BATCH))
            .replace("__ROOT__", repr(str(root)))
            .replace("__WQ_CFG__", repr(WQ_CFG))
            .replace("__WQ_MESH__", repr(WQ_MESH))
            .replace("__WQ_SHAPE__", repr(WQ_SHAPE)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_with_devices, code, 4)
        port = {(a, s, m): _count(REDUCED[a], s, m)
                for a, s in CELLS for m in MESHES}
        out = ref.result()
    figures = json.loads(out.split("FIGURES", 1)[1].splitlines()[0])
    figures["root"] = root
    return port, figures


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_positions_count_the_same_work(counted, arch, shape, mesh):
    recs = list(counted[0][(arch, shape, mesh)].values())
    first = recs[0]
    assert first["flops"] > 0 and first["bytes"] > 0
    assert first["peak_bytes"] >= first["argument_bytes"] > 0
    for other in recs[1:]:
        for key in ("flops", "kernels", "collectives", "argument_bytes",
                    "output_bytes", "alias_bytes"):
            assert other[key] == first[key], key
        for key in ("bytes", "peak_bytes"):
            assert abs(other[key] - first[key]) <= 0.01 * first[key], key
    assert set(first["kernels"]) == _kernels(arch, shape)
    assert all(k["launches"] > 0 and k["bytes"] > 0
               for k in first["kernels"].values())
    groups = {c["group_size"] for c in first["collectives"]}
    assert groups <= ({2, 4} if mesh == (2, 2) else set())
    assert groups if mesh == (2, 2) else not groups
    if shape == "train_4k":
        assert first["backward_product_flops"] > first["product_flops"] / 2
        # the weights and the optimizer's state are updated in place
        assert first["alias_bytes"] > first["argument_bytes"] / 2


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_the_reference(counted, arch, shape):
    port, figures = counted
    mine = port[(arch, shape, (2, 2))][(0, 0)]["argument_bytes"]
    key = f"{arch}/{shape}"
    ref = figures["args"][key]
    if shape == "train_4k":
        assert mine == ref
        return
    position = 4 if shape == "decode_32k" else 0
    assert mine + figures["length"][key] + position == figures["shards"][key]
    if (arch, shape) in PRUNED:
        assert ref < figures["shards"][key]
    else:
        assert ref == figures["shards"][key]


@pytest.mark.parametrize("arch,shape,mesh", [
    ("llama3-8b", "prefill_32k", (2, 2)), ("llama3-8b", "train_4k", (1, 1))])
def test_two_point_extrapolation_equals_a_full_depth_run(arch, shape, mesh):
    cfg = REDUCED[arch].replace(num_layers=4, train_microbatches=1)
    m = make_mesh(mesh, ("data", "model"), devices="meta")
    est = hlo_cost.measured_costs(cfg, _shape(shape), m, TrainConfig())
    full = hlo_cost._measure(hlo_cost._analysis_cfg(cfg, 4), _shape(shape),
                             m, TrainConfig())
    assert est["_num_groups"] == 4
    for key in full:
        if key.startswith("coll_") or key in (
                "flops", "product_flops", "kernel_flops", "bytes",
                "kernel_bytes", "argument_bytes", "output_bytes",
                "alias_bytes"):
            assert est[key] == full[key], key
    assert full["peak_bytes"] <= est["peak_bytes"] \
        <= 1.10 * full["peak_bytes"]


@pytest.mark.parametrize("arch,shape", FLOP_CELLS)
def test_flops_against_the_references_count(counted, arch, shape):
    port, figures = counted
    mine = port[(arch, shape, (2, 2))][(0, 0)]["flops"]
    share = mine / figures["flops"][f"{arch}/{shape}"]
    assert FLOP_SHARE[0] <= share <= FLOP_SHARE[1], share


def test_collectives_record_kind_group_and_result_bytes():
    mesh = make_mesh((1, 4), ("data", "model"), devices="cpu")
    x = torch.ones(8, 6)

    def f(x):
        a = psum(x, "model")                                # 8x6 f32
        b = psum_scatter(x, "model", scatter_dimension=0)   # 2x6
        c = all_gather(x, "model", axis=0, tiled=True)      # 32x6
        d = ppermute(x, "model", [(i, (i + 1) % 4) for i in range(4)])
        e = pmax(x, "data")                                 # a group of 1
        return a + d + e, b, c

    with Counter() as cnt:
        shard_map(f, mesh=mesh, in_specs=(P(),),
                  out_specs=(P(), P(), P()))(x)
    row = 6 * 4
    for rec in cnt.records.values():
        assert rec.as_dict()["collectives"] == [
            {"kind": "all-gather", "group_size": 4, "count": 1,
             "result_bytes": 32 * row},
            {"kind": "all-reduce", "group_size": 4, "count": 1,
             "result_bytes": 8 * row},
            {"kind": "collective-permute", "group_size": 4, "count": 1,
             "result_bytes": 8 * row},
            {"kind": "reduce-scatter", "group_size": 4, "count": 1,
             "result_bytes": 2 * row}]
        # the sums inside the collectives are theirs: one add, two of f
        assert rec.ops == 2


def test_heads_that_do_not_divide_the_model_axis(counted):
    """recurrentgemma-2b's 10 heads on the production mesh's 16-way model
    axis, reduced (``WQ_CFG``): 6 heads of 16 on a 4-way axis, each
    position holding a head and a half of the columns. Every position
    computes every head (Q gathered whole) and takes its columns of the
    output for its row piece of ``wo``. On the reference's initial state,
    the prefill's and a decode step's logits and a training step's loss
    and gradients equal the reference's sharded steps' (GSPMD pads the
    heads) and the port's unsharded steps' within 1e-5 of their scale
    (measured on the CPU: at most 6.8e-7, on the first moments)."""
    import numpy as np
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_rules, make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.distributed.sharding import Sharded, map_defs
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import get_optimizer, tree_leaves
    root = counted[1]["root"]
    cfg = REDUCED["recurrentgemma-2b"].replace(**WQ_CFG)
    b, s, cache_len = WQ_SHAPE
    mesh = make_host_mesh(*WQ_MESH, devices="cpu")
    assert cfg.num_heads % WQ_MESH[1] \
        and cfg.num_heads * cfg.head_dim % WQ_MESH[1] == 0
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    pdefs = lm.lm_param_defs(cfg)
    opt = get_optimizer(cfg.optimizer)
    empty = lambda d: torch.empty(0)   # noqa: E731

    def initial():
        like = map_defs(empty, {"params": pdefs,
                                "opt": opt.state_defs(pdefs)})
        tree = ckpt.restore_latest(root / "wq-init", like)[1]
        return tree["params"], tree["opt"]

    def whole(x):
        return (x.gather("cpu") if isinstance(x, Sharded) else x).detach()

    def close(got, want):
        got = [whole(x) for x in tree_leaves(got)]
        want = [whole(x) for x in tree_leaves(want)]
        assert [g.shape for g in got] == [w.shape for w in want]
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        assert err <= 1e-5 * scale, (err, scale)

    ref = np.load(root / "wq-sharded.npz")
    ref_m = ckpt.restore_latest(root / "wq-moments", map_defs(empty, pdefs))[1]
    p = initial()[0]
    logits = {}
    for name, rules in (("whole", (None, None)), ("split", (
            build_rules(cfg, mesh, "prefill", b),
            build_rules(cfg, mesh, "decode", b)))):
        m = None if rules[0] is None else mesh
        lg0, caches = make_prefill_step(cfg, rules[0], m)(
            p, lm.init_caches(cfg, b, cache_len, "cpu"),
            {"tokens": toks[:, :s]})
        lg1 = make_decode_step(cfg, rules[1], m)(
            p, caches, {"token": toks[:, s:], "position": s})[0]
        logits[name] = [lg0, lg1]
    close(logits["split"], logits["whole"])
    close(logits["split"], [torch.from_numpy(ref["prefill"]),
                            torch.from_numpy(ref["decode"])])
    tcfg = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                       grad_clip=1e9)
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    out = {}
    for name, rules in (("whole", None),
                        ("split", build_rules(cfg, mesh, "train", b))):
        params, state = initial()
        for t in tree_leaves(params):
            t.requires_grad_()
        out[name] = make_train_step(cfg, tcfg, rules,
                                    None if rules is None else mesh)(
            params, state, batch)
    loss = out["split"][2]["loss"].reshape(1)
    close([loss], [out["whole"][2]["loss"].reshape(1)])
    close([loss], [torch.from_numpy(ref["loss"]).reshape(1)])
    close(out["split"][1]["m"], out["whole"][1]["m"])
    close(out["split"][1]["m"], ref_m)
