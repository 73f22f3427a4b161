"""The port's roofline tools against the reference's, with no mesh threads.

``launch/roofline.py::model_flops`` equals the reference's for every arch
and shape; ``launch/hlo_cost.py``'s pattern lengths and analysis configs
equal the reference's field by field; ``collective_bytes`` weighs the
collectives' records as the reference weighs the partitioned HLO
(``tests/test_roofline_tools.py``'s cases); the kernels' work counts
(``kernels/cost.py``) match hand counts; and each kernel wrapper's ``meta``
form gives the kernel's output shapes and dtypes and declares its work to
an active counter.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import archs as ref_archs  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.launch import hlo_cost as ref_hlo_cost  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs.archs import ARCHS  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _forward_with_lse, flash_attention, flash_attention_bwd, visible)
from repro_torch.kernels.gather_rows import gather_rows  # noqa: E402
from repro_torch.kernels.mp_scatter import (mp_scatter,  # noqa: E402
                                            mp_scatter_multi)
from repro_torch.launch import hlo_cost, roofline  # noqa: E402
from repro_torch.counter import Counter  # noqa: E402
from test_roofline_tools import HLO  # noqa: E402

META = "meta"


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equals_the_reference(arch, shape):
    assert roofline.model_flops(ARCHS[arch], SHAPES[shape]) == \
        ref_roofline.model_flops(ref_archs.ARCHS[arch],
                                 ref_base.SHAPES[shape])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analysis_cfg_equals_the_reference(arch):
    assert hlo_cost._PATTERN_LEN == ref_hlo_cost._PATTERN_LEN
    for groups in (1, 2):
        mine = dataclasses.asdict(hlo_cost._analysis_cfg(ARCHS[arch],
                                                         groups))
        ref = dataclasses.asdict(ref_hlo_cost._analysis_cfg(
            ref_archs.ARCHS[arch], groups))
        assert str(mine.pop("dtype")).split(".")[-1] == \
            np.dtype(ref.pop("dtype")).name
        assert mine == ref


def test_collective_bytes_weighs_records_as_the_reference_weighs_hlo():
    """The reference's HLO cases (``test_roofline_tools.py``) as records:
    all-gather f32[32,1024,1024] over 16 and f32[64] over 2, all-reduce
    bf16[16,512] over 4, reduce-scatter f32[2,256,512] over 16, all-to-all
    bf16[4,128] over 2."""
    ag = 32 * 1024 * 1024 * 4
    records = [
        {"kind": "all-gather", "group_size": 16, "count": 1,
         "result_bytes": ag},
        {"kind": "all-gather", "group_size": 2, "count": 1,
         "result_bytes": 64 * 4},
        {"kind": "all-reduce", "group_size": 4, "count": 1,
         "result_bytes": 16 * 512 * 2},
        {"kind": "reduce-scatter", "group_size": 16, "count": 1,
         "result_bytes": 2 * 256 * 512 * 4},
        {"kind": "all-to-all", "group_size": 2, "count": 1,
         "result_bytes": 4 * 128 * 2},
    ]
    c = roofline.collective_bytes(records)
    ref = ref_roofline.collective_bytes(HLO)
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert c[kind]["bytes"] == ref[kind]["bytes"]
        assert c[kind]["count"] == ref[kind]["count"]
    assert c["all-reduce"]["bytes"] == 2 * 16 * 512 * 2
    assert c["reduce-scatter"]["bytes"] == 2 * 256 * 512 * 4 * 16
    assert c["all-gather"]["count"] == 2
    assert c["all-gather"]["group_size"] == 16


def test_roofline_report_terms_and_memory_report():
    rec = {"flops": 989e12, "bytes": 3.35e12, "collectives": [
        {"kind": "all-reduce", "group_size": 2, "count": 1,
         "result_bytes": 225e9}],
        "argument_bytes": 10.0, "output_bytes": 4.0, "alias_bytes": 3.0,
        "peak_bytes": 25.0}
    rep = roofline.roofline_report(rec, 1)
    assert rep["compute_s"] == rep["memory_s"] == rep["collective_s"] == 1.0
    assert "collective_s_tpu_adjusted" not in rep
    assert roofline.memory_report(rec) == {
        "argument_bytes": 10.0, "output_bytes": 4.0, "temp_bytes": 15.0,
        "alias_bytes": 3.0, "peak_estimate_bytes": 25.0}
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (64, 64, False, None), (48, 80, True, None),
    (80, 48, True, None), (64, 64, True, 16), (64, 64, False, 7),
    (33, 97, True, 40)])
def test_visible_pairs_counts_the_mask(sq, sk, causal, window):
    want = int(visible(sq, sk, causal=causal, window=window).sum())
    assert cost.visible_pairs(sq, sk, causal=causal, window=window) == want


def test_kernel_work_matches_hand_counts():
    # llama3-8b's prefill attention at B=2, S=2048, 32 heads of 128, bf16
    pairs = 2048 * 2049 // 2
    nbytes, flops = cost.flash_work(2, 32, 2048, 2048, 128, causal=True,
                                    window=None, itemsize=2)
    assert nbytes == 4 * 2 * 32 * 2048 * 128 * 2
    assert flops == 4 * 128 * pairs * 2 * 32
    assert cost.flash_work(1, 1, 4, 4, 8, causal=True, window=None,
                           itemsize=4, lse=True) == (4 * 4 * 8 * 4 + 16,
                                                     4 * 8 * 10)
    # read q, out, dout, k, v; write dq, dk, dv (4 rows of 8 each); lse
    assert cost.flash_bwd_work(1, 1, 4, 4, 8, causal=True, window=None,
                               itemsize=4) == (8 * 4 * 8 * 4 + 16,
                                               10 * 8 * 10)
    # mp_scatter: 10 edges of 3 f32 lanes, 6 unmasked, into 5 rows
    assert cost.scatter_work("mp_scatter", 10, 3, 5, 4, valid=6) == (
        10 + 6 * (4 + 12) + 5 * 3 * 4, 6 * 3)
    assert cost.scatter_work("mp_scatter_multi", 10, 3, 5, 2, valid=6,
                             stats=("sum", "sumsq", "count", "max")) == (
        10 + 6 * (4 + 6) + 4 * 5 * (3 + 3 + 1 + 3), 6 * (3 * (1 + 2 + 1) + 1))
    assert cost.scatter_work("seg_softmax", 10, 2, 5, 4, valid=6) == (
        10 + 6 * (4 + 8) + 4 * 10 * 2, 8 * 6 * 2)
    # gather_rows: 8 rows of 4 bf16 lanes, all unmasked
    assert cost.gather_rows_work(8, 4, 2) == (8 + 8 * (4 + 8) + 8 * 4 * 4,
                                              0)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META).requires_grad_(grad)


def test_flash_attention_meta_forms_give_the_kernels_outputs():
    q, k, v = (_meta(2, 4, 128, 16, dtype=torch.bfloat16) for _ in range(3))
    with Counter() as c:
        out = flash_attention(q, k, v, causal=True)
        o2, lse = _forward_with_lse(q, k, v, True, None, None)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, out,
                                         causal=True)
    assert out.device.type == META and out.shape == q.shape \
        and out.dtype == torch.bfloat16
    assert o2.shape == q.shape and lse.shape == (2, 4, 128) \
        and lse.dtype == torch.float32
    assert all(g.shape == q.shape and g.dtype == torch.bfloat16
               for g in (dq, dk, dv))
    fwd = cost.flash_work(2, 4, 128, 128, 16, causal=True, window=None,
                          itemsize=2)
    fwd_lse = cost.flash_work(2, 4, 128, 128, 16, causal=True, window=None,
                              itemsize=2, lse=True)
    bwd = cost.flash_bwd_work(2, 4, 128, 128, 16, causal=True, window=None,
                              itemsize=2)
    assert c.caller.kernels["flash_attention"] == {
        "launches": 2, "bytes": fwd[0] + fwd_lse[0],
        "flops": fwd[1] + fwd_lse[1]}
    assert c.caller.kernels["flash_attention_bwd"] == {
        "launches": 2, "bytes": bwd[0], "flops": bwd[1]}
    assert flash_attention.launches == 0
    # under grad: the autograd function, its backward the meta bwd form
    qg, kg, vg = (_meta(1, 2, 32, 16, grad=True) for _ in range(3))
    with torch.enable_grad():
        o = flash_attention(qg, kg, vg, causal=True, window=8, q_tile=32,
                            kv_tile=32)
        grads = torch.autograd.grad(o.sum(), [qg, kg, vg])
    assert o.shape == qg.shape and all(g.shape == qg.shape for g in grads)


def test_scatter_and_gather_meta_forms_give_the_kernels_outputs():
    msg = _meta(256, 8, dtype=torch.bfloat16)
    idx = torch.empty(256, dtype=torch.int64, device=META)
    mask = torch.empty(256, dtype=torch.bool, device=META)
    y = _meta(64, 8, dtype=torch.bfloat16)
    with Counter() as c:
        s = mp_scatter(msg, idx, mask, 40)
        multi = mp_scatter_multi(msg, idx, mask, 40,
                                 stats=("sum", "count", "max"))
        g = gather_rows(y, idx, mask)
    assert s.shape == (40, 8) and s.dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in multi.items()} == {
        "sum": ((40, 8), torch.float32), "count": ((40, 1), torch.float32),
        "max": ((40, 8), torch.float32)}
    assert g.shape == (256, 8) and g.dtype == torch.float32
    k = c.caller.kernels
    want = cost.scatter_work("mp_scatter", 256, 8, 40, 2)
    assert k["mp_scatter"] == {"launches": 1, "bytes": want[0],
                               "flops": want[1]}
    want = cost.scatter_work("mp_scatter_multi", 256, 8, 40, 2,
                             stats=("sum", "count", "max"))
    assert k["mp_scatter_multi"] == {"launches": 1, "bytes": want[0],
                                     "flops": want[1]}
    want = cost.gather_rows_work(256, 8, 2)
    assert k["gather_rows"] == {"launches": 1, "bytes": want[0],
                                "flops": 0}
    assert mp_scatter.launches == mp_scatter_multi.launches == \
        gather_rows.launches == 0
    # the differentiable forms: each one's backward is the other's meta form
    yg = _meta(64, 8, grad=True)
    with torch.enable_grad():
        dy, = torch.autograd.grad(gather_rows(yg, idx, mask).sum(), [yg])
        mg = _meta(256, 8, grad=True)
        dm, = torch.autograd.grad(mp_scatter(mg, idx, mask, 40).sum(), [mg])
    assert dy.shape == yg.shape and dm.shape == mg.shape


def test_counter_counts_products_bytes_and_the_live_peak():
    a = _meta(64, 32)
    b = _meta(32, 16)
    with Counter() as c:
        c.caller.arguments((a, b))
        x = a @ b                       # 2*64*32*16 FLOPs
        y = x.relu()
        del x
        z = y.t()                       # a view: nothing
        out = z.sum()
    r = c.caller.as_dict()
    assert r["product_flops"] == 2 * 64 * 32 * 16
    # mm reads a, b and writes x; relu reads x, writes y; sum reads y
    assert r["op_bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4 \
        + 2 * 64 * 16 * 4 + 64 * 16 * 4 + 4
    assert r["argument_bytes"] == (64 * 32 + 32 * 16) * 4
    # x and y live together once; the scalar after x is gone
    assert r["peak_bytes"] == r["argument_bytes"] + 2 * 64 * 16 * 4
    assert out.shape == ()
