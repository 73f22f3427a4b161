"""``experiments/nt_breakdown.py``'s variants still apply to the NT kernels.

The probe builds its variants by exact-text edits of ``csrc/nt_tile.cuh``,
``csrc/dense_tile.cuh``, ``csrc/fused_nt_scatter.cu`` and
``csrc/mp_pipeline.cuh``; an edit to the lines it names breaks it. This
checks on the CPU (no nvcc, no card) that every variant of the staged
design applies to the sources as they stand and changes them.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
VARIANTS = ("as_is", "no_dense", "no_copies", "empty", "no_pdl",
            "edge_only")


@pytest.fixture(scope="module")
def breakdown():
    spec = importlib.util.spec_from_file_location(
        "nt_breakdown", REPO / "experiments" / "nt_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_applies_to_the_kernel_sources(breakdown, name):
    src = breakdown.sources(breakdown.build.CSRC)
    assert breakdown.staged(src)
    out = breakdown.variants(src)
    assert tuple(out) == VARIANTS
    assert (out[name] == src) == (name == "as_is")


def test_the_fused_call_alone_takes_the_fused_variants(breakdown):
    """no_pdl and edge_only change fused_nt_scatter's launches alone, so the
    probe builds them for it and not for nt_mlp."""
    src = breakdown.sources(breakdown.build.CSRC)
    out = breakdown.variants(src)
    for name in breakdown.FUSED_ONLY:
        changed = {f for f in src if out[name][f] != src[f]}
        assert changed <= {"fused_nt_scatter.cu", "mp_pipeline.cuh"}
