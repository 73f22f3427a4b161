"""``experiments/layer_fused_breakdown.py``'s variants still apply to the
kernel.

The probe builds its variants by exact-text edits of ``csrc/layer_fused.cu``
and the dense tile it includes (``csrc/dense_tile.cuh``); an edit to the
lines it names breaks it. This checks on the CPU (no nvcc, no card) that
every variant of the staged design applies to the sources as they stand and
changes them.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
VARIANTS = ("as_is", "no_dense", "no_edges", "no_copies", "unstaged",
            "sweep_only", "copies_only", "classify_only", "empty")


@pytest.fixture(scope="module")
def breakdown():
    spec = importlib.util.spec_from_file_location(
        "layer_fused_breakdown",
        REPO / "experiments" / "layer_fused_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_applies_to_the_kernel_source(breakdown, name):
    src = breakdown.sources(breakdown.build.CSRC)
    assert set(src) == {"layer_fused.cu", "dense_tile.cuh"}
    out = breakdown.variants(src)
    assert tuple(out) == VARIANTS
    assert (out[name] == src) == (name == "as_is")
