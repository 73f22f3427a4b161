"""``experiments/scatter_breakdown.py``'s variants still apply to the kernel.

The probe builds its variants by exact-text edits of ``csrc/mp_scatter.cu``
and the ring it includes, ``csrc/long_rows.cuh``; an edit to the lines it
names breaks it. This checks on the CPU (no nvcc, no card) that every
variant applies to the sources as they stand and changes them.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
VARIANTS = ("as_is", "no_fold", "barriers_only", "grid_form",
            "no_copies", "sort_only", "no_units", "sort_bits_only")


@pytest.fixture(scope="module")
def breakdown():
    spec = importlib.util.spec_from_file_location(
        "scatter_breakdown", REPO / "experiments" / "scatter_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_applies_to_the_kernel_source(breakdown, name):
    srcs = breakdown.sources(breakdown.build.CSRC)
    assert set(srcs) == {"mp_scatter.cu", "long_rows.cuh"}
    out = breakdown.variants(srcs)
    assert tuple(out) == VARIANTS
    assert (out[name] == srcs) == (name == "as_is")
