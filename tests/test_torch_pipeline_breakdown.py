"""``experiments/pipeline_breakdown.py``'s variants still apply to the
kernels.

The probe builds its variants by exact-text edits of ``csrc/mp_pipeline.cuh``
and ``csrc/seg_softmax.cu``; an edit to the lines it names breaks it. This
checks on the CPU (no nvcc, no card) that every variant of the
owner-bucketed design applies to the sources as they stand and changes
them.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
VARIANTS = {
    "mp_pipeline": ("as_is", "no_exp", "no_att_pass", "classify_only",
                    "empty"),
    "seg_softmax": ("as_is", "no_exp", "classify_only", "empty"),
}


@pytest.fixture(scope="module")
def breakdown():
    spec = importlib.util.spec_from_file_location(
        "pipeline_breakdown", REPO / "experiments" / "pipeline_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,name", [
    (kernel, name) for kernel, names in VARIANTS.items() for name in names])
def test_variant_applies_to_the_kernel_source(breakdown, kernel, name):
    src = (breakdown.build.CSRC / breakdown.SOURCES[kernel][0]).read_text()
    assert breakdown.BUCKET_MARK in src
    out = breakdown.variants(kernel, src)
    assert tuple(out) == VARIANTS[kernel]
    assert (out[name] == src) == (name == "as_is")
