"""``experiments/flash_breakdown.py``'s variants still apply to the kernel.

The probe builds its variants by exact-text edits of
``csrc/flash_attention.cu``; an edit to the lines it names breaks it. This
checks on the CPU (no nvcc, no card) that every variant applies to the
source as it stands and changes it.
"""

import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
VARIANTS = ("as_is", "one_p_term", "no_products", "loads_only", "fast_exp",
            "fused_passes", "heads_first", "head_by_head", "two_terms_f32",
            "no_fold_f32", "split_only_f32")


@pytest.fixture(scope="module")
def breakdown():
    spec = importlib.util.spec_from_file_location(
        "flash_breakdown", REPO / "experiments" / "flash_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_applies_to_the_kernel_source(breakdown, name):
    src = breakdown.SRC.read_text()
    out = breakdown.variants(src)
    assert tuple(out) == VARIANTS
    assert (out[name] == src) == (name == "as_is")
