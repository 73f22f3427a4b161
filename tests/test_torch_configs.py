"""The port's configs package against the JAX package's.

``get_config`` / ``get_reduced``, the re-exported names and every per-arch
module (``CONFIG``, ``REDUCED_CONFIG``) hold the reference's fields, the
dtype mapped from jnp to torch; ``configs/flowgnn.py::CONFIGS`` holds the
paper's six GNN configs.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as J  # noqa: E402
import repro_torch.configs as T  # noqa: E402

DTYPES = {np.dtype(jnp.float32): torch.float32,
          np.dtype(jnp.bfloat16): torch.bfloat16}
MODULES = ("arctic_480b", "deepseek_67b", "gemma2_27b", "internvl2_2b",
           "llama3_8b", "mamba2_2_7b", "musicgen_large", "olmoe_1b_7b",
           "qwen1_5_0_5b", "recurrentgemma_2b")


def _same(t, j):
    assert dataclasses.fields(t) and [f.name for f in dataclasses.fields(t)] \
        == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert a == DTYPES[np.dtype(b)], f.name
        else:
            assert a == b, f.name


def test_the_package_exports_the_reference_names():
    want = {n for n in dir(J) if not n.startswith("_")} - {
        "archs", "base"}
    assert want <= set(dir(T))
    assert set(T.SHAPES) == set(J.SHAPES)
    assert T.LONG_CONTEXT_OK == J.LONG_CONTEXT_OK
    assert T.shape_applicable("llama3-8b", "long_500k") == \
        J.shape_applicable("llama3-8b", "long_500k")
    _same(T.TrainConfig(), J.TrainConfig())


@pytest.mark.parametrize("arch", sorted(J.ARCHS))
def test_get_config_and_get_reduced_match(arch):
    _same(T.get_config(arch), J.get_config(arch))
    _same(T.get_reduced(arch), J.get_reduced(arch))


@pytest.mark.parametrize("mod", MODULES)
def test_per_arch_modules_match(mod):
    t = importlib.import_module(f"repro_torch.configs.{mod}")
    j = importlib.import_module(f"repro.configs.{mod}")
    assert t.__all__ == j.__all__ == ["CONFIG", "REDUCED_CONFIG"]
    _same(t.CONFIG, j.CONFIG)
    _same(t.REDUCED_CONFIG, j.REDUCED_CONFIG)
    assert t.CONFIG is T.get_config(t.CONFIG.name)


def test_flowgnn_configs_match():
    from repro.configs.flowgnn import CONFIGS as JC
    from repro_torch.configs.flowgnn import CONFIGS as TC
    assert set(TC) == set(JC)
    for name in JC:
        _same(TC[name], JC[name])
