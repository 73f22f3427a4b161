"""The port stands alone: no ``jax`` and nothing of the JAX package.

Checked twice: by importing every module of ``repro_torch``,
``chip_smoke`` and the port's examples (``examples/*_torch.py``) in a
fresh interpreter and looking at ``sys.modules``, and by walking their
syntax trees for an ``import jax`` or ``from repro...``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
EXAMPLES = sorted((REPO / "examples").glob("*_torch.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + EXAMPLES


def _module_names():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in _module_names()]
        + ["import chip_smoke", "import importlib.util as u"]
        + [f"s = u.spec_from_file_location({p.stem!r}, {str(p)!r}); "
           f"s.loader.exec_module(u.module_from_spec(s))" for p in EXAMPLES]
        + ["bad = sorted(m for m in sys.modules if m == 'jax' or "
           "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))",
           "assert not bad, bad",
           "print('ok', len(sys.modules))"])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def _bad_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno} {name}")
    return bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    assert _bad_imports(path) == []


def test_both_port_examples_are_walked():
    assert [p.name for p in EXAMPLES] == ["gnn_streaming_torch.py",
                                          "quickstart_torch.py",
                                          "train_lm_torch.py"]


def test_walker_catches_a_reference_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                     "from repro_torch.core import y\n")
    assert len(_bad_imports(probe)) == 2


def test_the_mesh_modules_are_walked():
    """The mesh and the tools on it stand alone like the rest of the port."""
    names = set(_module_names())
    for mod in ("repro_torch.distributed.collectives",
                "repro_torch.distributed.elastic",
                "repro_torch.distributed.pipeline",
                "repro_torch.distributed.sharding",
                "repro_torch.launch.mesh",
                "repro_torch.optim.compression"):
        assert mod in names
        path = REPO / "src" / (mod.replace(".", "/") + ".py")
        assert path in SOURCES and _bad_imports(path) == []
