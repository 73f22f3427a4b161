import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # hypothesis is optional (see requirements.txt). On machines without it,
    # install a stub module so test files importing `given`/`settings`/
    # `strategies` still collect; property tests are skipped.
    class _NoopSettings:
        def __init__(self, *args, **kwargs):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*args, **kwargs):
            pass

        @staticmethod
        def load_profile(*args, **kwargs):
            pass

    def _skip_given(*args, **kwargs):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)
        return deco

    class _AnyStrategy:
        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _AnyStrategy()  # PEP 562
    _hyp.settings = _NoopSettings
    _hyp.given = _skip_given
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
    settings = _NoopSettings

# CPU container: keep hypothesis light and undeadlined
settings.register_profile("ci", max_examples=12, deadline=None,
                          derandomize=True)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; decides inside the test and "
        "skips where there is none")


def run_with_devices(code: str, n: int = 8, timeout: int = 420) -> str:
    """Run ``code`` in a subprocess with n fake host devices (the main test
    process must keep its single real device, so multi-device sharding tests
    isolate via fresh processes)."""
    env = os.environ.copy()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=timeout)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


@pytest.fixture
def rng():
    return np.random.default_rng(0)
