"""Test harness: run on CPU with 8 virtual devices and float64.

Multi-device tests use the virtual CPU mesh (see SURVEY.md §4).  float64
lets us compare against the reference NumPy implementation at tight
tolerances.  The platform is forced through jax.config, which holds
whatever JAX_PLATFORMS says.  Tests marked ``gpu`` need a card and run
through ``chip_smoke.py``'s checks; the ``gpu_device`` fixture skips them
here.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Free compiled executables between test modules.  The full suite compiles
# several hundred XLA:CPU executables in one process; past ~150 live
# executables the CPU client segfaults inside backend_compile (observed
# deterministically at tests/test_regression_pin.py when run after the
# full alphabetical prefix, while every subset passes).  Per-module
# clearing keeps the live set bounded; recompile-count assertions all
# hold within a single module, so they are unaffected.
_last_module = [None]


def pytest_runtest_setup(item):
    mod = item.module.__name__
    if _last_module[0] is not None and mod != _last_module[0]:
        jax.clear_caches()
    _last_module[0] = mod


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip.  Decided when the test runs, never at
    import, so every xdist worker collects the same tests; under this
    harness (CPU forced) it always skips, and the card runs the same checks
    through ``chip_smoke.py``."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return gpus[0]
