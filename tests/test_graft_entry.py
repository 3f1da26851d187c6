"""Driver-contract regression: `python __graft_entry__.py` must pass in a
fresh process on whatever backend that process picks by default.

The scenario: one accelerator as the default backend, `dryrun_multichip(8)`
needing an 8-device mesh.  The entry must provision virtual CPU devices
itself and run the mesh step there.  On a CPU-only host the same script
exercises the virtual-mesh path.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_graft_entry_script():
    env = dict(os.environ)
    # do NOT force a platform: the point is that the script must cope with
    # whatever the driver environment provides
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "__graft_entry__.py")],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        # generous: the full suite's 8-device CPU tests contend for the
        # host
        timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "entry ok" in proc.stdout
    assert "dryrun_multichip(8) ok" in proc.stdout


_UNHEALTHY_GPU_SCRIPT = r"""
import jax
from jax._src import xla_bridge as xb

def _boom(*a, **k):
    raise RuntimeError("simulated unhealthy GPU backend")

# Replace the GPU factories with ones that die on initialization and put
# the GPU platform first in jax_platforms: merely *discovering* the default
# backend then raises.
xb.register_backend_factory("cuda", _boom, priority=500, fail_quietly=False)
xb.register_backend_factory("rocm", _boom, priority=500, fail_quietly=False)
jax.config.update("jax_platforms", "cuda,cpu")

import __graft_entry__
__graft_entry__.dryrun_multichip(8)
print("dryrun survived unhealthy gpu")
"""


def test_dryrun_survives_unhealthy_tpu_backend():
    """dryrun_multichip must never initialize the default accelerator
    backend — it is specified to run on a virtual CPU mesh.  An unhealthy
    GPU factory (raises on init) must not be reachable."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _UNHEALTHY_GPU_SCRIPT],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, (proc.stderr[-3000:], proc.stdout[-500:])
    assert "dryrun survived unhealthy gpu" in proc.stdout
