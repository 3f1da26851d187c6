"""Quick A/B: EM iterations/sec on the flagship config.

Measures only the scanned-EM per-iteration time, no convergence scoring,
on the default JAX device (printed first).  Usage:

    python tools/ab_em.py [label] [config_key=json_value ...]

e.g. ``python tools/ab_em.py grid0 hyper_grid=0``.
"""
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import vlgp_tpu  # noqa: E402
from vlgp_tpu.config import default_config, make_params  # noqa: E402
from vlgp_tpu.data import cut_trials, pack_trials  # noqa: E402
from vlgp_tpu.models.driver import _scan_em_jit  # noqa: E402
from vlgp_tpu.models.gp import effective_rank, make_cholesky  # noqa: E402
from vlgp_tpu.models.vlgp import update_w  # noqa: E402


def main(iters=10, reps=4):
    label = sys.argv[1] if len(sys.argv) > 1 else "run"
    kw = {}
    for item in sys.argv[2:]:
        k, v = item.split("=", 1)
        try:
            kw[k] = json.loads(v)
        except json.JSONDecodeError:
            kw[k] = v
    # harness knobs (not Config fields): scan-block length and repetitions
    iters = int(kw.pop("iters", iters))
    reps = int(kw.pop("reps", reps))
    vlgp_tpu.enable_compilation_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    trials, a, zt = bench.make_workload()
    config = default_config(**kw)
    params = make_params(
        bench.YDIM, bench.ZDIM, 1, "poisson", a=a,
        b=np.full((1, bench.YDIM), -2.0, np.float32),
        omega=np.full(bench.ZDIM, 1e-2),
    )
    data = pack_trials(trials, bench.ZDIM, 1)
    seg = cut_trials(data, config.window, seed=0)
    seg_rank = min(params.rank,
                   effective_rank(seg.nbin, config.omega_bound[1], 1.0))
    G = make_cholesky(seg.nbin, params, rank=seg_rank)
    seg = update_w(seg, params, config)
    em = _scan_em_jit(config, iters)

    t0 = time.perf_counter()
    d, p, g, _ = em(seg, params, G)
    float(jnp.sum(p.a))
    print(f"[{label}] compile+first: {time.perf_counter() - t0:.1f}s")

    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        dd, pp, gg, _ = em(d, p, g)
        checksum = float(jnp.sum(pp.a)) + float(jnp.sum(dd.mu))
        assert np.isfinite(checksum)
        dt = (time.perf_counter() - t0) / iters
        best = min(best, dt)
        print(f"[{label}] rep {rep}: {1.0 / dt:.3f} it/s ({dt * 1e3:.1f} ms/it)")
    print(f"[{label}] BEST {1.0 / best:.3f} it/s")


if __name__ == "__main__":
    main()
