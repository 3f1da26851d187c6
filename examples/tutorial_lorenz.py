"""Tutorial: recover Lorenz-attractor latents from simulated spikes.

Reproduces the reference tutorial workload (notebook/tutorial.ipynb cells
9-27): Lorenz trajectory -> 3 latent dims -> Poisson spike trains from 50
neurons over 10 trials x 500 bins, fit with 3 factors, then lstsq-align the
posterior mean to the true trajectory.

Run: python examples/tutorial_lorenz.py  [--trials 10 --bins 500 --neurons 50]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import time

import numpy as np
import jax
import jax.numpy as jnp

import vlgp_tpu
from vlgp_tpu.simulation import lorenz, spike
from vlgp_tpu.utils.misc import rotate

# persist compiled executables across runs ($JAX_COMPILATION_CACHE_DIR,
# else <repo>/.jax_cache)
vlgp_tpu.enable_compilation_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--bins", type=int, default=500)
    p.add_argument("--neurons", type=int, default=50)
    p.add_argument("--factors", type=int, default=3)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("--dtype", type=str, default="float32")
    args = p.parse_args()

    key = jax.random.PRNGKey(0)
    # shared Lorenz trajectory, per-trial random phase offset into it
    traj = np.asarray(lorenz(args.bins * args.trials + 1000, normalized=True))
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, args.neurons)) * 0.6
    b = np.full((1, args.neurons), -2.5)

    z_true, trials = [], []
    for i in range(args.trials):
        start = 1000 + i * args.bins
        z = traj[start : start + args.bins] * 2.0
        key, sub = jax.random.split(key)
        y, _, _ = spike(jnp.asarray(z), jnp.asarray(a), jnp.asarray(b), sub)
        trials.append({"y": np.asarray(y[0], float), "id": i})
        z_true.append(z)

    print(f"fitting {args.trials} trials x {args.bins} bins x {args.neurons} "
          f"neurons, {args.factors} factors")
    tic = time.time()
    result = vlgp_tpu.fit(
        trials, args.factors, max_iter=args.max_iter, dtype=args.dtype,
        verbose=True,
    )
    print(f"fit in {time.time() - tic:.1f}s")

    mu = np.concatenate([t["mu"] for t in result.trials])
    zt = np.concatenate(z_true)
    aligned = np.asarray(rotate(jnp.column_stack([mu, np.ones(len(mu))]),
                                jnp.asarray(zt)))
    r2 = 1 - np.sum((aligned - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2)
    print(f"latent recovery R^2 (lstsq-aligned) = {r2:.3f}")
    print(f"learned omega = {np.asarray(result.params.omega)}")


if __name__ == "__main__":
    main()
