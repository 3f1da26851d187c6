"""Multi-device vLGP: fit over a ('data', 'model') mesh.

Runs on the default devices (e.g. four GPUs of one host); fails when there
are fewer than the mesh needs.  ``--virtual-cpu`` runs the same fit on
virtual CPU devices instead, for a laptop/CI demo.

Run: python examples/multichip.py [--data 2 --model 2] [--virtual-cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=int, default=2, help="data-parallel axis size")
    p.add_argument("--model", type=int, default=2, help="channel-parallel axis size")
    p.add_argument("--virtual-cpu", action="store_true",
                   help="run on virtual CPU devices")
    args = p.parse_args()

    n_needed = args.data * args.model

    import jax

    if args.virtual_cpu:
        # decided before any device query: a backend, once initialized,
        # can't be switched away from
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(8, n_needed))
    devs = jax.devices()
    if len(devs) < n_needed:
        raise SystemExit(
            f"need {n_needed} devices, {devs[0].platform} has {len(devs)}; "
            "pass --virtual-cpu for a virtual CPU mesh"
        )

    import numpy as np

    from vlgp_tpu.parallel.driver import fit_sharded
    from vlgp_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    zdim, ydim = 2, 16  # ydim must divide the model axis
    a = rng.normal(size=(zdim, ydim)) * 0.6
    trials, zs = [], []
    for _ in range(8):
        z = np.column_stack(
            (np.sin(np.linspace(0, 7, 150)), np.cos(np.linspace(0, 7, 150)))
        )
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float)})
        zs.append(z)

    mesh = make_mesh((args.data, args.model), devices=devs[:n_needed])
    print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} devices")
    result = fit_sharded(trials, zdim, mesh=mesh, verbose=True, max_iter=8)

    mu = np.concatenate([t["mu"] for t in result.trials])
    zt = np.concatenate(zs)
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    r2 = 1 - ((X @ beta - zt) ** 2).sum() / ((zt - zt.mean(0)) ** 2).sum()
    print(f"latent recovery R^2 = {r2:.3f}")
    print(f"omega = {np.asarray(result.params.omega)}")


if __name__ == "__main__":
    main()
