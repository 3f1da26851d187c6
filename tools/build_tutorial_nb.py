"""Build and execute notebook/tutorial.ipynb (VERDICT-r1 #10).

Mirrors the reference notebook/tutorial.ipynb cells 9-27 (Lorenz ->
Poisson spikes -> fit -> aligned-trajectory figure) on top of the
vlgp_tpu API.  Run: python tools/build_tutorial_nb.py
"""
import pathlib

import nbformat as nbf
from nbclient import NotebookClient

ROOT = pathlib.Path(__file__).resolve().parents[1]

md = nbf.v4.new_markdown_cell
code = nbf.v4.new_code_cell

cells = [
    md(
        "# vLGP tutorial — recovering Lorenz dynamics from spikes\n"
        "\n"
        "JAX port of the reference tutorial "
        "(`notebook/tutorial.ipynb` cells 9–27 in catniplab/vlgp): simulate "
        "a population of Poisson neurons driven by a 3-D Lorenz latent "
        "trajectory, fit a 3-factor vLGP model, and compare the inferred "
        "posterior mean to the ground truth after least-squares alignment "
        "(the latent space is only identified up to a linear map).\n"
        "\n"
        "Runs on whatever `jax.devices()` provides — a GPU when attached, "
        "CPU otherwise."
    ),
    code(
        "import numpy as np\n"
        "import jax\n"
        "import jax.numpy as jnp\n"
        "import matplotlib.pyplot as plt\n"
        "\n"
        "import vlgp_tpu\n"
        "from vlgp_tpu.simulation import lorenz, spike\n"
        "from vlgp_tpu.utils.misc import rotate\n"
        "\n"
        "print('devices:', jax.devices())"
    ),
    md(
        "## Simulate\n"
        "A single long Lorenz trajectory (normalized to zero mean / unit "
        "scale per dimension), cut into 10 trials of 500 bins; each neuron "
        "fires as a Poisson process with rate $\\exp(z a + b)$ "
        "(`vlgp_tpu.simulation.spike`, mirroring the reference "
        "`simulation.py:11-59`)."
    ),
    code(
        "n_trials, n_bins, n_neurons, n_factors = 10, 500, 50, 3\n"
        "\n"
        "# reference tutorial parameters (cells 11, 15): z-scored Lorenz,\n"
        "# loadings with magnitudes in [1, 2], base rate 15 spikes/trial,\n"
        "# and a 10-lag refractory spike-history filter in the simulator\n"
        "skip = 500\n"
        "traj = np.asarray(lorenz(skip + n_trials * n_bins, dt=5e-3,\n"
        "                         normalized=False))[skip:]\n"
        "traj = (traj - traj.mean(0)) / traj.std(0)\n"
        "zt = traj\n"
        "x = traj.reshape(n_trials, n_bins, 3)\n"
        "\n"
        "rng = np.random.default_rng(0)\n"
        "a = (rng.random((3, n_neurons)) + 1) * np.sign(\n"
        "    rng.standard_normal((3, n_neurons)))\n"
        "one = np.ones(n_neurons)\n"
        "b = np.vstack([np.log(15 / n_bins) * one, -10 * one, -10 * one,\n"
        "               -3 * one, -3 * one, -3 * one, -3 * one,\n"
        "               -2 * one, -2 * one, -1 * one, -1 * one])\n"
        "\n"
        "y, _, _ = spike(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),\n"
        "                jax.random.PRNGKey(0))\n"
        "trials = [{'y': np.asarray(y[i], float), 'id': i}\n"
        "          for i in range(n_trials)]\n"
        "z_true = [x[i] for i in range(n_trials)]\n"
        "print('mean rate per bin:', np.mean([t['y'].mean() for t in trials]).round(4))"
    ),
    code(
        "fig, axes = plt.subplots(2, 1, figsize=(9, 5), sharex=True)\n"
        "axes[0].plot(z_true[0])\n"
        "axes[0].set_ylabel('latent $z(t)$')\n"
        "axes[0].legend(['$z_1$', '$z_2$', '$z_3$'], loc='upper right')\n"
        "t, n = np.nonzero(trials[0]['y'])\n"
        "axes[1].scatter(t, n, s=1, c='k')\n"
        "axes[1].set_ylabel('neuron')\n"
        "axes[1].set_xlabel('time bin')\n"
        "axes[1].set_title('trial 0 spike raster')\n"
        "fig.tight_layout()"
    ),
    md(
        "## Fit\n"
        "`vlgp_tpu.fit` runs the full reference pipeline (FA init → "
        "segment VEM → full-length inference) as batched XLA computations."
    ),
    code(
        "import time\n"
        "tic = time.time()\n"
        "result = vlgp_tpu.fit(trials, n_factors, max_iter=20, min_iter=10)\n"
        "print(f'fit in {time.time() - tic:.1f}s '\n"
        "      f'({result.runtime[\"it\"]} EM iterations)')\n"
        "print('learned omega:', np.asarray(result.params.omega))"
    ),
    md(
        "## Align and evaluate\n"
        "The posterior mean lives in an arbitrary linear basis; align it to "
        "the truth by least squares (reference `util.rotate`) and report "
        "$R^2$."
    ),
    code(
        "mu = np.concatenate([t['mu'] for t in result.trials])\n"
        "aligned = np.asarray(rotate(jnp.column_stack([mu, np.ones(len(mu))]),\n"
        "                            jnp.asarray(zt)))\n"
        "r2 = 1 - np.sum((aligned - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2)\n"
        "print(f'latent recovery R^2 (lstsq-aligned) = {r2:.3f}')\n"
        "assert r2 >= 0.88, r2  # seed-dependent band: 0.89-0.92"
    ),
    code(
        "fig, axes = plt.subplots(3, 1, figsize=(9, 6), sharex=True)\n"
        "T0 = n_bins  # show the first trial\n"
        "for d, ax in enumerate(axes):\n"
        "    ax.plot(zt[:T0, d], 'k', lw=1.5, label='truth')\n"
        "    ax.plot(aligned[:T0, d], 'C1', lw=1.2, label='vLGP posterior')\n"
        "    ax.set_ylabel(f'$z_{d + 1}$')\n"
        "axes[0].legend(loc='upper right')\n"
        "axes[0].set_title(f'aligned posterior vs truth (trial 0), '\n"
        "                  f'$R^2$ = {r2:.3f}')\n"
        "axes[-1].set_xlabel('time bin')\n"
        "fig.tight_layout()"
    ),
    md(
        "### Head-to-head with the reference\n"
        "Measured head-to-head on the reference's *own* simulation of "
        "this workload (its NumPy RNG and simulator, same data to both "
        "fitters, 20 EM iterations, this host \u2014 `tools/head2head.py`): "
        "reference $R^2 = 0.921$; this engine $R^2 = 0.927$ self-tuned "
        "($0.922$ when handed the reference's learned lengthscales; on an "
        "independent draw, `tools/indep_draw.py`, ours $0.929$ vs the "
        "reference's $0.925$). "
        "The reference's inconsistent-gradient L-BFGS collapses every "
        "$\\omega$ to the lower bound (maximal smoothing) and pins the GP "
        "amplitude $\\sigma$; this engine's consistent fixed-posterior "
        "H-step scans candidate lengthscales with a batched grid, learns "
        "$\\sigma$ by closed-form profiling, and staggers the $\\omega$ "
        "init over the smooth side of the box "
        "(see `models/gp.py` and `api.py:_prepare`)."
    ),
    md(
        "## Posterior uncertainty\n"
        "Joint posterior samples for one trial via the low-rank sampler "
        "($O(Tr)$ per sample, replacing the reference's dense $O(T^3)$ "
        "construction, api.py:142-168)."
    ),
    code(
        "samples = np.asarray(vlgp_tpu.sample_posterior(result, 0, 200))\n"
        "lo, hi = np.percentile(samples, [5, 95], axis=0)\n"
        "fig, ax = plt.subplots(figsize=(9, 2.6))\n"
        "ax.fill_between(np.arange(lo.shape[0]), lo[:, 0], hi[:, 0],\n"
        "                alpha=0.3, label='90% band')\n"
        "ax.plot(np.asarray(result.trials[0]['mu'])[:, 0], lw=1.2,\n"
        "        label='posterior mean')\n"
        "ax.set_xlabel('time bin')\n"
        "ax.set_ylabel('$z_1$')\n"
        "ax.legend(loc='upper right')\n"
        "fig.tight_layout()"
    ),
]

nb = nbf.v4.new_notebook(cells=cells, metadata={
    "kernelspec": {"display_name": "Python 3", "language": "python",
                   "name": "python3"},
    "language_info": {"name": "python"},
})

out = ROOT / "notebook" / "tutorial.ipynb"
out.parent.mkdir(exist_ok=True)
client = NotebookClient(nb, timeout=1800, kernel_name="python3",
                        resources={"metadata": {"path": str(ROOT)}})
client.execute()
nbf.write(nb, out)
print(f"executed notebook -> {out}")
