"""Initialization: JAX-native factor analysis.

The reference seeds the model with scikit-learn's FactorAnalysis fit on a
~10% row subsample (``vlgp/preprocess.py:4-46``): loading ``a`` from the FA
components, bias ``b = log(mean(y))``, Gaussian noise from the FA residual,
and per-trial posterior means from ``fa.transform``.  Here FA is a small EM
loop in JAX (deterministic given a PRNG key), and the "transform" closure the
reference stashes in ``params['transform']`` becomes an explicit
:class:`FactorModel` pytree so it can be checkpointed and re-used by
``transform`` on new trials.
"""
from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax import lax

from .pytree import PyTreeNode

__all__ = ["FactorModel", "fit_factor_analysis", "initialize"]


class FactorModel(PyTreeNode):
    """Fitted factor-analysis model y ~ N(mean + z @ a, diag(psi))."""

    mean: jnp.ndarray  # (ydim,)
    a: jnp.ndarray  # (zdim, ydim) loading (rows = factors)
    psi: jnp.ndarray  # (ydim,) noise variances

    def transform(self, y):
        """Posterior mean of z given y (the sklearn ``fa.transform`` analog).

        z = (I + A Psi^-1 A^T)^-1 A Psi^-1 (y - mean)
        """
        a, psi = self.a, self.psi
        ap = a / psi[None, :]  # (z, y)
        m = jnp.eye(a.shape[0], dtype=a.dtype) + ap @ a.T
        return (y - self.mean) @ jnp.linalg.solve(m, ap).T


@functools.partial(jax.jit, static_argnames=("zdim", "n_iter", "eps"))
def fit_factor_analysis(y, zdim: int, n_iter: int = 64, eps: float = 1e-6) -> FactorModel:
    """EM for factor analysis (Ghahramani-Hinton), fully jittable.

    y: (n, ydim).  Replaces sklearn FactorAnalysis (preprocess.py:18-23).
    Jitted at module level so repeated fits at the same shapes reuse the
    executable (the eager fori_loop recompiled its scan per call).
    """
    y = jnp.asarray(y)
    n, ydim = y.shape
    mean = jnp.mean(y, axis=0)
    yc = y - mean
    var = jnp.maximum(jnp.var(yc, axis=0), eps)

    # PCA warm start for the loading
    _, s, vt = jnp.linalg.svd(yc, full_matrices=False)
    scale = s[:zdim] / jnp.sqrt(jnp.asarray(n, y.dtype))
    a0 = scale[:, None] * vt[:zdim]
    psi0 = jnp.maximum(var - jnp.sum(a0 ** 2, axis=0), eps)

    def em(_, carry):
        a, psi = carry
        ap = a / psi[None, :]  # (z, y)
        m = jnp.eye(zdim, dtype=y.dtype) + ap @ a.T  # (z, z)
        beta = jnp.linalg.solve(m, ap)  # (z, y): posterior map
        ez = yc @ beta.T  # (n, z)
        ezz = n * jnp.linalg.inv(m) + ez.T @ ez  # (z, z)
        ezy = ez.T @ yc  # (z, y)
        a_new = jnp.linalg.solve(ezz, ezy)
        psi_new = jnp.maximum(
            jnp.mean(yc * yc, axis=0) - jnp.einsum("zy,zy->y", a_new, ezy) / n, eps
        )
        return a_new, psi_new

    a, psi = lax.fori_loop(0, n_iter, em, (a0, psi0))
    return FactorModel(mean=mean, a=a, psi=psi)


def initialize(data, zdim: int, key, *, eps: float = 1e-8, subsample_frac: float = 0.1,
               min_subsample: int = 50, fa_iters: int = 64):
    """Initialize (factor_model, a, b, noise, mu) from data.

    Mirrors ``preprocess.initialize`` (preprocess.py:4-46): FA on a random
    row subsample, b = log(max(mean y, eps)) for the constant regressor,
    noise from the FA residual variance, per-trial mu from the FA transform.
    Rows are drawn from valid (unmasked) bins only.

    data: :class:`~vlgp_tpu.data.TrialSet`.
    Returns (fm, a, b, noise, mu) with mu of shape (N, T, zdim).
    """
    # the gather stays on device (jnp.take with a device index):
    # numpy-data[device-index] mixed indexing would force an eager
    # device->host readback of the index
    y = jnp.asarray(data.y).reshape(-1, data.ydim)
    mask = jnp.asarray(data.mask).reshape(-1)
    nvalid = y.shape[0]
    k = max(int(nvalid * subsample_frac) // 1, min_subsample)
    k = min(k, nvalid)
    # sample valid rows with replacement, weighted by the mask
    p = mask / jnp.sum(mask)
    idx = jax.random.choice(key, nvalid, shape=(k,), replace=True, p=p)
    ysub = jnp.take(y, idx, axis=0)

    fm = fit_factor_analysis(ysub, zdim, n_iter=fa_iters)

    a = fm.a
    # masked mean rate per channel (preprocess.py:22)
    mean_y = jnp.sum(y * mask[:, None], axis=0) / jnp.maximum(jnp.sum(mask), 1.0)
    b0 = jnp.log(jnp.maximum(mean_y, eps))
    z_sub = fm.transform(ysub)
    noise = jnp.var(ysub - z_sub @ a, axis=0)

    mu = jax.vmap(fm.transform)(data.y) * data.mask[..., None]
    return fm, a, b0, noise, mu
