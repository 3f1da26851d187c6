"""Model selection: speckled cross-validation over n_factors.

Reference: ``vlgp/model_selection.py`` — element-wise held-out masks over
the GPFA engine.  The reference leaves ``training_error`` unbound when an
inner fit throws (model_selection.py:43-46); errors propagate here.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .config import Config
from .data import cut_trials, pack_trials
from .init import initialize
from .models import gpfa

__all__ = ["speckled_cv", "gmap_speckled_cv", "elementwise_error", "leave_one_neuron_out"]


def elementwise_error(yhat, y):
    """Squared element-wise prediction error (model_selection.py:25-28)."""
    r = yhat - y
    return r * r


def speckled_cv(y, C, d, R, K, test_ratio: float, max_iter: int, key):
    """Speckled CV on one stacked segment set (model_selection.py:11-22).

    Masks a random fraction of entries, fits GPFA on the unmasked data
    (masked entries imputed as the mean), scores both partitions.
    """
    y = jnp.asarray(y)
    test_mask = jax.random.uniform(key, y.shape) < test_ratio
    y = y - jnp.mean(y)  # center so 0-imputation is the mean (ms.py:13)
    y_training = jnp.where(test_mask, 0.0, y)

    z, C, d, R = gpfa.em(y_training, C, d, R, K, max_iter)
    yhat = jnp.einsum("mtz,zy->mty", z, C) + d[None, None, :]
    err = elementwise_error(yhat, y)

    training_error = jnp.mean(jnp.where(test_mask, 0.0, err)) / jnp.mean(~test_mask)
    test_error = jnp.sum(jnp.where(test_mask, err, 0.0)) / jnp.maximum(
        jnp.sum(test_mask), 1
    )
    return float(training_error), float(test_error)


def gmap_speckled_cv(
    trials: Sequence[dict],
    n_factors_list: Sequence[int],
    test_ratio: float = 0.1,
    *,
    dt: float,
    var: float,
    scale: float,
    max_iter: int,
    seed: int = 0,
    window: int = 50,
) -> Tuple[list, list]:
    """CV sweep over candidate factor counts (model_selection.py:31-50)."""
    training_errors = []
    test_errors = []
    key = jax.random.PRNGKey(seed)
    for n_factors in n_factors_list:
        key, sub, init_key = jax.random.split(key, 3)
        config = Config(window=window)
        data = pack_trials(trials, n_factors)
        _, a0, b0, _, _ = initialize(data, n_factors, init_key)
        segments = cut_trials(data, window, seed=seed)
        K = gpfa.make_prior(segments.nbin, dt, var, scale)
        R0 = jnp.ones(data.ydim, dtype=K.dtype)
        tr, te = speckled_cv(
            segments.y, a0, jnp.exp(b0), R0, K, test_ratio, max_iter, sub
        )
        training_errors.append(tr)
        test_errors.append(te)
    return training_errors, test_errors


def leave_one_neuron_out(
    result,
    neurons: Sequence[int] | None = None,
    batch: int = 25,
):
    """Leave-one-neuron-out predictive score for a fitted model.

    For each held-out channel n: infer latents from the *other* channels
    under the fitted parameters, then score channel n's observations under
    the model prediction (Poisson log-likelihood up to the y! constant, or
    Gaussian negative squared error).  This is the co-smoothing metric the
    BASELINE configs call for; the reference has no implementation.

    result: :class:`~vlgp_tpu.api.FitResult`.
    Returns dict {neuron: mean predictive log-likelihood per bin}.

    Compiles ONCE and dispatches ONCE for any number of held-out neurons
    (a per-neuron dispatch loop would pay Y host round-trips for an
    embarrassingly-vmappable sweep).  Inside the single executable the
    neuron axis runs as ``lax.map(..., batch_size=batch)``: chunks of
    ``batch`` neurons vmapped concurrently, scanned sequentially, bounding
    peak memory at batch x (one full inference).  The request is padded to
    a multiple of ``batch`` so every call at the same (config, shapes)
    shares one executable regardless of subset size.

    The held-out channel is excluded by zeroing its loading column: every
    posterior update contracts the channel axis against ``a`` — the E-step
    residual projection ``s = einsum(residual, a)`` and the weights
    ``w = U (a*a)'`` (models/vlgp.py) — so a zero column removes channel
    n's influence *exactly*, with no shape change.
    """
    import numpy as np

    from .models.gp import make_cholesky

    data, params, config = result.data, result.params, result.config
    ydim = params.ydim
    if neurons is None:
        neurons = range(ydim)
    neurons = [int(n) for n in neurons]
    if not neurons:
        return {}

    G = make_cholesky(data.nbin, params)
    d0 = data.replace(
        mu=jnp.zeros_like(data.mu), w=jnp.zeros_like(data.w),
        v=jnp.zeros_like(data.v), dmu=jnp.zeros_like(data.dmu),
    )
    from .models.driver import _jit_key

    B = max(1, min(batch, ydim))
    score_many = _lono_scorer(_jit_key(config), ydim, B)
    k = len(neurons)
    padded = -(-k // B) * B
    idx = np.asarray(neurons + [neurons[-1]] * (padded - k), np.int32)
    scores = np.asarray(score_many(jnp.asarray(idx), d0, params, G))
    return {n: float(s) for n, s in zip(neurons, scores[:k])}


@functools.lru_cache(maxsize=32)
def _lono_scorer(config: Config, ydim: int, batch: int):
    """One jitted all-neurons scorer, cached on (config, ydim, batch) so
    repeated leave_one_neuron_out calls at the same shapes reuse the
    executable.  Takes a (k,) index vector; the per-neuron inference runs
    as lax.map with batch_size=batch (vmap within chunks, scan across)."""
    from .models.vlgp import estep, update_v, update_w

    def score_one(n, d0, params, G):
        cmask = (jnp.arange(ydim) != n).astype(params.a.dtype)
        p_n = params.replace(a=params.a * cmask)
        d_n = update_w(d0, p_n, config)
        d_n = update_v(d_n, p_n, G, config)
        d_n = estep(d_n, p_n, G, config, niter=config.max_iter)

        # predict the held-out channel from the inferred latents, under the
        # FULL fitted parameters
        a_n = jnp.take(params.a, n, axis=1)  # (z,)
        b_n = jnp.take(params.b, n, axis=1)  # (x,)
        eta = jnp.einsum("stz,z->st", d_n.mu, a_n) + jnp.einsum(
            "stx,x->st", jnp.take(d0.x, n, axis=3), b_n
        )
        m = d0.mask
        nvalid = jnp.maximum(jnp.sum(m), 1.0)
        y_n = jnp.take(d0.y, n, axis=2)
        noise_n = jnp.take(params.noise, n)
        ll_pois = jnp.sum((y_n * eta - jnp.exp(eta)) * m) / nvalid
        quad = 0.5 * jnp.einsum("stz,z->st", d_n.v, a_n * a_n)
        resid = (y_n - eta) * m
        ll_gauss = (
            -0.5 * jnp.sum(resid * resid / noise_n
                           + jnp.log(2 * jnp.pi * noise_n) * m) / nvalid
            - jnp.sum(quad * m) / nvalid / noise_n
        )
        return jnp.where(jnp.take(params.poisson, n), ll_pois, ll_gauss)

    @jax.jit
    def score_many(idx, d0, params, G):
        return jax.lax.map(
            lambda n: score_one(n, d0, params, G), idx, batch_size=batch
        )

    return score_many
