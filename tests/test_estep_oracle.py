"""Property tests of the E-step against dense-linear-algebra oracles.

The reference gives almost no oracle assertions (SURVEY §4); these verify
the low-rank Woodbury identities directly against dense solves.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from vlgp_tpu.config import default_config, make_params
from vlgp_tpu.data import pack_trials
from vlgp_tpu.models.gp import make_cholesky, posterior_cov
from vlgp_tpu.models.vlgp import (
    _marginal_variance,
    _woodbury_delta,
    _woodbury_inverse,
    estep,
    update_w,
)


def test_woodbury_delta_matches_dense():
    """delta = S (G G' s - mu) with S = (I + K W)^{-1}: the Newton step the
    reference assembles piecewise at core.py:85-97.  Inputs latent-major
    (Z, S, T)."""
    rng = np.random.default_rng(0)
    T, R, Z, S = 40, 40, 2, 3
    G = np.stack([np.linalg.cholesky(
        np.exp(-om * (np.arange(T)[:, None] - np.arange(T)) ** 2) + 1e-8 * np.eye(T)
    ) for om in (1e-2, 3e-2)])  # (Z, T, R) full-rank factors
    s = rng.normal(size=(Z, S, T))
    mu = rng.normal(size=(Z, S, T))
    w = np.abs(rng.normal(size=(Z, S, T))) + 0.1

    X = _woodbury_inverse(jnp.asarray(G), jnp.asarray(w))
    delta = np.asarray(
        _woodbury_delta(jnp.asarray(G), jnp.asarray(s), jnp.asarray(mu),
                        jnp.asarray(w), X)
    )

    for i in range(S):
        for l in range(Z):
            K = G[l] @ G[l].T
            u = K @ s[l, i] - mu[l, i]
            W = np.diag(w[l, i])
            # delta = u - K W (I + K W)^-1 u  == (I + KW)^-1 u
            expected = np.linalg.solve(np.eye(T) + K @ W, u)
            assert np.abs(delta[l, i] - expected).max() < 1e-8


def test_marginal_variance_matches_dense():
    rng = np.random.default_rng(1)
    T, Z, S = 30, 2, 2
    G = np.stack([np.linalg.cholesky(
        np.exp(-om * (np.arange(T)[:, None] - np.arange(T)) ** 2) + 1e-8 * np.eye(T)
    ) for om in (1e-2, 3e-2)])
    w = np.abs(rng.normal(size=(Z, S, T))) + 0.1
    v = np.asarray(_marginal_variance(jnp.asarray(G), jnp.asarray(w), 0.0))
    for i in range(S):
        for l in range(Z):
            K = G[l] @ G[l].T
            Spost = np.linalg.inv(np.linalg.inv(K + 1e-10 * np.eye(T)) + np.diag(w[l, i]))
            assert np.abs(v[l, i] - np.diag(Spost)).max() < 1e-5


def test_posterior_cov_matches_dense():
    rng = np.random.default_rng(2)
    T = 25
    G = np.linalg.cholesky(
        np.exp(-0.01 * (np.arange(T)[:, None] - np.arange(T)) ** 2) + 1e-8 * np.eye(T)
    )
    w = np.abs(rng.normal(size=T)) + 0.1
    S = np.asarray(posterior_cov(jnp.asarray(w), jnp.asarray(G), reg=1e-9))
    K = G @ G.T + 1e-9 * np.eye(T)
    expected = np.linalg.inv(np.linalg.inv(K) + np.diag(w))
    assert np.abs(S - expected).max() < 1e-6


def test_estep_masked_equals_short_trial():
    """Pad+mask correctness: a padded short trial must produce the same
    posterior as the same trial packed at its true length (stationary
    kernel on a regular grid => factor restriction is exact)."""
    rng = np.random.default_rng(3)
    T_short, T_long, Y, Z = 37, 64, 6, 2
    a = rng.normal(size=(Z, Y)) * 0.4
    z = np.column_stack(
        [np.sin(np.linspace(0, 3 * np.pi, T_short)), np.cos(np.linspace(0, 3 * np.pi, T_short))]
    )
    y = rng.poisson(np.exp(z @ a - 1.0)).astype(float)
    mu0 = rng.normal(size=(T_short, Z)) * 0.1
    trial = {"y": y, "mu": mu0}

    params = make_params(Y, Z, 1, "poisson", a=a, b=np.full((1, Y), -1.0),
                         omega=np.full(Z, 5e-3), dtype=jnp.float64)
    config = default_config(dtype="float64", Eniter=4, estep_tol=0)

    def run(pad_to):
        data = pack_trials([trial], Z, 1, dtype=np.float64)
        if pad_to > T_short:
            # repack with padding by adding a dummy longer trial, then slice
            dummy = {"y": np.zeros((pad_to, Y)), "mu": np.zeros((pad_to, Z))}
            data = pack_trials([trial, dummy], Z, 1, dtype=np.float64)
        G = make_cholesky(data.nbin, params)
        data = update_w(data, params, config)
        data = estep(data, params, G, config)
        return np.asarray(data.mu[0, :T_short])

    mu_short = run(T_short)
    mu_padded = run(T_long)
    assert np.abs(mu_short - mu_padded).max() < 5e-4


@pytest.mark.parametrize("estep_tol", [0.0, 3e-3])
def test_estep_f32_matches_f64(estep_tol):
    """The f32 E-step (the card's dtype) follows the float64 one, with a
    fixed sweep count and with the default adaptive exit."""
    from vlgp_tpu.data import cut_trials

    rng = np.random.default_rng(4)
    T, Y, Z = 120, 8, 2
    a = rng.normal(size=(Z, Y)) * 0.5
    z = np.column_stack([np.sin(np.linspace(0, 6, T)),
                         np.cos(np.linspace(0, 6, T))])
    trials = [{"y": rng.poisson(np.exp(z @ a - 1.0)).astype(float),
               "mu": rng.normal(size=(T, Z)) * 0.1} for _ in range(3)]

    def run(dtype):
        params = make_params(Y, Z, 1, "poisson", a=a, b=np.full((1, Y), -1.0),
                             omega=np.full(Z, 1e-2), dtype=jnp.dtype(dtype))
        config = default_config(dtype=dtype, Eniter=6, estep_tol=estep_tol,
                                window=30)
        seg = cut_trials(pack_trials(trials, Z, 1, dtype=np.dtype(dtype)),
                         config.window, seed=0)
        G = make_cholesky(seg.nbin, params, rank=24)
        seg = update_w(seg, params, config)
        return estep(seg, params, G, config)

    out64 = run("float64")
    out32 = run("float32")
    mu64 = np.asarray(out64.mu)
    assert np.abs(np.asarray(out32.mu) - mu64).max() < 1e-3 * np.abs(mu64).max()
    assert np.abs(np.asarray(out32.v) - np.asarray(out64.v)).max() < 1e-3
