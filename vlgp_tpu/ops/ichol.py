"""Pivoted incomplete Cholesky of the SE kernel, XLA-native.

The reference implements this as a sequential NumPy loop with greedy
diagonal pivoting (``vlgp/math.py:76-169``).  It is the only inherently
sequential kernel in the model, but the iteration count equals the rank
(default 50) and each step is O(n) vector work, so it is expressed as a
``lax.fori_loop`` with a fixed trip count — the whole factorization stays
inside one XLA computation and can be vmapped over latent dimensions (each
with its own lengthscale) and jitted together with the EM step that consumes
it.

Differences from the reference, by design:
  * fixed ``rank`` iterations instead of a data-dependent tolerance stop;
    exhausted pivots (d <= tol) yield zero columns, which is equivalent to
    early stopping (trailing columns of the reference factor are zero too).
  * pivoting is tracked with an index vector and un-permuted by scatter at
    the end instead of in-place row swaps.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["ichol_gauss", "ichol_gauss_batch", "ichol", "nystrom_gauss_batch"]


@functools.partial(jax.jit, static_argnums=(0, 2))
def ichol_gauss(n: int, omega, rank: int, dt: float = 1.0, tol: float = 1e-10):
    """Incomplete Cholesky G of the SE kernel: K ~= G @ G.T.

    K[i, j] = exp(-omega * ((i - j) * dt)^2) on a regular n-point grid.
    Mirrors ``vlgp/math.py:76-126`` (greedy max-diagonal pivoting) as a
    jittable fixed-trip-count loop.

    Returns (n, rank) array.
    """
    dtype = jnp.result_type(jnp.asarray(omega).dtype, jnp.float32)
    omega = jnp.asarray(omega, dtype)
    x = jnp.arange(n, dtype=dtype) * dt
    rows = jnp.arange(n)
    cols = jnp.arange(rank)

    def body(i, carry):
        G, d, pvec = carry
        # greedy pivot: largest remaining diagonal (math.py:106-110)
        dm = jnp.where(rows >= i, d, -jnp.inf)
        jast = jnp.argmax(dm)
        # swap i <-> jast in pvec, d, and the rows of G
        pvec_i, pvec_j = pvec[i], pvec[jast]
        pvec = pvec.at[i].set(pvec_j).at[jast].set(pvec_i)
        d_i, d_j = d[i], d[jast]
        d = d.at[i].set(d_j).at[jast].set(d_i)
        g_i, g_j = G[i], G[jast]
        G = G.at[i].set(g_j).at[jast].set(g_i)

        alive = d[i] > tol
        gii = jnp.sqrt(jnp.maximum(d[i], tol))
        G = G.at[i, i].set(jnp.where(alive, gii, 0.0))
        # next kernel column in pivoted order (math.py:115-117)
        nextcol = jnp.exp(-omega * (x[pvec] - x[pvec[i]]) ** 2)
        # subtract projection onto previous columns (math.py:118)
        prev = jnp.where(cols < i, G[i], 0.0)
        proj = G @ prev
        newcol = jnp.where(alive, (nextcol - proj) / gii, 0.0)
        below = rows > i
        G = jnp.where(
            below[:, None] & (cols[None, :] == i), newcol[:, None], G
        )
        # refresh remaining diagonal (math.py:119)
        upto = cols <= i
        dnew = 1.0 - jnp.sum(jnp.where(upto[None, :], G, 0.0) ** 2, axis=1)
        d = jnp.where(below, dnew, d)
        return G, d, pvec

    G0 = jnp.zeros((n, rank), dtype)
    d0 = jnp.ones(n, dtype)
    pvec0 = rows
    G, d, pvec = lax.fori_loop(0, min(rank, n), body, (G0, d0, pvec0))
    # un-permute rows: out[pvec[k]] = G[k]  (math.py:126 `G[pvec.argsort()]`)
    out = jnp.zeros_like(G).at[pvec].set(G)
    return out


def ichol_gauss_batch(n: int, omega, rank: int, dt: float = 1.0):
    """vmap of :func:`ichol_gauss` over per-latent lengthscales.

    omega: (zdim,) -> (zdim, n, rank).  This replaces the
    reference factor cache ``params['cholesky'][length]`` (``gp.py:150-162``).
    """
    return jax.vmap(lambda w: ichol_gauss(n, w, rank, dt))(jnp.asarray(omega))


def nystrom_factor(n: int, omega, rank: int, dt: float = 1.0,
                   jitter: float = 2e-5):
    """The unguarded Nystrom factor of :func:`nystrom_gauss_batch`: a
    latent whose landmark Cholesky fails comes back non-finite."""
    import numpy as np

    omega = jnp.asarray(omega)
    dtype = jnp.result_type(omega.dtype, jnp.float32)
    rank = min(rank, n)
    J = (np.arange(rank) * n) // rank  # distinct, evenly spaced
    x = jnp.arange(n, dtype=dtype) * dt
    xJ = x[jnp.asarray(J)]
    om = omega.astype(dtype)[:, None, None]
    K_nJ = jnp.exp(-om * (x[:, None] - xJ[None, :]) ** 2)  # (Z, n, R)
    K_JJ = jnp.exp(-om * (xJ[:, None] - xJ[None, :]) ** 2)  # (Z, R, R)
    eye = jnp.eye(rank, dtype=dtype)
    L = jnp.linalg.cholesky(K_JJ + jitter * eye)
    # G = K_nJ L^{-T}  (right triangular solve, batched)
    G = lax.linalg.triangular_solve(
        L, K_nJ, left_side=False, lower=True, transpose_a=True
    )
    return G


@functools.partial(jax.jit, static_argnums=(0, 2))
def nystrom_gauss_batch(n: int, omega, rank: int, dt: float = 1.0,
                        jitter: float = 2e-5):
    """Low-rank SE-kernel factor via Nystrom with evenly-spaced landmarks:
    one batched (rank x rank) Cholesky instead of ``rank`` sequential
    pivot steps.

    For a *stationary* kernel on a *regular grid*, greedy diagonal
    pivoting (``ichol_gauss``) selects a data-independent, evenly-spread
    pivot set — so fixed evenly-spaced landmarks J give the same
    approximation family:  G = K[:, J] chol(K[J, J] + jitter I)^-T, with
    K ~= G G' (exact on the landmark rows/columns up to jitter).  The
    E-step consumes the factor only through K = G G' (push-through
    identity: G (I + G'WG)^-1 G' = K (I + WK)^-1), so the factor choice is
    semantically free.  Measured reconstruction error at the production
    regime (window 50, rank 40, f32, jitter 2e-5): ~1e-4 through the
    middle of the omega box, rising to ~1.7e-3 * sigma^2 at the box top
    omega = 5e-2 (ichol at the same rank: ~1e-6) — the trimmed rank is
    tight exactly where the kernel is sharpest.  End-to-end this is below
    the fit's noise floor: forcing ichol on the same f32 workload moves
    lstsq-aligned recovery R^2 by < 0.001.  The jitter keeps the f32
    Cholesky of the (near-singular) landmark kernel finite across the
    omega box: CPU LAPACK survives 1e-8, and a blocked accelerator f32
    Cholesky was seen to NaN below ~1e-5, so 2e-5 leaves a margin; the
    card's cuSOLVER factor is checked finite across ``omega_bound`` by
    ``chip_smoke.py``.  ``ichol_gauss`` (a sequential rank-step loop)
    remains the exact/oracle path and the full-length (rank << n) path,
    where sparse landmarks underfit.

    omega: (zdim,) -> (zdim, n, rank).
    """
    G = nystrom_factor(n, omega, rank, dt, jitter)
    # Finite-guard: the jitter floor sits only ~2x above the f32
    # Cholesky NaN floor seen on an accelerator, and a NaN factor would poison
    # every downstream solve.  Degrade to the exact
    # pivoted-ichol factor per latent instead of NaN-ing the whole fit;
    # the cond keeps the sequential ichol off the hot path when (always,
    # in practice) the Nystrom factor is finite.
    finite = jnp.all(jnp.isfinite(G), axis=(1, 2))  # (Z,)
    return lax.cond(
        jnp.all(finite),
        lambda g: g,
        lambda g: jnp.where(
            finite[:, None, None], g, ichol_gauss_batch(n, omega, rank, dt)
        ),
        G,
    )


def ichol(A, rank: int | None = None, tol: float = 1e-10):
    """Pivoted incomplete Cholesky of a general PSD matrix.

    Mirrors ``vlgp/math.py:129-169``; jittable with fixed rank (defaults to
    full n).  Returns (n, rank).
    """
    A = jnp.asarray(A)
    n = A.shape[0]
    rank = n if rank is None else rank
    rows = jnp.arange(n)
    cols = jnp.arange(rank)

    def body(i, carry):
        G, d, pvec = carry
        dm = jnp.where(rows >= i, d, -jnp.inf)
        jast = jnp.argmax(dm)
        pvec_i, pvec_j = pvec[i], pvec[jast]
        pvec = pvec.at[i].set(pvec_j).at[jast].set(pvec_i)
        d_i, d_j = d[i], d[jast]
        d = d.at[i].set(d_j).at[jast].set(d_i)
        g_i, g_j = G[i], G[jast]
        G = G.at[i].set(g_j).at[jast].set(g_i)

        alive = d[i] > tol
        gii = jnp.sqrt(jnp.maximum(d[i], tol))
        G = G.at[i, i].set(jnp.where(alive, gii, 0.0))
        nextcol = A[pvec, pvec[i]]
        prev = jnp.where(cols < i, G[i], 0.0)
        proj = G @ prev
        newcol = jnp.where(alive, (nextcol - proj) / gii, 0.0)
        below = rows > i
        G = jnp.where(below[:, None] & (cols[None, :] == i), newcol[:, None], G)
        upto = cols <= i
        diagA = A[pvec, pvec]
        dnew = diagA - jnp.sum(jnp.where(upto[None, :], G, 0.0) ** 2, axis=1)
        d = jnp.where(below, dnew, d)
        return G, d, pvec

    G0 = jnp.zeros((n, rank), A.dtype)
    d0 = jnp.diagonal(A).astype(A.dtype)
    G, d, pvec = lax.fori_loop(0, min(rank, n), body, (G0, d0, rows))
    return jnp.zeros_like(G).at[pvec].set(G)
