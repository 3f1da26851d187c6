"""Batched small-SPD inverses: the E-step's and H-step's hot op.

The vLGP E-step and H-step need tens of thousands of independent
(rank x rank) SPD inverses per EM iteration (the Woodbury systems
``I + G'WG``, core.py:89/110, and the posterior covariances
``(K^-1 + diag(w))^-1``, gp.py:142-145).  Every platform computes them
exactly: batched Cholesky and a triangular solve (cuSOLVER/cuBLAS on
CUDA, LAPACK on the CPU).  A matmul-only Newton-Schulz route, warm-started
from an inverse carried between sweeps, lost to it end to end on an H100
(PERF.md), and was removed.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["spd_inverse", "spd_solve", "inv_one_plus_psd",
           "inv_one_plus_gram"]

# a GPU f32 dot at DEFAULT precision may run in TF32 (about 3 decimal
# digits): every product on the inverse path keeps full f32
_HIGHEST = lax.Precision.HIGHEST


def spd_inverse(A):
    """Batched inverse of SPD matrices A (..., R, R): Cholesky + a
    triangular solve."""
    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    Linv = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return jnp.einsum("...kr,...kq->...rq", Linv, Linv, precision=_HIGHEST)


def spd_solve(A, b):
    """Solve A x = b for SPD A (..., R, R) and b (..., R)."""
    X = spd_inverse(A)
    return jnp.einsum("...rq,...q->...r", X, b, precision=_HIGHEST)


def inv_one_plus_psd(A):
    """(I + A)^{-1} for PSD A (..., R, R); I + A has eigenvalues >= 1."""
    return spd_inverse(A + jnp.eye(A.shape[-1], dtype=A.dtype))


def inv_one_plus_gram(G, w, want_v: bool = False):
    """X = (I + G' diag(w) G)^{-1} for every (latent, segment) pair.

    G: (Z, T, R) low-rank prior factors; w: (Z, S, T) nonnegative weights.
    Returns X (Z, S, R, R), or (X, v) with ``want_v`` where
    v = diag(G X G') is the VB marginal posterior variance (core.py:110,
    445-471).  Used by both the E-step sweeps (models/vlgp.py) and the
    H-step's factor-space posterior refresh (models/gp.py:hstep).  The
    Gram and v products run at HIGHEST precision: a TF32 Gram would
    perturb the system by ~1e-3 relative before any inverse is taken.
    """
    A = jnp.einsum("ztr,zst,ztq->zsrq", G, w, G, precision=_HIGHEST)
    X = inv_one_plus_psd(A)
    if want_v:
        return X, jnp.einsum("ztr,zsrq,ztq->zst", G, X, G,
                             precision=_HIGHEST)
    return X
