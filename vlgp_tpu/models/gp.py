"""GP prior layer: kernels, prior factors, ELBO, hyperparameter step.

Reference: ``vlgp/gp.py``.  The reference optimizes the per-latent GP
hyperparameters with scipy L-BFGS-B in log space, with hand-derived kernel
gradients (gp.py:12-62), a bounds box, a gradient mask [0, 1, 0] that makes
omega the only effectively-learned parameter (gp.py:84-92), and rejection of
at-bound updates.  Here the same ELBO objective (built from dense per-segment
posterior covariances, gp.py:126-147) is evaluated in batched jnp and
optimized by a fixed-trip-count golden-section search on log(omega) per
latent — branchless, jittable, vmapped over latents, and exactly as bounded
as the reference box.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..config import Config, Params
from ..data import TrialSet
from ..ops.ichol import ichol_gauss_batch, nystrom_gauss_batch
from ..ops.spd import inv_one_plus_gram, inv_one_plus_psd
from .vlgp import Dist, _psum

__all__ = [
    "sekernel",
    "se_kernel_grid",
    "make_cholesky",
    "gp_elbo",
    "hstep",
    "posterior_cov",
]


def sekernel(x, var, scale, jitter: float = 1e-6):
    """Dense SE covariance, GPFA parameterization (gp.py:165-171).

    K[i,j] = var * exp(-0.5 * ((x_i - x_j)/scale)^2) + jitter * I
    """
    x = jnp.asarray(x, jnp.result_type(x, jnp.float32)) / scale
    dsq = (x[:, None] - x[None, :]) ** 2
    return var * jnp.exp(-0.5 * dsq) + jitter * jnp.eye(x.shape[0], dtype=dsq.dtype)


def se_kernel_grid(T: int, omega, sigmasq=1.0, gp_noise=1e-4, dt: float = 1.0,
                   dtype=jnp.float32):
    """SE kernel on a regular grid, vLGP parameterization (gp.py:46-62).

    K = sigmasq * exp(-omega * D^2) + gp_noise * I
    """
    t = jnp.arange(T, dtype=dtype) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    return sigmasq * jnp.exp(-omega * dsq) + gp_noise * jnp.eye(T, dtype=dtype)


def make_cholesky(T: int, params: Params, rank: Optional[int] = None) -> jnp.ndarray:
    """Low-rank prior factors for all latents: (zdim, T, rank).

    K_l ~= (sigma_l G_l)(sigma_l G_l)'.  Replaces the per-length factor
    cache ``params['cholesky']`` (gp.py:150-162): stationarity on a regular
    grid means a single padded-length factor serves every masked trial.
    ``rank`` overrides ``params.rank`` (e.g. the trimmed segment rank from
    :func:`effective_rank` — every Woodbury cost scales as rank^2).
    """
    rank = params.rank if rank is None else rank
    rank = min(rank, T)
    G = _se_factor(T, params.omega, rank, params.dt, params.a.dtype)
    G = G.astype(params.a.dtype) * params.sigma[:, None, None]
    return G


def _se_factor(T: int, omega, rank: int, dt, dtype):
    """Batched low-rank SE factor: Nystrom on the f32 hot path when the
    landmark set is dense enough (rank >= 0.6 T — the window-segment
    regime), exact sequential pivoted ichol otherwise (f64 oracles,
    full-length factors).  See ops/ichol.py:nystrom_gauss_batch."""
    if jnp.dtype(dtype) == jnp.float32 and rank >= 0.6 * T:
        return nystrom_gauss_batch(T, omega, rank, dt)
    return ichol_gauss_batch(T, omega, rank, dt)


def effective_rank(T: int, omega_hi: float, dt: float = 1.0,
                   margin: int = 4, tol: float = 1e-7) -> int:
    """Numerically-exact truncation rank for window-T segment factors.

    The pivoted incomplete Cholesky of the SE kernel zeroes columns beyond
    the kernel's effective rank; the sharpest kernel in the omega search box
    (omega_hi) has the largest effective rank, so factors can be trimmed to
    it for every candidate omega with machine-precision reconstruction
    (e.g. window 50, omega_hi 5e-2: rank 39, error ~1e-10).  Rounded up to
    a lane-friendly multiple of 8.
    """
    from ..ops.ichol import ichol_gauss

    probe = min(T, 128)
    G = ichol_gauss(T, jnp.asarray(omega_hi, jnp.float32), probe, dt)
    import numpy as _np

    colmax = _np.abs(_np.asarray(G)).max(axis=0)
    nz = int((colmax > tol).sum())
    if nz >= probe:  # probe saturated: no safe truncation, keep full rank
        return T
    r = min(T, -(-(nz + margin) // 8) * 8)
    return max(8, r)


def _chol_inv(L):
    """Inverse from a Cholesky factor (batched)."""
    n = L.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
    inv_l = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return jnp.einsum("...ki,...kj->...ij", inv_l, inv_l,
                      precision=lax.Precision.HIGHEST)


def posterior_cov_stack(w, T: int, omega, sigmasq, gp_noise, dt, mask=None):
    """Per-segment dense posterior covariances at the current kernel.

    S_i = (K^-1 + diag(w_i))^-1, batched over segments
    (``construct_posterior_cov``, gp.py:126-147), computed in the
    well-conditioned Woodbury form

        S = K - K W^{1/2} (I + W^{1/2} K W^{1/2})^{-1} W^{1/2} K

    whose inner system has eigenvalues >= 1 (the reference's direct form
    factorizes K^-1 + W with condition ~1/gp_noise, and needs the retry
    loop at gp.py:129-135).  w: (S, T) -> (S, T, T).
    """
    K = se_kernel_grid(T, omega, sigmasq, gp_noise, dt, dtype=w.dtype)
    if mask is not None:
        w = w * mask
    sw = jnp.sqrt(w)  # (S, T)
    B = sw[:, :, None] * K[None] * sw[:, None, :]
    X = inv_one_plus_psd(B)
    C = sw[:, :, None] * K[None]  # C[s,t,u] = sw[s,t] K[t,u]  (= W^1/2 K)
    # HIGHEST: a GPU f32 dot at DEFAULT runs in TF32 (measured 1.1e-2
    # relative error here on an H100, against 1.1e-5 at f32)
    return K[None] - jnp.einsum("sut,suv,svx->stx", C, X, C,
                                precision=lax.Precision.HIGHEST)


def gp_elbo(log_omega, mu, Sig, T: int, sigmasq, gp_noise, dt,
            dist: Dist = Dist()):
    """GP-prior ELBO for one latent at a candidate log(omega), with the
    variational posterior held fixed (gp.py:12-43):

        sum_i -1/2 mu_i' K^-1 mu_i - 1/2 tr(K^-1 S_i) - log|chol(K)|

    mu: (S, T) segment posterior means; Sig: (S, T, T) posterior
    covariances.

    Deliberate deviation from the reference *optimizer* (not its math): the
    reference objective wrapper rebuilds S_i at every candidate omega
    (gp.py:109) while its analytic gradient treats S_i as constant
    (gp.py:12-43 never differentiates through post_cov) — an inconsistency
    that makes L-BFGS stall semi-randomly, and whose consistent-objective
    limit is exactly this fixed-posterior form.  The rebuilt-S profile
    objective is also degenerate: it rewards omega -> 0 once the posterior
    mean is smooth, which over-smooths the latents.  Holding q fixed is
    what the vLGP paper's coordinate-ascent H-step prescribes and keeps the
    EM monotone.
    """
    K = se_kernel_grid(T, jnp.exp(log_omega), sigmasq, gp_noise, dt, dtype=mu.dtype)
    L = jnp.linalg.cholesky(K)
    Kinv = _chol_inv(L)
    logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
    hp = lax.Precision.HIGHEST
    quad = jnp.einsum("st,tu,su->s", mu, Kinv, mu, precision=hp)
    tr = jnp.einsum("tu,stu->s", Kinv, Sig, precision=hp)
    ll_local = jnp.sum(-0.5 * quad - 0.5 * tr) - logdet * mu.shape[0]
    return _psum(ll_local, dist.data)


def _golden_min(f, lo, hi, iters: int, polish: bool = False, grid: int = 0,
                tiebreak: float = 1e-4):
    """Fixed-iteration golden-section minimization on [lo, hi].

    f must be vectorizable over its scalar argument's batch dims.
    Returns the bracket midpoint after ``iters`` shrinks; with ``polish``
    a final three-point parabolic interpolation (through the two live
    golden probes and the bracket midpoint, one extra f eval) replaces
    the midpoint — near a smooth minimum this recovers golden-24
    precision from roughly half the shrinks, halving the sequential
    Cholesky chain that dominates the H-step.

    ``grid >= 3`` prepends a GLOBAL stage: f is evaluated at ``grid``
    evenly spaced candidates (one call — the candidates ride f's leading
    batch dim, so this is a single batched Cholesky, NOT ``grid``
    sequential ones) and the golden shrinks then run inside the
    two-cell bracket around the best candidate.  Golden section alone
    assumes unimodality; the H-step objective is not unimodal (it has a
    sharp-basin local attractor), so without the scan the basin choice
    is decided by whichever local minimum the first probes happen to
    straddle — i.e. by float noise in the inputs.

    ``tiebreak`` makes the scan's basin choice ROBUST as well as global:
    among candidates within ``tiebreak * |fmin|`` of the best objective,
    the first (smallest-x, for the H-step: smoothest-omega) one wins.
    Without it the argmin over near-tied basins is decided by float-scale
    noise in f's inputs — measured: a ~1e-5 E-step posterior
    perturbation flipped the basin on the reference tutorial
    workload and moved self-tuned R^2 by 0.012, and the psum reduction
    order did the same between shardings.  Near-tied basins are
    statistically indistinguishable to the objective, so the choice must
    be a deterministic convention, not noise; smoother is the
    conservative (Occam) side, and 1e-4 relative is far below any
    meaningful ELBO resolution while 10x above the observed noise.

    (A batched k-section variant — k candidates per EVERY shrink — costs
    k times the (T, T) triangular solves that dominate gp_elbo_stats;
    one batched scan up front is the cheap point on that curve.)
    """
    if grid >= 3:
        frac = jnp.arange(grid, dtype=jnp.result_type(lo)) / (grid - 1)
        cand = lo[None] + frac[:, None] * (hi - lo)[None]  # (grid, Z)
        fcand = f(cand)  # (grid, Z)
        # NaN candidates (e.g. an f32 Cholesky failure at an extreme
        # omega) must lose the comparison, not poison it: a raw min/argmax
        # over a column with one NaN would make `near` all-False and lock
        # the bracket to cell 0 regardless of where the true minimum is
        bad = jnp.isnan(fcand)
        fcand = jnp.where(bad, jnp.inf, fcand)
        fmin = jnp.min(fcand, axis=0)  # (Z,)
        near = fcand <= fmin + tiebreak * jnp.abs(fmin)
        # first near-tied candidate = smallest x (argmax returns the first
        # True)
        best = jnp.argmax(near, axis=0)  # (Z,)
        # don't bracket into a NaN neighbor cell (the golden comparisons
        # inside would misbehave on NaN endpoints): shrink that side to
        # the best candidate itself
        lo_idx = jnp.maximum(best - 1, 0)
        lo_idx = jnp.where(
            jnp.take_along_axis(bad, lo_idx[None], axis=0)[0], best, lo_idx
        )
        hi_idx = jnp.minimum(best + 1, grid - 1)
        hi_idx = jnp.where(
            jnp.take_along_axis(bad, hi_idx[None], axis=0)[0], best, hi_idx
        )
        # an all-NaN column has no information: collapse the bracket onto
        # the box edge so the H-step's at-bound rejection keeps the
        # previous value instead of accepting an arbitrary interior point
        allbad = jnp.all(bad, axis=0)
        lo_b = jnp.take_along_axis(cand, lo_idx[None], axis=0)[0]
        hi_b = jnp.take_along_axis(cand, hi_idx[None], axis=0)[0]
        lo = jnp.where(allbad, lo, lo_b)
        hi = jnp.where(allbad, lo, hi_b)
    phi = 0.6180339887498949
    c = hi - phi * (hi - lo)
    d = lo + phi * (hi - lo)
    fc = f(c)
    fd = f(d)

    def body(_, carry):
        lo, hi, c, d, fc, fd = carry
        left = fc < fd
        lo_n = jnp.where(left, lo, c)
        hi_n = jnp.where(left, d, hi)
        c_n = jnp.where(left, hi_n - phi * (hi_n - lo_n), d)
        d_n = jnp.where(left, c, lo_n + phi * (hi_n - lo_n))
        x_new = jnp.where(left, c_n, d_n)
        f_new = f(x_new)
        fc_n = jnp.where(left, f_new, fd)
        fd_n = jnp.where(left, fc, f_new)
        return lo_n, hi_n, c_n, d_n, fc_n, fd_n

    lo, hi, c, d, fc, fd = lax.fori_loop(0, iters, body, (lo, hi, c, d, fc, fd))
    mid = 0.5 * (lo + hi)
    if not polish:
        return mid
    fm = f(mid)
    # vertex of the parabola through (c, fc), (mid, fm), (d, fd)
    num = (mid - c) ** 2 * (fm - fd) - (mid - d) ** 2 * (fm - fc)
    den = (mid - c) * (fm - fd) - (mid - d) * (fm - fc)
    safe = jnp.abs(den) > 1e-30
    x_star = mid - 0.5 * jnp.where(safe, num / jnp.where(safe, den, 1.0), 0.0)
    # keep only interpolations that stay inside the final bracket (a
    # degenerate/non-convex fit falls back to the midpoint)
    ok = safe & (x_star > lo) & (x_star < hi)
    return jnp.where(ok, x_star, mid)


def gp_elbo_stats(log_omega, C, nseg, T: int, sigmasq, gp_noise, dt,
                  profile_sigma: bool = False):
    """GP-prior ELBO from the (T, T) sufficient statistic
    C = sum_i (mu_i mu_i' + S_i):

        ll = -1/2 tr(K^-1 C) - nseg * log|chol(K)|

    Exactly equal to :func:`gp_elbo` summed over segments (trace
    linearity), but O(T^3) per candidate instead of O(nseg * T^3) — this is
    what makes the bounded H-step search cheap on accelerators.
    ``log_omega`` may carry leading batch dims (candidates evaluated as one
    batched Cholesky).

    ``profile_sigma`` maximizes over the GP amplitude sigma^2 in CLOSED
    FORM per candidate (the reference masks sigma, gp.py:77): with
    K = s * K0, ll(s) = -q/(2s) - nseg (T/2 log s + logdet chol(K0)) where
    q = tr(K0^-1 C), so s* = q / (nseg T) and no extra factorization is
    needed.  The ridge is folded into K0 (equivalent to scaling gp_noise
    with the amplitude — an O(gp_noise) reparameterization).  s* is
    clipped to [1e-2, 1e2]: a dead latent (C -> 0) otherwise sends the
    profile likelihood to +inf as s -> 0.  Returns (ll*, s*).
    """
    log_omega = jnp.asarray(log_omega)
    om = jnp.exp(log_omega).reshape(log_omega.shape + (1, 1))
    t = jnp.arange(T, dtype=C.dtype) * dt
    dsq = (t[:, None] - t[None, :]) ** 2
    amp = 1.0 if profile_sigma else sigmasq
    K = amp * jnp.exp(-om * dsq) + gp_noise * jnp.eye(T, dtype=C.dtype)
    L = jnp.linalg.cholesky(K)
    Cb = jnp.broadcast_to(C, K.shape)
    half = lax.linalg.triangular_solve(L, Cb, left_side=True, lower=True)
    KinvC = lax.linalg.triangular_solve(
        L, half, left_side=True, lower=True, transpose_a=True
    )
    logdet = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    tr = jnp.trace(KinvC, axis1=-2, axis2=-1)
    if not profile_sigma:
        return -0.5 * tr - nseg * logdet
    s = jnp.clip(tr / (nseg * T), 1e-2, 1e2)
    return -0.5 * tr / s - nseg * (0.5 * T * jnp.log(s) + logdet), s


def _aitken_accept(x0, x1, x2, lo, hi, trust):
    """Aitken/Steffensen acceptance for the H-step fixed point (per latent).

    Extrapolates from the sequence (x0, x1, x2) of fixed-point iterates,
    accepts the extrapolation only on a genuine contraction (same
    direction, shrinking step), and — when ``trust > 0`` — caps the jump
    at ``trust * |x2 - x1|``.  The cap matters in the unpolished mode
    (config.hyper_refines <= 2) where the extrapolated point is accepted
    without a third objective search: a contraction ratio r near 1 makes
    the raw Aitken step |d2*r/(1-r)| arbitrarily large, and an overshoot
    lands at the omega bound and sticks (the clip to [lo, hi] here keeps
    it *inside* hstep's at-bound rejection margin by design).  Result is
    clipped to [lo, hi].
    """
    d1 = x1 - x0
    d2 = x2 - x1
    denom = d2 - d1
    safe = jnp.abs(denom) > 1e-12
    aitken = x2 - jnp.where(safe, d2 * d2 / jnp.where(safe, denom, 1.0), 0.0)
    if trust > 0:
        cap = trust * jnp.abs(d2)
        aitken = x2 + jnp.clip(aitken - x2, -cap, cap)
    # accept only a genuine contraction (same direction, shrinking)
    contracting = (d1 * d2 > 0) & (jnp.abs(d2) < jnp.abs(d1))
    return jnp.clip(jnp.where(contracting, aitken, x2), lo, hi)


def hstep(
    data: TrialSet, params: Params, config: Config, dist: Dist = Dist(),
    rank: Optional[int] = None,
) -> Params:
    """Hyperparameter step: per-latent bounded search on log(omega).

    Reference: gp.optimize (gp.py:65-97) — L-BFGS-B over log-space
    (sigma^2, omega, gp_noise) with gradient mask [0,1,0], so only omega
    moves; updates that land at the omega bounds are rejected
    (gp.py:91-92).  Replicated here as a golden-section search per latent
    with the same at-bound rejection, run on the pooled (T, T) second-moment
    statistic so each candidate evaluation costs one T x T Cholesky.

    The posterior-covariance refresh (``construct_posterior_cov``,
    gp.py:126-147) runs in *factor space*: with the low-rank prior
    K = G G' (the same prior the E-step itself uses), the pooled statistic
    telescopes —

        sum_s Sig_s = nseg * G G' - G (sum_s A_s X_s) G',
        A_s = G' W_s G,  X_s = (I + A_s)^{-1}

    — so the inner systems are the E-step's (rank x rank) Woodbury systems
    (ops/spd.py:inv_one_plus_gram), and no (S, T, T) tensor is ever
    materialized.  The commuting identities AX = I - X and
    QA = P - Q (see the inline comments) reduce the pooled statistic to
    reductions of X and P - Q — both cheaper and better conditioned than
    the direct matmul differences.  ``rank`` defaults to
    min(params.rank, T); the driver passes the trimmed segment rank.
    """
    if not config.Hstep:
        return params

    T = data.nbin
    Z = params.zdim
    dtype = data.mu.dtype
    rank = min(params.rank, T) if rank is None else min(rank, T)
    lo = jnp.full((Z,), jnp.log(jnp.asarray(config.omega_bound[0], dtype)))
    hi = jnp.full((Z,), jnp.log(jnp.asarray(config.omega_bound[1], dtype)))
    # count only segments with at least one valid bin — fully-masked rows
    # are sharding padding and must not bias the log-determinant term
    valid = jnp.max(data.mask, axis=1)  # (S,)
    nseg_total = _psum(jnp.sum(valid), dist.data)

    # Aitken clamp margin: extrapolation may land exactly on a bound, which
    # the at-bound rejection below would veto; keep it just inside.
    margin = 2e-3 * (hi - lo)

    mu_t = jnp.moveaxis(data.mu, -1, 0)  # (Z, S, T)
    w_t = jnp.moveaxis(data.w, -1, 0) * data.mask[None]
    # second moment of the posterior mean: local then psummed
    Mbar = _psum(jnp.einsum("zst,zsu->ztu", mu_t, mu_t), dist.data)
    sigsq = (params.sigma**2).reshape(Z, 1, 1)
    hp = lax.Precision.HIGHEST

    eps = params.gp_noise
    eyeT = jnp.eye(T, dtype=dtype)
    # w-tilde: the ridge-folded weights w/(1 + eps*w).  With the ridged
    # low-rank prior K = G G' + eps I (exactly the dense path's kernel up to
    # the machine-precision ichol trimming), (K^-1 + W)^-1 expands into
    # factor-space terms below — verified against the dense inverse to 1e-12.
    # The ridge is load-bearing: without it tr(Kcand^-1 SigSum) loses O(1)
    # contributions from the T-R null directions (Kcand^-1 has eigenvalues
    # ~1/eps there) and the objective degenerately rewards omega -> bound.
    wt2 = w_t / (1.0 + eps * w_t)

    def F(log_om):
        # one fixed-point refinement: posterior covariance at the running
        # omega (factor space, see docstring), then a bounded search over
        # the candidate kernel; (Z,) -> (Z,)
        G_om = _se_factor(T, jnp.exp(log_om), rank, params.dt, dtype)
        G_om = G_om.astype(dtype) * params.sigma[:, None, None]
        # A = G' diag(w~) G is needed ONLY inside the inverse (see the
        # commuting identities below)
        X = inv_one_plus_gram(G_om, wt2)
        P = wt2[..., None] * G_om[:, None]  # (Z,S,T,R): diag(w~) G
        Q = jnp.einsum("zstr,zsrq->zstq", P, X)
        sum_w = _psum(jnp.einsum("s,zst->zt", valid, wt2), dist.data)
        # X = (I+A)^{-1} commutes with A, so AX = I - X exactly; hence
        # A X A - A = X - I and Q A = P X A = P - Q.  Besides deleting
        # three (Z,S,R,R)-sized batched matmuls per call, the identity
        # forms are numerically STRICTLY better: the direct differences
        # subtract two O(||A||) quantities to produce an O(1) result
        # (f32 cancellation ~1e-7*lambda, and any inverse residual is
        # amplified by ||A|| ~ 1e4), while X - I and P - Q carry only the
        # raw inverse error.
        sum_X = _psum(jnp.einsum("s,zsrq->zrq", valid, X), dist.data)
        eyeR = jnp.eye(X.shape[-1], dtype=dtype)
        sum_AXA_mA = sum_X - nseg_total * eyeR
        sum_QP = _psum(jnp.einsum("s,zstr,zsur->ztu", valid, Q, P), dist.data)
        sum_QA = _psum(jnp.einsum("s,zstr->ztr", valid, P - Q), dist.data)
        KK = jnp.einsum("ztr,zur->ztu", G_om, G_om, precision=hp)
        GM = jnp.einsum("ztr,zrq->ztq", G_om, sum_AXA_mA, precision=hp)
        t_qa = jnp.einsum("ztr,zur->ztu", sum_QA, G_om, precision=hp)
        SigSum = (
            nseg_total * (KK + eps * eyeT)
            - eps * eps * sum_w[:, :, None] * eyeT
            - eps * (KK * sum_w[:, None, :] + sum_w[:, :, None] * KK)
            + eps * eps * sum_QP
            + eps * (t_qa + jnp.swapaxes(t_qa, -1, -2))
            + jnp.einsum("ztq,zuq->ztu", GM, G_om, precision=hp)
        )
        C = Mbar + SigSum

        def obj(log_omega):
            if config.hyper_learn_sigma:
                ll, _ = gp_elbo_stats(
                    log_omega, C, nseg_total, T, sigsq, params.gp_noise,
                    params.dt, profile_sigma=True,
                )
                return -ll
            return -gp_elbo_stats(
                log_omega, C, nseg_total, T, sigsq, params.gp_noise,
                params.dt,
            )

        # grid scans run in a window around the RUNNING omega (see
        # config.hyper_window): local enough not to teleport across
        # basins, wide enough that the fixed point walks freely
        if config.hyper_grid >= 3 and config.hyper_window > 0:
            lo_s = jnp.clip(log_om - config.hyper_window, lo, hi)
            hi_s = jnp.clip(log_om + config.hyper_window, lo, hi)
        else:
            lo_s, hi_s = lo, hi
        return _golden_min(obj, lo_s, hi_s, config.hyper_iters,
                           polish=config.hyper_polish,
                           grid=config.hyper_grid,
                           tiebreak=config.hyper_tiebreak), C

    # The fixed-point map log_om -> F(log_om) contracts slowly when the
    # posterior was smoothed at the current omega (ratio near 1, so
    # plain iteration crawls — the reference's L-BFGS shows the same
    # near-stationary crawl, core trajectory in gp.py:65-97).  Aitken /
    # Steffensen extrapolation jumps to the self-consistent omega:
    x0 = jnp.log(params.omega).astype(dtype)
    x1, _ = F(x0)
    x2, C2 = F(x1)
    trust = config.hyper_trust if config.hyper_refines < 3 else 0.0
    x_star = _aitken_accept(x0, x1, x2, lo + margin, hi - margin, trust)
    if config.hyper_refines >= 3:
        # polish with one more refinement at the extrapolated point.  The
        # raw Aitken point is off the F-map manifold; without the
        # hyper_trust cap, skipping this search once let a latent
        # collapse to the omega floor (independent draw 0.9209 vs the
        # reference's 0.9247).  With the cap (the default
        # hyper_refines=2) the two-search form matches this one within
        # the basin band (config.py).
        log_omega, Cf = F(x_star)
    else:
        log_omega, Cf = x_star, C2

    # reject updates that sit at the search bounds (gp.py:91-92)
    span = hi - lo
    at_bound = (jnp.abs(log_omega - lo) < 1e-3 * span) | (
        jnp.abs(log_omega - hi) < 1e-3 * span
    )
    omega = jnp.where(at_bound, params.omega, jnp.exp(log_omega))
    out = params.replace(omega=omega.astype(params.omega.dtype))
    if config.hyper_learn_sigma:
        # coordinate-ascent sigma update at the ACCEPTED omega: the
        # closed-form profile optimum of the same fixed-posterior
        # objective (the reference never learns sigma — its gradient
        # mask pins it, gp.py:77-91).  The posterior statistic Cf was
        # built at the pre-update sigma; the next EM iteration's E-step
        # re-smooths under the new amplitude (standard coordinate EM).
        _, s = gp_elbo_stats(
            jnp.log(out.omega).astype(dtype), Cf, nseg_total, T, sigsq,
            params.gp_noise, params.dt, profile_sigma=True,
        )
        out = out.replace(sigma=jnp.sqrt(s).astype(params.sigma.dtype))
    return out


def posterior_cov(w_l, G_l, reg: float = 0.0):
    """Dense posterior covariance for one latent of one trial.

    (K^-1 + diag(w))^-1 computed by Woodbury from the low-rank factor
    (util.py:541-547): S = K - K W (I + K W)^-1 K with K = G G' (+ reg I).
    """
    T = G_l.shape[0]
    K = G_l @ G_l.T + reg * jnp.eye(T, dtype=G_l.dtype)
    KW = K * w_l[None, :]
    S = K - KW @ jnp.linalg.solve(jnp.eye(T, dtype=K.dtype) + KW, K)
    return S
