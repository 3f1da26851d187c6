"""vLGP inference engine: batched variational EM.

Reference: ``vlgp/core.py``.  The reference runs Python triple loops —
trials (core.py:123-126) x latent dims (core.py:76) x Newton iterations
(core.py:68) for the E-step and neurons (core.py:179) for the M-step.  All
of those loops are *independent given the sufficient statistics* (the inner
latent loop reads only the residual computed before the sweep, so it is a
Jacobi update despite its in-place appearance), which makes the whole EM
iteration one batched XLA computation here:

  * E-step: einsum-batched low-rank Woodbury updates over
    (segments x latents), ``lax.fori_loop`` over the Eniter Newton sweeps;
  * M-step: per-neuron Newton reduced to masked sufficient-statistic
    einsums (the cross-trial concatenation at core.py:166-171 becomes a
    masked sum, and under SPMD a ``psum``);
  * numerical fallbacks (try/except around solves, core.py:88-94) are
    unnecessary: the Woodbury system ``I + G'WG`` has eigenvalues >= 1 and
    the Newton systems carry explicit jitter.

Layout note: the container stores posterior tensors as (N, T, zdim)
(user-facing), but all hot-loop math runs **latent-major** (zdim, N, T):
with zdim ~ 5 a trailing latent axis would be the minor dimension of
every tensor; latent-major keeps the time axis minor and turns every
Woodbury contraction into well-shaped batched matmuls.

Every public function takes an optional :class:`Dist` naming the mesh axes;
with the default (no axes) the same code runs single-device.  Axis
semantics: ``data`` shards segments/trials, ``model`` shards channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
from jax import lax

from ..config import Config, Params
from ..data import TrialSet
from ..ops.math import trunc_exp
from ..ops.spd import inv_one_plus_gram

__all__ = [
    "Dist",
    "estep",
    "mstep",
    "update_w",
    "update_v",
    "constrain_loading",
    "constrain_latent",
    "em_norms",
]


class Dist(NamedTuple):
    """Mesh axis names (None = not sharded on that axis)."""

    data: Optional[str] = None
    model: Optional[str] = None


def _psum(x, axis: Optional[str]):
    return x if axis is None else lax.psum(x, axis)


def _zmajor(x):
    """(N, T, Z) -> (Z, N, T)."""
    return jnp.transpose(x, (2, 0, 1))


def _zminor(x):
    """(Z, N, T) -> (N, T, Z)."""
    return jnp.transpose(x, (1, 2, 0))


def _xb(x, b):
    """Regressor contribution: einsum('ijk,jk->ik') batched (core.py:66)."""
    return jnp.einsum("stxy,xy->sty", x, b)


def _eta(muz, a, xb):
    """Linear predictor (S, T, Y) from latent-major mu (core.py:69)."""
    return jnp.einsum("zst,zy->sty", muz, a) + xb


def _rates(eta, vz, a):
    """Posterior mean of the Poisson rate exp(eta + 0.5 * Var[eta])
    (core.py:70: lognormal mean with truncated exponent)."""
    return trunc_exp(eta + jnp.einsum("zst,zy->sty", vz, 0.5 * a * a))


def _safe_noise(noise):
    """Division-safe Gaussian noise: padded/degenerate channels can carry
    noise == 0 (their loading column is zero, so 1/noise would turn an
    exact no-op contribution into NaN via inf * 0)."""
    return jnp.maximum(noise, jnp.asarray(1e-30, noise.dtype))


def _residual(y, eta, r, params: Params):
    """GLM working residual (core.py:82-83)."""
    return jnp.where(params.poisson, y - r, (y - eta) / _safe_noise(params.noise))


def _weights(U, a, dist: Dist):
    """w = U @ (a.T)^2 latent-major (core.py:104)."""
    return _psum(jnp.einsum("sty,zy->zst", U, a * a), dist.model)


def _woodbury_inverse(G, wmz):
    """X = (I + G'WG)^{-1} for every (latent, segment) pair.

    The shared core of the E-step: the Newton direction (core.py:89) and
    the VB marginal variance (core.py:110) both need this inverse, at the
    *same* weights — computed once per sweep and carried (see estep).
    G: (Z, T, R); wmz: (Z, S, T) -> (Z, S, R, R).
    """
    return inv_one_plus_gram(G, wmz)


def _woodbury_delta(G, s, muz, wmz, X):
    """Natural-gradient E-step update via the low-rank Woodbury identity.

    Implements core.py:85-97 for all (latent, segment) pairs at once, in the
    simplified form delta = u - G (I + G'WG)^{-1} G'(w u)  (algebraically
    identical to the reference's three-term assembly; see
    tests/test_estep_oracle.py for the dense-oracle check).

    G: (Z, T, R) prior factors; s, muz, wmz: (Z, S, T);
    X: (Z, S, R, R) the inverse from :func:`_woodbury_inverse` at wmz.
    """
    Gts = jnp.einsum("ztr,zst->zsr", G, s)
    u = jnp.einsum("ztr,zsr->zst", G, Gts) - muz
    Gwu = jnp.einsum("ztr,zst->zsr", G, wmz * u)
    M = jnp.einsum("zsrq,zsq->zsr", X, Gwu)
    delta = u - jnp.einsum("ztr,zsr->zst", G, M)
    return delta


def _marginal_variance_from_inv(G, X):
    """VB marginal posterior variance (core.py:105-114, 445-471).

    The reference computes rowsum(G * (G - G A + G A (I+A)^{-1} A)) with
    A = G'WG; the bracket telescopes to (I + A)^{-1}, so
    v = diag(G (I + G'WG)^{-1} G') with the inverse X precomputed.
    """
    return jnp.einsum("ztr,zsrq,ztq->zst", G, X, G)


def _marginal_variance(G, wmz, eps):
    """Standalone v update (used by update_v, core.py:445-471)."""
    return _marginal_variance_from_inv(G, _woodbury_inverse(G, wmz))


def estep(
    data: TrialSet, params: Params, G: jnp.ndarray, config: Config,
    niter: Optional[int] = None, dist: Dist = Dist(),
):
    """E-step: Eniter Newton sweeps over all segments and latents.

    Reference: ``infer_single_trial`` (core.py:22-126).  The per-latent
    coordinate loop is batched (the reference's sweep reads only the
    pre-sweep residual, so batching is exact, not an approximation).
    """
    niter = config.Eniter if niter is None else niter
    if niter < 1:
        return data

    y, x, mask = data.y, data.x, data.mask
    xb = _xb(x, params.b)
    a = params.a
    vb = config.method == "VB"
    maskz = mask[None]  # broadcast over the leading latent axis

    def sweep(_, carry):
        muz, wz, vz, dmuz, X = carry
        # X is (I + G'WG)^{-1} at the carried weights wz — computed at the
        # end of the previous sweep (or from the initial weights), which is
        # exactly the system the Newton step needs here (the reference
        # rebuilds it from the same stale w at core.py:85-89).
        eta = _eta(muz, a, xb)
        r = _rates(eta, vz, a)
        residual = _residual(y, eta, r, params) * mask[..., None]
        s = _psum(jnp.einsum("sty,zy->zst", residual, a), dist.model)
        delta = _woodbury_delta(G, s, muz, wz * maskz, X)
        delta = jnp.clip(delta, -config.dmu_bound, config.dmu_bound) * maskz
        muz = muz + delta
        dmuz = delta
        # refresh weights under the updated posterior (core.py:100-104)
        eta = _eta(muz, a, xb)
        r = _rates(eta, vz, a)
        U = jnp.where(params.poisson, r, 1.0 / _safe_noise(params.noise))
        wz = _weights(U, a, dist) * maskz
        # the inverse at the new weights serves this sweep's v and the
        # next sweep's Newton step (ops/spd.py)
        if vb:
            X, vz = inv_one_plus_gram(G, wz, want_v=True)
            vz = vz * maskz
        else:
            X = inv_one_plus_gram(G, wz)
        return muz, wz, vz, dmuz, X

    def core():
        """Sweep loop, the (Z, S, R, R) inverse carried between sweeps."""
        muz = _zmajor(data.mu)
        wz = _zmajor(data.w) * maskz
        init = (muz, wz, _zmajor(data.v), _zmajor(data.dmu),
                inv_one_plus_gram(G, wz))
        tol = config.estep_tol
        if tol <= 0:
            # reference-matched fixed sweep count (core.py:65 runs Eniter
            # sweeps unconditionally — its `tol` is read but never used)
            return lax.fori_loop(0, niter, sweep, init)
        # adaptive exit: stop sweeping once the Newton update stalls at
        # its fixed-point noise floor (config.estep_tol).  The decision
        # uses DATA-psummed norms so every device in a shard_map takes
        # the same trip count (the sweep body itself contains a
        # model-axis psum, which would deadlock under divergent trips).
        def cond(carry):
            i, (muz_c, _, _, dmuz_c, _) = carry
            nd = _psum(jnp.sum(dmuz_c * dmuz_c), dist.data)
            nm = _psum(jnp.sum(muz_c * muz_c), dist.data)
            return (i < niter) & ((i < 2) | (nd > tol * tol * nm))

        def body(carry):
            i, inner = carry
            return i + 1, sweep(i, inner)

        _, out = lax.while_loop(cond, body, (0, init))
        return out

    muz, wz, vz, dmuz, _ = core()
    return data.replace(
        mu=_zminor(muz), w=_zminor(wz), v=_zminor(vz), dmu=_zminor(dmuz)
    )


def update_w(data: TrialSet, params: Params, config: Config, dist: Dist = Dist()) -> TrialSet:
    """Recompute likelihood precision weights (core.py:419-442)."""
    muz, vz = _zmajor(data.mu), _zmajor(data.v)
    eta = _eta(muz, params.a, _xb(data.x, params.b))
    r = _rates(eta, vz, params.a)
    U = jnp.where(params.poisson, r, 1.0 / _safe_noise(params.noise))
    wz = _weights(U, params.a, dist) * data.mask[None]
    return data.replace(w=_zminor(wz))


def update_v(data: TrialSet, params: Params, G, config: Config, dist: Dist = Dist()) -> TrialSet:
    """Recompute VB marginal posterior variance (core.py:445-471)."""
    if config.method != "VB":
        return data
    wz = _zmajor(data.w) * data.mask[None]
    vz = _marginal_variance(G, wz, config.eps) * data.mask[None]
    return data.replace(v=_zminor(vz))


def _masked_var(resid, mask, dist: Dist):
    """Per-channel variance of masked residuals (M-step noise MLE,
    core.py:177)."""
    m = mask[..., None]
    n = _psum(jnp.sum(mask), dist.data)
    s1 = _psum(jnp.sum(resid * m, axis=(0, 1)), dist.data)
    s2 = _psum(jnp.sum(resid * resid * m, axis=(0, 1)), dist.data)
    mean = s1 / n
    return s2 / n - mean * mean


def mstep(
    data: TrialSet, params: Params, config: Config,
    niter: Optional[int] = None, dist: Dist = Dist()
) -> Params:
    """M-step: Newton (or plain gradient) for Poisson channels, closed form
    for Gaussian.

    ``config.use_hessian=False`` selects the reference's gradient mode
    (core.py:196-197, 215-216): ``delta = learning_rate * grad`` with the
    same update clipping; the Hessian sufficient statistics are then never
    built (config is static under jit, so the branch costs nothing).

    Reference: core.py:129-249.  The per-neuron loop becomes batched
    sufficient-statistic einsums; cross-trial sums become masked reductions
    (and psum over the data axis under SPMD).  All channels get both the
    Poisson and Gaussian updates computed; a per-channel select applies the
    right one, keeping the computation branchless.
    """
    niter = config.Mniter if niter is None else niter
    if niter < 1:
        return params

    y, x, mask = data.y, data.x, data.mask
    muz, vz = _zmajor(data.mu), _zmajor(data.v)
    m = mask[..., None]
    maskz = mask[None]
    mum = muz * maskz
    vm = vz * maskz
    eps = config.eps
    zdim = params.zdim
    xdim = params.xdim
    Iz = jnp.eye(zdim, dtype=y.dtype)
    Ix = jnp.eye(xdim, dtype=y.dtype)
    pois = params.poisson
    xm = x * m[..., None]
    # static gating (Params.likelihood_kind): with a pure likelihood mix the
    # other family's updates are dead work — the per-channel select would
    # discard them — so skip building them at trace time entirely
    kind = params.likelihood_kind
    need_pois = kind != "gaussian"
    need_gauss = kind != "poisson"

    if need_gauss:
        # data-independent Gaussian normal equations (core.py:224-226)
        Mg = _psum(jnp.einsum("zst,kst->zk", mum, muz), dist.data)
        Mg = Mg + jnp.diag(_psum(jnp.sum(vm, axis=(1, 2)), dist.data))
        xtx = _psum(jnp.einsum("stxn,stqn->nxq", xm, x), dist.data)
    def iteration(_, carry):
        a, b, noise, da, db = carry
        xb = _xb(x, b)
        eta = _eta(muz, a, xb)
        noise = _masked_var(y - eta, mask, dist)
        ym = y * m

        if need_pois:
            r = _rates(eta, vz, a)
            rm = r * m

            # ---- Poisson loading update (core.py:182-200) ----
            C1 = _psum(jnp.einsum("zst,sty->zy", mum, y - r), dist.data)
            C2 = _psum(jnp.einsum("zst,sty->zy", vm, r), dist.data)
            grad_a = C1 - a * C2  # (z, y)
            grad_b = _psum(jnp.einsum("stxy,sty->xy", x, (ym - rm)), dist.data)
            if config.use_hessian:
                # Hessian of -loglik w.r.t. a[:, n], built from shared stats:
                # (mu + v a_n)' diag(r_n) (mu + v a_n) + diag(r_n' v).
                # (A stacked-factor variant — one einsum over [mu; v] — was
                # measured perf-neutral on the flagship and reverted to keep
                # the update bit-identical across likelihood_kind gatings.)
                E1 = _psum(jnp.einsum("sty,zst,kst->yzk", rm, muz, muz), dist.data)
                E2 = _psum(jnp.einsum("sty,zst,kst->yzk", rm, vz, muz), dist.data)
                E3 = _psum(jnp.einsum("sty,zst,kst->yzk", rm, vz, vz), dist.data)
                an = a.T  # (y, z)
                nhess = (
                    E1
                    + an[:, :, None] * E2
                    + an[:, None, :] * jnp.swapaxes(E2, 1, 2)
                    + an[:, :, None] * an[:, None, :] * E3
                    + C2.T[:, :, None] * Iz
                )
                delta_a = jnp.linalg.solve(
                    nhess + eps * Iz, grad_a.T[..., None]
                )[..., 0].T
                # ---- Poisson regression update (core.py:205-218) ----
                nhess_b = _psum(
                    jnp.einsum("stxy,sty,stqy->yxq", x, rm, x), dist.data
                )
                delta_b = jnp.linalg.solve(
                    nhess_b + eps * Ix, grad_b.T[..., None]
                )[..., 0].T
            else:
                # gradient mode (core.py:196-197, 215-216): a plain ascent
                # step delta = learning_rate * grad, same clipping as Newton
                delta_a = config.learning_rate * grad_a
                delta_b = config.learning_rate * grad_b
            delta_a = jnp.clip(delta_a, -config.da_bound, config.da_bound)
            delta_b = jnp.clip(delta_b, -config.db_bound, config.db_bound)

            a_pois = a + delta_a
            b_pois = b + delta_b

        if need_gauss:
            # ---- Gaussian closed form (core.py:221-235) ----
            rhs_a = _psum(
                jnp.einsum("zst,sty->zy", mum, y - _xb(x, b)), dist.data
            )
            a_gauss = jnp.linalg.solve(Mg, rhs_a)
            resid = ym - _eta(mum, a_gauss, jnp.zeros_like(y))
            rhs_b = _psum(jnp.einsum("stxy,sty->yx", x, resid), dist.data)
            b_gauss = jnp.linalg.solve(
                xtx + eps * Ix, rhs_b[..., None]
            )[..., 0].T
            # zero the history-filter rows, keep the bias (core.py:235)
            b_gauss = b_gauss * (jnp.arange(xdim) == 0)[:, None].astype(b.dtype)

        if not need_gauss:
            a_new, b_new = a_pois, b_pois
            da, db = delta_a, delta_b
        elif not need_pois:
            a_new, b_new = a_gauss, b_gauss
            da, db = a_new - a, b_new - b
        else:
            a_new = jnp.where(pois, a_pois, a_gauss)
            b_new = jnp.where(pois, b_pois, b_gauss)
            da = jnp.where(pois, delta_a, a_new - a)
            db = jnp.where(pois, delta_b, b_new - b)
        if params.active is not None:
            # inert channels (mesh padding): pinned to their carried state
            # — with a zero initial loading/bias they stay exactly zero,
            # contributing nothing to any posterior contraction, WITHOUT
            # demoting the model's static likelihood_kind (VERDICT-r3 #3)
            act = params.active
            a_new = jnp.where(act, a_new, a)
            b_new = jnp.where(act, b_new, b)
            noise = jnp.where(act, noise, carry[2])
            da = jnp.where(act, da, 0.0)
            db = jnp.where(act, db, 0.0)
        return a_new, b_new, noise, da, db

    init_m = (params.a, params.b, params.noise, params.da, params.db)
    mtol = config.mstep_tol
    if mtol <= 0:
        a, b, noise, da, db = lax.fori_loop(0, niter, iteration, init_m)
    else:
        # adaptive exit at the Newton noise floor — the check the
        # reference's authors wrote and commented out (core.py:248-249:
        # ``norm(da) < tol * norm(a) and norm(db) < tol * norm(b)``).
        # (config.mstep_tol).  The squared norms are MODEL-psummed: a/b/da/db are replicated
        # across the data axis (their statistics are data-psummed) but
        # sharded over channels on the model axis, so a local norm would
        # give each model shard its own trip count and make the fit
        # depend on the mesh layout (review-r3 finding).
        def _gn2(x):
            return _psum(jnp.sum(x * x), dist.model)

        def mcond(carry):
            i, (a_c, b_c, _, da_c, db_c) = carry
            moving = (_gn2(da_c) > mtol * mtol * _gn2(a_c)) | (
                _gn2(db_c) > mtol * mtol * _gn2(b_c)
            )
            return (i < niter) & ((i < 2) | moving)

        def mbody(carry):
            i, inner = carry
            return i + 1, iteration(i, inner)

        _, (a, b, noise, da, db) = lax.while_loop(mcond, mbody, (0, init_m))
    return params.replace(a=a, b=b, noise=noise, da=da, db=db)


def constrain_loading(
    data: TrialSet, params: Params, config: Config, dist: Dist = Dist()
) -> Tuple[TrialSet, Params]:
    """Normalize the loading, compensating the latents (core.py:392-416)."""
    c = config.constrain_loading
    if not c or c == "none":
        return data, params
    a = params.a
    if c == "svd":
        if dist.model is not None:
            raise NotImplementedError("svd loading constraint under model sharding")
        u, s, vh = jnp.linalg.svd(a, full_matrices=False)
        us = a @ vh.T
        mu = jnp.einsum("stz,zk->stk", data.mu, us)
        return data.replace(mu=mu), params.replace(a=vh)
    if c == "fro":
        ssq = _psum(jnp.sum(a * a), dist.model)
        s = jnp.sqrt(ssq) + config.eps
        return data.replace(mu=data.mu * s), params.replace(a=a / s)
    # row-wise vector norm with ord=c (core.py:413)
    ord_ = float(c) if not isinstance(c, (int, float)) else c
    if ord_ == 2:
        s = jnp.sqrt(_psum(jnp.sum(a * a, axis=1), dist.model)) + config.eps
    elif ord_ == 1:
        s = _psum(jnp.sum(jnp.abs(a), axis=1), dist.model) + config.eps
    else:
        raise ValueError(f"unsupported loading constraint {c!r}")
    return data.replace(mu=data.mu * s[None, None, :]), params.replace(
        a=a / s[:, None]
    )


def constrain_latent(
    data: TrialSet, params: Params, config: Config, dist: Dist = Dist()
) -> Tuple[TrialSet, Params]:
    """Center/scale the posterior mean, compensating (b, a)
    (core.py:366-389).  Off by default, as in the reference."""
    c = config.constrain_latent
    if not c or c == "none":
        return data, params
    m = data.mask[..., None]
    n = _psum(jnp.sum(data.mask), dist.data)
    mean = _psum(jnp.sum(data.mu * m, axis=(0, 1)), dist.data) / n
    sqsum = _psum(jnp.sum((data.mu - mean) ** 2 * m, axis=(0, 1)), dist.data)
    std = jnp.sqrt(sqsum / n)
    mu, a, b = data.mu, params.a, params.b
    if c in ("location", "both"):
        mu = (mu - mean) * m
        b = b.at[0, :].add(mean @ a)
    if c in ("scale", "both"):
        mu = mu / std
        a = a * std[:, None]
    return data.replace(mu=mu), params.replace(a=a, b=b)


def em_norms(data: TrialSet, params: Params, dist: Dist = Dist()):
    """Squared norms used by the convergence test (core.py:300-305, 350-359)."""
    m = data.mask[..., None]
    sq = lambda t: jnp.sum(t * t)
    out = dict(
        mu=_psum(sq(data.mu * m), dist.data),
        dmu=_psum(sq(data.dmu * m), dist.data),
        a=_psum(sq(params.a), dist.model),
        da=_psum(sq(params.da), dist.model),
        b=_psum(sq(params.b), dist.model),
        db=_psum(sq(params.db), dist.model),
    )
    return out
