"""Typed, immutable configuration and model-parameter pytrees.

The reference threads three mutable dicts ``(trials, params, config)`` through
every function and *silently discards* unknown config kwargs
(``vlgp/preprocess.py:84-112``).  Here config is a frozen dataclass used as a
static jit argument (unknown keys raise), and model parameters are an
immutable dataclass pytree (``vlgp/preprocess.py:49-81`` for the defaults).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from .pytree import PyTreeNode, static_field

__all__ = ["Config", "Params", "default_config"]


@dataclasses.dataclass(frozen=True)
class Config:
    """Fit options (reference defaults: ``vlgp/preprocess.py:84-112``).

    Static under jit — every field must be hashable.
    """

    # identifiability constraints (core.py:366-416)
    constrain_loading: str = "fro"  # "fro" | "svd" | <ord> | "none"
    constrain_latent: str = "none"  # "none" | "location" | "scale" | "both"
    # optimization
    use_hessian: bool = True
    eps: float = 1e-8
    tol: float = 1e-8
    min_iter: int = 5
    method: str = "VB"  # "VB" | "MAP"
    learning_rate: float = 1.0
    max_iter: int = 20
    Eniter: int = 25
    Mniter: int = 25
    Hstep: bool = True
    # adaptive E-step exit: stop the Newton sweeps early once the update
    # stalls, i.e. |dmu| <= estep_tol * |mu| (global norms; at least 2
    # sweeps always run).  Eniter stays the hard cap.  The reference runs
    # its Eniter=25 sweeps unconditionally (core.py:65; its `tol` is dead
    # there), but the sweep fixed point reaches its noise floor far
    # earlier: on the flagship workload the relative |dmu| plateaus at
    # ~6e-4 by sweep 6.  At 3e-3 the fit needs the same ~30 iterations to
    # recovery R^2 0.95 as at 1e-3, and the self-tuned quality draws all
    # stay at or above the reference (head2head 0.9254 vs 0.9212; indep
    # seeds 1-3: 0.9326/0.9258/0.9140 vs 0.9247/0.9240/0.9113).  0
    # disables (reference-matched fixed count; exact-parity tests use
    # this).
    estep_tol: float = 3e-3
    # same for the M-step Newton loop: exit once |da| <= mstep_tol * |a|
    # AND |db| <= mstep_tol * |b| — the exact check the reference's
    # authors wrote and commented out (core.py:248-249).  The relative
    # update hits its ~2e-3 noise floor within a few Newton iterations.
    # Mniter stays the hard cap; 0 disables.  1e-2 was rejected on
    # quality: its ~1e-3-scale posterior perturbation flips one H-step
    # omega basin per scoring set (indep seed 2 drops to 0.9199, ref
    # 0.9240).  The ±0.004 basin band of the self-tuned quality draws
    # bounds what such knobs can be validated to.
    mstep_tol: float = 5e-3
    # update clipping (core.py:91, 200, 218)
    da_bound: float = 5.0
    db_bound: float = 5.0
    dmu_bound: float = 5.0
    # hyperparameter search box for omega = 1/(2*timescale^2) (gp.py:84)
    omega_bound: Tuple[float, float] = (5e-4, 5e-2)
    # trial segmentation window (util.py:457-499)
    window: int = 50
    # H-step optimizer: fixed-iteration golden section on log-omega,
    # run as an Aitken-extrapolated fixed point (two or three searches
    # with the posterior covariance rebuilt at the running omega between
    # them).  hyper_polish adds one parabolic-interpolation refinement
    # after the shrinks; hyper_iters=12 + polish reproduces the golden-24
    # fixed points to ~1% (f64 oracle); the reference-matched 24-shrink
    # default stands.
    hyper_iters: int = 24
    hyper_polish: bool = False
    # number of posterior-refreshing searches per H-step call:
    # 2 (default) = two fixed-point refinements + Aitken, accepting the
    # trust-region-clamped extrapolation directly; 3 = add a polishing
    # search at the extrapolated point (one more sequential
    # grid+golden+Cholesky chain per EM iteration).  With the hyper_trust
    # cap in place, 2 matches 3 on every scored draw to within the ±0.004
    # basin band: reference tutorial head-to-head 0.9247 (2) vs 0.9252 (3)
    # vs reference 0.9212; independent draws (seed: 2 / 3 / ref)
    # 1: 0.9297/0.929/0.9247, 2: 0.9201/0.9227/0.9240,
    # 3: 0.9111/0.9081/0.9113.
    hyper_refines: int = 2
    # run the H-step only on every k-th EM iteration (iteration indices
    # 0, k, 2k, ...; the reference runs it every iteration,
    # core.py:329-339).  The omega fixed point it solves moves slowly
    # across EM iterations, so most every-iteration solves refine an
    # already-converged value against a barely-changed posterior.  On
    # skipped iterations omega/sigma and the prior factors are carried
    # unchanged (a uniform lax.cond, so the scan/SPMD paths stay
    # single-executable).  If the loop exits (convergence or max_iter) on
    # an iteration whose H-step was skipped, the drivers run one closing
    # H-step against the final posterior (runtime["final_hstep"] = True),
    # so the returned omega/sigma are never stale — the reference always
    # ends an iteration with its H-step (core.py:329-339).
    # Default 2: self-tuned R^2 at 4 / 2 / 1 / reference: tutorial
    # head-to-head 0.9251/0.9264/0.9247/0.9212; independent draws seed 1:
    # 0.9319/0.9335/0.9297/0.9247, seed 2: 0.9248/0.9253/0.9201/0.9240,
    # seed 3: 0.9167/0.9121/0.9111/0.9113 — at or above the reference
    # within the ±0.004 basin band on every draw.  4 needs ~50 EM
    # iterations to recovery R^2 0.95 on the flagship workload where 2
    # needs ~30.  1 = reference-matched every-iteration behavior
    # (exact-parity tests pin this).
    hyper_interval: int = 2
    # per-latent trust region on the accepted Aitken jump when the
    # extrapolated point is NOT polished by a third search
    # (hyper_refines <= 2): |aitken - x2| is capped at hyper_trust*|d2|
    # (d2 = the last fixed-point step), so a near-stationary ratio can't
    # teleport a latent across the omega box to the bound — the failure
    # mode measured on the independent draw (one latent collapsed to the
    # omega floor, R^2 0.9209 vs ref 0.9247).  The polished default
    # (hyper_refines=3) is unaffected: its third search re-evaluates the
    # objective at the extrapolated point and is its own guard.
    # 0 disables the cap.
    hyper_trust: float = 4.0
    # hyper_grid >= 3 prepends a coarse scan to every golden search: the
    # candidate objective is evaluated at hyper_grid log-spaced omegas
    # (ONE batched Cholesky — candidates ride the leading batch dim of
    # gp_elbo_stats) and the golden shrinks run inside the bracket around
    # the best candidate.  Golden section alone assumes a unimodal
    # objective; the GP-ELBO in omega is not (the H-step fixed point has
    # a sharp-basin attractor, see omega_init), so plain golden makes the
    # *basin* choice an accident of float noise in the posterior
    # statistic — measured: a 1e-5 E-step perturbation moved self-tuned
    # R^2 on the reference tutorial workload by 0.02.  The scan makes the
    # choice deterministic in the scanned box.  0 disables.
    hyper_grid: int = 13
    # optional log-radius restricting the grid scan to a box around each
    # latent's RUNNING omega (natural log; 1.1513 = half a decade);
    # 0 (default) scans the full omega box.  Measured on the reference
    # tutorial workload with the [1.2lo, 4lo] stagger: the full-box scan
    # keeps each latent locked to its init's basin (R^2 0.9243-0.9247,
    # plain and fused paths agreeing to 4e-4), while the windowed scan's
    # chain of local argmins lets a latent drift OUT of a good basin
    # (R^2 0.9195) — local scans follow shallow downhill paths that a
    # global comparison against the locked basin rejects.  The knob stays
    # for workloads whose omega moves genuinely far during the fit.
    hyper_window: float = 0.0
    # relative objective tolerance for the grid stage's smooth-preferring
    # tie-break (see models/gp.py:_golden_min): candidates within
    # hyper_tiebreak * |min| of the best are treated as tied and the
    # smoothest wins, making the basin choice deterministic under
    # float-scale input noise (kernel precision, psum reduction order)
    hyper_tiebreak: float = 1e-4
    # learn the GP amplitude sigma jointly with omega: the H-step
    # objective profiles sigma^2 out in closed form per candidate
    # (models/gp.py:gp_elbo_stats) and hstep updates params.sigma at the
    # accepted omega.  The reference pins sigma at its init with a
    # gradient mask (gp.py:77-91); the profile form is the consistent
    # extension of the same fixed-posterior objective, costs nothing (the
    # trace and logdet are already computed per candidate), and measured
    # +0.003 self-tuned R^2 on the reference tutorial workload (0.9270
    # vs 0.9243, reference 0.9212).  Set False for reference-matched
    # fixed-amplitude behavior.
    hyper_learn_sigma: bool = True
    # omega initialization when not user-supplied: "staggered" spreads the
    # latents log-uniformly over the SMOOTH side of the omega box
    # ([1.2*lo, 4*lo]) — latents are exchangeable, so this breaks the
    # symmetry that makes the coordinate-ascent H-step crawl when every
    # latent starts at the same value, while keeping every latent out of
    # the sharp-basin trap (the H-step fixed point is strongly
    # init-dominated; a latent initialized sharp freezes at a
    # noise-tracking solution — measured trajectories in api.py:_prepare).
    # "bound" reproduces the reference's all-at-upper-bound init
    # (preprocess.py:74)
    omega_init: str = "staggered"
    # ELBO trajectory: when True the drivers evaluate
    # evaluation.elbo_terms after every EM iteration (every block in scan
    # mode) and record the series in runtime["elbo"] /
    # runtime["elbo_terms"].  Host-side instrumentation, off the jitted
    # step — compiled executables are shared with untracked runs.  The
    # reference exposes no ELBO at all (its loglik is broken,
    # evaluation.py:14-19); BASELINE.json's headline metric is wall-clock
    # to ELBO convergence, so this is the first-class way to measure it.
    track_elbo: bool = False
    # convergence criterion: "norms" = the reference's relative-update
    # norms test (core.py:350-359); "elbo" = stop when the ELBO delta
    # stalls, |ELBO_t - ELBO_{t-1}| <= tol * |ELBO_t| (implies track_elbo;
    # ``tol`` is shared between both criteria)
    convergence: str = "norms"
    # checkpointing
    saving_interval: float = 1800.0
    path: Optional[str] = None
    # numerics
    dtype: str = "float32"
    seed: int = 0

    def __post_init__(self):
        if self.method not in ("VB", "MAP"):
            raise ValueError(f"method must be 'VB' or 'MAP', got {self.method!r}")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be a positive int or None")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.hyper_interval < 1:
            raise ValueError(
                f"hyper_interval must be >= 1, got {self.hyper_interval}"
            )
        if self.convergence not in ("norms", "elbo"):
            raise ValueError(
                f"convergence must be 'norms' or 'elbo', got {self.convergence!r}"
            )

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config(**kwargs) -> Config:
    """Build a :class:`Config`, raising on unknown keys.

    Deliberate improvement over the reference, which drops unknown kwargs on
    the floor (``vlgp/preprocess.py:108``).
    """
    valid = {f.name for f in dataclasses.fields(Config)}
    unknown = set(kwargs) - valid
    if unknown:
        raise TypeError(f"unknown config option(s): {sorted(unknown)}")
    return Config(**kwargs)


class Params(PyTreeNode):
    """Model parameters (reference ``params`` dict, ``vlgp/preprocess.py:49-81``).

    Immutable pytree; dims are implied by array shapes:
      a        (zdim, ydim)   loading matrix
      b        (xdim, ydim)   bias / history filter coefficients
      noise    (ydim,)        Gaussian channel observation variance
      sigma    (zdim,)        GP output scale
      omega    (zdim,)        GP inverse squared lengthscale 1/(2*tau^2)
      poisson  (ydim,) bool   per-channel likelihood mask (True=poisson)
      da, db                  last M-step updates (convergence check)
    """

    a: jnp.ndarray
    b: jnp.ndarray
    noise: jnp.ndarray
    sigma: jnp.ndarray
    omega: jnp.ndarray
    poisson: jnp.ndarray
    da: jnp.ndarray
    db: jnp.ndarray
    # optional (ydim,) bool channel mask: False = exactly-inert channel
    # (mesh padding, parallel/mesh.py:pad_channels).  The M-step pins
    # inactive channels to their initial (zero) state instead of demoting
    # them to a different likelihood family, so an all-Poisson model keeps
    # its static likelihood_kind gating under model sharding (VERDICT-r3
    # weak #3).  None (the default everywhere outside the sharded path)
    # means all channels are active and costs nothing.
    active: Optional[jnp.ndarray] = None
    # scalar model constants (static: part of the tree structure)
    gp_noise: float = static_field(default=1e-4)
    dt: float = static_field(default=1.0)
    rank: int = static_field(default=50)
    # static summary of the per-channel likelihood mix: "poisson",
    # "gaussian", or "mixed".  Known at trace time, so the M-step can skip
    # the entire unused update family (the all-Poisson flagship otherwise
    # spends ~1/3 of its M-step bandwidth computing Gaussian closed forms
    # that the final per-channel select throws away).  "mixed" is always
    # safe (both families computed, per-channel select applied).
    likelihood_kind: str = static_field(default="mixed")

    @property
    def zdim(self) -> int:
        return self.a.shape[0]

    @property
    def ydim(self) -> int:
        return self.a.shape[1]

    @property
    def xdim(self) -> int:
        return self.b.shape[0]


def make_params(
    ydim: int,
    zdim: int,
    xdim: int = 1,
    likelihood: Sequence[str] | str = "poisson",
    *,
    a: Optional[jnp.ndarray] = None,
    b: Optional[jnp.ndarray] = None,
    noise: Optional[jnp.ndarray] = None,
    sigma: Optional[jnp.ndarray] = None,
    omega: Optional[jnp.ndarray] = None,
    omega_bound: Tuple[float, float] = (5e-4, 5e-2),
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    dtype=jnp.float32,
) -> Params:
    """Parameter defaults, mirroring ``vlgp/preprocess.py:49-81``.

    omega defaults to the *upper* omega bound (shortest allowed timescale),
    as the reference does (``preprocess.py:74``).
    """
    if isinstance(likelihood, str):
        likelihood = [likelihood] * ydim
    if len(likelihood) != ydim:
        raise ValueError("likelihood must have one entry per channel")
    for lik in likelihood:
        if lik not in ("poisson", "gaussian"):
            raise ValueError(f"unknown likelihood {lik!r}")
    poisson = jnp.asarray([lik == "poisson" for lik in likelihood])
    if all(lik == "poisson" for lik in likelihood):
        kind = "poisson"
    elif all(lik == "gaussian" for lik in likelihood):
        kind = "gaussian"
    else:
        kind = "mixed"
    a = jnp.zeros((zdim, ydim), dtype) if a is None else jnp.asarray(a, dtype)
    b = jnp.zeros((xdim, ydim), dtype) if b is None else jnp.asarray(b, dtype)
    noise = (
        jnp.ones((ydim,), dtype) if noise is None else jnp.asarray(noise, dtype)
    )
    sigma = (
        jnp.ones((zdim,), dtype) if sigma is None else jnp.asarray(sigma, dtype)
    )
    omega = (
        jnp.full((zdim,), omega_bound[1], dtype)
        if omega is None
        else jnp.asarray(omega, dtype)
    )
    return Params(
        a=a,
        b=b,
        noise=noise,
        sigma=sigma,
        omega=omega,
        poisson=poisson,
        da=jnp.zeros_like(a),
        db=jnp.zeros_like(b),
        gp_noise=gp_noise,
        dt=dt,
        rank=rank,
        likelihood_kind=kind,
    )
