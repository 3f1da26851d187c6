"""Public API: fit / transform / sample_posterior / fastfit / resume.

Reference: ``vlgp/api.py``.  The reference pipeline (api.py:18-76):
config -> params -> FA initialization -> prior factors -> w/v init ->
segmentation -> VEM on segments -> refreshed factors -> final full-length
inference.  Same pipeline here over padded/masked pytrees, with a typed
result object instead of a mutable dict soup.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from .config import Config, Params, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, scatter_segments, unpack_trials
from .init import FactorModel, initialize
from .models import gpfa
from .models.driver import infer, vem
from .models.gp import effective_rank, make_cholesky, posterior_cov
from .models.vlgp import update_v, update_w

__all__ = ["fit", "transform", "sample_posterior", "fastfit", "map2vi", "resume", "FitResult"]


@dataclasses.dataclass
class FitResult:
    """Fit output.  Also indexable like the reference result dict
    (``result['trials']/'params'/'config'``, api.py:74-76)."""

    data: TrialSet
    params: Params
    config: Config
    factor_model: Optional[FactorModel]
    G: jnp.ndarray
    runtime: dict
    initial_params: Optional[Params] = None
    _trials_in: Optional[Sequence[dict]] = None

    @property
    def trials(self) -> List[dict]:
        return unpack_trials(self.data, self._trials_in)

    def __getitem__(self, key):
        if key == "trials":
            return self.trials
        if key == "params":
            return self.params
        if key == "config":
            return self.config
        raise KeyError(key)



def _fill_missing_mu(data: TrialSet, trials, mu) -> TrialSet:
    """Merge an initializer's posterior means into ``data`` per trial,
    keeping any trial's user-supplied ``mu`` (preprocess.py:40-41 fills per
    trial too; an all-or-nothing gate was ADVICE-r1)."""
    user_mu = np.array(["mu" in t and t["mu"] is not None for t in trials])
    mu = mu.astype(data.mu.dtype)
    if user_mu.any():
        keep = jnp.asarray(user_mu)[:, None, None]
        mu = jnp.where(keep, data.mu, mu)
    return data.replace(mu=mu)


def _prepare(
    trials: Sequence[dict],
    n_factors: int,
    config: Config,
    *,
    lik: Union[str, Sequence[str]] = "poisson",
    history: int = 0,
    a=None,
    b=None,
    noise=None,
    sigma=None,
    omega=None,
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    factor_model: Optional[FactorModel] = None,
) -> Tuple[TrialSet, Params, Optional[FactorModel]]:
    """Pack trials, initialize parameters and posterior (api.py:39-54).

    xdim = 1 + history: one constant column plus the history lags (the
    reference's ``max(history, 1)`` at preprocess.py:60 is off by one
    against its own ``util.history`` design builder, which emits 1 + lag
    columns — the mismatch goes unnoticed there because nothing fills the
    history design).
    """
    xdim = history + 1
    np_dtype = np.dtype(config.dtype)
    data = pack_trials(trials, n_factors, xdim, dtype=np_dtype)

    key = jax.random.PRNGKey(config.seed)
    need_init = a is None or b is None or noise is None
    fm = factor_model
    mu = None
    if factor_model is not None:
        mu = jax.vmap(factor_model.transform)(data.y) * data.mask[..., None]
    elif need_init:
        fm, a0, b0, noise0, mu = initialize(data, n_factors, key, eps=config.eps)
        if a is None:
            a = a0
        if b is None:
            b = jnp.zeros((xdim, data.ydim), a0.dtype).at[0].set(b0)
        if noise is None:
            noise = noise0
    if mu is not None:
        data = _fill_missing_mu(data, trials, mu)

    if b is not None:
        b = jnp.atleast_2d(jnp.asarray(b))
        if b.shape[0] != xdim:  # allow (ydim,) bias vectors
            b = jnp.zeros((xdim, data.ydim), b.dtype).at[0].set(b.reshape(-1))

    if omega is None and config.omega_init == "staggered" and n_factors > 1:
        # Log-uniform stagger over the SMOOTH side of the omega box.
        # The H-step fixed point is strongly init-dominated (models/gp.py:
        # the fixed-posterior objective self-reinforces whatever roughness
        # the posterior already encodes, so each latent's omega mostly
        # *stays near its init* and drifts slowly — measured trajectories
        # move ~1-5%/EM iteration).  A latent initialized sharp settles at
        # a self-consistent sharp solution that tracks likelihood noise
        # and never smooths out (measured: inits at 1.6e-2 and 6e-3 both
        # sat frozen for all 20 EM iterations while their siblings
        # descended to ~5e-4).  Starting in [1.2*lo, 4*lo] keeps every
        # latent on the smooth side while preserving the symmetry-breaking
        # diversity the coordinate-ascent H-step needs.  Head-to-head on
        # the reference's own tutorial data (tools/head2head.py) this
        # scores R^2 0.923-0.924 vs the reference's 0.921, STABLY: the
        # fused-kernel and plain E-step paths land within 0.001 of each
        # other (the old 12*lo span scored 0.914-0.936 depending on
        # ~1e-5 kernel-level perturbations — a chaos band, not a number).
        lo, hi = config.omega_bound
        bottom = min(lo * 1.2, hi)
        top = max(min(lo * 4, hi / 3), bottom)  # narrow boxes: stay inside
        omega = np.clip(
            np.logspace(np.log10(bottom), np.log10(top), n_factors), lo, hi
        )

    params = make_params(
        data.ydim,
        n_factors,
        xdim,
        lik,
        a=a,
        b=b,
        noise=noise,
        sigma=sigma,
        omega=omega,
        omega_bound=config.omega_bound,
        rank=rank,
        gp_noise=gp_noise,
        dt=dt,
        dtype=config.jdtype,
    )
    return data, params, fm


def fit(
    trials: Sequence[dict],
    n_factors: int,
    *,
    lik: Union[str, Sequence[str]] = "poisson",
    history: int = 0,
    a=None,
    b=None,
    noise=None,
    sigma=None,
    omega=None,
    rank: int = 50,
    gp_noise: float = 1e-4,
    dt: float = 1.0,
    callbacks: Sequence[Callable] = (),
    verbose: bool = False,
    fused: bool = False,
    block: int = 1,
    factor_model: Optional[FactorModel] = None,
    **config_kwargs,
) -> FitResult:
    """Fit the vLGP model (reference entry point api.py:18-76).

    trials: list of dicts with ``y`` (length, ydim); optional ``x``, ``mu``.
    Unequal lengths are padded and masked.  ``fused=True`` runs each EM
    iteration as a single jitted graph; ``block=k`` with ``fused`` scans
    k iterations per device dispatch.

    Passing ``path=...`` snapshots the parameters every
    ``saving_interval`` seconds during VEM and writes a final restorable
    checkpoint at ``<path>.npz`` — the behavior the reference README
    advertises (README.md:72) but never delivers (its Saver wiring is
    commented out at api.py:32-37 and the callback itself crashes,
    callback.py:22).  Restore with :func:`vlgp_tpu.utils.io.load_params`.
    """
    config = default_config(**config_kwargs)
    callbacks = list(callbacks)
    saver = None
    if config.path is not None:
        from .callback import Saver

        saver = Saver(config.path, config.saving_interval)
        callbacks.append(saver)
    data, params, fm = _prepare(
        trials, n_factors, config,
        lik=lik, history=history, a=a, b=b, noise=noise, sigma=sigma,
        omega=omega, rank=rank, gp_noise=gp_noise, dt=dt,
        factor_model=factor_model,
    )

    # prior factors + initial posterior weights on full trials (api.py:52-54)
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)

    # segmentation for training (api.py:56-58); segment factors trimmed to
    # the omega box's effective rank (numerically exact, see gp.effective_rank)
    segments = cut_trials(data, config.window, seed=config.seed)
    # trim rank for the sharpest kernel that can occur: the omega box top,
    # or a user-supplied omega above it (ADVICE-r1: a clamped trim there
    # silently degraded the factor)
    omega_hi = max(float(jnp.max(params.omega)), config.omega_bound[1])
    seg_rank = min(
        params.rank,
        effective_rank(segments.nbin, omega_hi, dt),
    )
    G_seg = make_cholesky(segments.nbin, params, rank=seg_rank)

    initial_params = params

    # VEM on segments (api.py:64)
    segments, params, G_seg, runtime = vem(
        segments, params, G_seg, config, callbacks=callbacks, verbose=verbose,
        fused=fused, block=block,
    )

    # write trained posterior back, refresh factors, final full inference
    # (api.py:66-71; the reference gets the write-back via view aliasing)
    data = scatter_segments(data, segments)
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)
    data = infer(data, params, G_full, config)

    if saver is not None:  # final snapshot regardless of the interval
        saver.save(data, params, config, force=True)

    return FitResult(
        data=data,
        params=params,
        config=config,
        factor_model=fm,
        G=G_full,
        runtime=runtime,
        initial_params=initial_params,
        _trials_in=trials,
    )


def transform(
    trials: Sequence[dict],
    result_or_params,
    config: Optional[Config] = None,
    factor_model: Optional[FactorModel] = None,
) -> List[dict]:
    """Infer latents for new trials under fitted parameters (api.py:171-184).

    Unlike the reference — which requires the factor cache to already hold
    the new trials' lengths (core.py:56-58 TODO) — prior factors are built
    for whatever lengths arrive.
    """
    if isinstance(result_or_params, FitResult):
        params = result_or_params.params
        config = result_or_params.config if config is None else config
        factor_model = (
            result_or_params.factor_model if factor_model is None else factor_model
        )
    else:
        params = result_or_params
        if config is None:
            config = Config()

    data = pack_trials(trials, params.zdim, params.xdim, dtype=np.dtype(config.dtype))
    if factor_model is not None:
        mu = jax.vmap(factor_model.transform)(data.y) * data.mask[..., None]
        data = _fill_missing_mu(data, trials, mu)
    G = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G, config)
    data = infer(data, params, G, config)
    return unpack_trials(data, trials)


def sample_posterior(
    result, trial, nsamples: int = None, key=None, reg: float = 1e-6,
    method: str = "lowrank", nsample=None,
):
    """Draw joint posterior samples for one trial (api.py:142-168).

    Two call forms, matching both this package's result object and the
    reference's raw-state signature ``sample_posterior(trial, params,
    nsamples)`` (api.py:142):

      * ``sample_posterior(fit_result, trial_index, nsamples)`` — sample
        trial ``trial_index`` of a :class:`FitResult` (including one
        migrated from a reference file via ``load_reference``);
      * ``sample_posterior(trial_dict, params, nsamples)`` — any trial dict
        carrying the posterior state (``mu`` (T, z) and ``w``) plus a
        :class:`~vlgp_tpu.config.Params`; prior factors are built for the
        trial's length on the fly (the reference instead KeyErrors unless
        ``params['cholesky']`` already caches that length).

    Returns (nsamples, length, n_factors).

    method="lowrank" (default): under the low-rank prior K = GG', the
    posterior covariance is exactly S = G (I + G'WG)^{-1} G', so a sample
    is mu + G chol((I+G'WG)^{-1}) eps — O(T r) per sample instead of the
    reference's two dense T x T inversions per factor (api.py:165,
    self-documented as slow).  method="dense" reproduces the dense
    Woodbury construction (util.py:541-547) for cross-checking.
    """
    if nsamples is None:
        nsamples = nsample  # reference keyword spelling
    if nsamples is None:
        raise TypeError("nsamples is required")
    if isinstance(result, FitResult):
        seed = result.config.seed
        L = int(result.data.lengths[trial])
        mu = result.data.mu[trial]  # (T, z)
        w = result.data.w[trial]
        mask = result.data.mask[trial]
        G = result.G  # (z, T, r)
    else:  # raw (trial_dict, params) — reference call form
        trial_dict, params = result, trial
        if not isinstance(trial_dict, dict) or "mu" not in trial_dict:
            raise TypeError(
                "expected a FitResult + trial index, or a trial dict with "
                "'mu'/'w' + Params"
            )
        seed = 0
        mu = jnp.asarray(trial_dict["mu"], params.a.dtype)
        w = jnp.asarray(trial_dict["w"], params.a.dtype)
        L = mu.shape[0]
        mask = jnp.ones(L, mu.dtype)
        G = make_cholesky(L, params)
    if key is None:
        key = jax.random.PRNGKey(seed)
    zdim = mu.shape[-1]

    if method == "lowrank":
        def one_factor(G_l, w_l, mu_l, k):
            R = G_l.shape[-1]
            A = jnp.einsum("tr,t,tq->rq", G_l, w_l * mask, G_l)
            X = jnp.linalg.inv(jnp.eye(R, dtype=G_l.dtype) * (1.0 + reg) + A)
            C = jnp.linalg.cholesky(X + reg * jnp.eye(R, dtype=X.dtype))
            eps = jax.random.normal(k, (nsamples, R), dtype=G_l.dtype)
            return mu_l[None, :] + (eps @ C.T) @ G_l.T

        keys = jax.random.split(key, zdim)
        samples = jax.vmap(one_factor, in_axes=(0, 1, 1, 0))(G, w, mu, keys)
        return jnp.transpose(samples, (1, 2, 0))[:, :L, :]

    def one_factor_dense(G_l, w_l, mu_l, k):
        S = posterior_cov(w_l * mask, G_l, reg)
        S = S + reg * jnp.eye(S.shape[0], dtype=S.dtype)
        C = jnp.linalg.cholesky(S)
        eps = jax.random.normal(k, (nsamples, S.shape[0]), dtype=S.dtype)
        return mu_l[None, :] + eps @ C.T

    keys = jax.random.split(key, zdim)
    samples = jax.vmap(one_factor_dense, in_axes=(0, 1, 1, 0))(G, w, mu, keys)
    return jnp.transpose(samples, (1, 2, 0))[:, :L, :]


def map2vi(trials, C, d, **kwargs):
    """Seed vLGP with GPFA-style (C, d) and run a short fit (api.py:79-105).

    The reference version crashes (NameError on Saver, api.py:88) whenever a
    save path is configured — fixed here by simply not referencing dead
    imports.
    """
    n_factors = C.shape[0]
    kwargs.setdefault("max_iter", 5)
    b = jnp.log(jnp.maximum(jnp.asarray(d), 1e-8))
    return fit(trials, n_factors, a=jnp.asarray(C), b=b, **kwargs)


def fastfit(trials, n_factors, dt, var, scale, max_iter=20, **kwargs):
    """GPFA-warm-started fit (api.py:108-119).

    Runs the linear-Gaussian GPFA EM on window segments, then seeds vLGP
    with the learned loading/bias and the matched omega = 0.5/(scale/dt)^2.
    """
    config = default_config(**{k: v for k, v in kwargs.items()
                               if k in Config.__dataclass_fields__})
    omega = np.full(n_factors, 0.5 / ((scale / dt) ** 2))

    data, params, fm = _prepare(trials, n_factors, config, dt=dt)
    segments = cut_trials(data, config.window, seed=config.seed)
    K = gpfa.make_prior(segments.nbin, dt, var, scale)
    C0 = params.a
    d0 = jnp.exp(params.b[0])
    R0 = jnp.ones(data.ydim, dtype=K.dtype)
    _, C, d, _ = gpfa.em(segments.y, C0, d0, R0, K, max_iter)

    return map2vi(trials, C, d, omega=omega, dt=dt, factor_model=fm, **kwargs)


def resume(result: FitResult, **config_kwargs) -> FitResult:
    """Continue from a fit: infer -> M-step refinement -> infer.

    The reference ``resume`` (api.py:122-140) intends an E/M/E sequence but
    its middle pass sets Eniter=0, making the M phase a no-op
    (core.py:24-25) — here the M-step actually runs.
    """
    config = result.config if not config_kwargs else result.config.replace(**config_kwargs)
    data, params, G = result.data, result.params, result.G
    data = infer(data, params, G, config)
    from .models.driver import _jit_key, _mstep_jit

    params = _mstep_jit(_jit_key(config))(data, params)
    data = infer(data, params, G, config)
    return dataclasses.replace(result, data=data, params=params, config=config)
