"""High-level multi-device fit: the api.fit pipeline over a device mesh.

Mirrors :func:`vlgp_tpu.fit` (reference api.py:18-76) but runs the VEM loop
and final inference through the shard_mapped SPMD step: segments sharded
over the ``data`` axis, channels over ``model``.  Single-host multi-device
out of the box; multi-host after ``jax.distributed.initialize()``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..api import FitResult, _prepare
from ..config import Config, default_config
from ..data import cut_trials, scatter_segments
from ..models.driver import _converged, _elbo_record, _track_elbo
from ..models.gp import make_cholesky
from ..models.vlgp import update_v, update_w
from .mesh import (
    make_mesh,
    to_host,
    pad_channels,
    pad_segments,
    replicate,
    shard_data,
    trim_channels,
)
from .spmd import sharded_em_scan, sharded_em_step, sharded_infer

__all__ = ["fit_sharded", "initialize_distributed"]


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up: thin wrapper over ``jax.distributed.initialize``
    (coordinator address etc. via env or kwargs).  The reference has no
    multi-process story at all (SURVEY §2)."""
    jax.distributed.initialize(**kwargs)


def fit_sharded(
    trials: Sequence[dict],
    n_factors: int,
    mesh: Optional[Mesh] = None,
    verbose: bool = False,
    block: int = 1,
    callbacks: Sequence[Callable] = (),
    **kwargs,
) -> FitResult:
    """Fit vLGP with the EM step sharded over a ('data', 'model') mesh.

    Any channel count works with any model-axis size: channels are padded
    with exactly-inert masked channels when needed (:func:`pad_channels`).
    Extra keyword args are split between model parameters and
    :class:`Config` exactly as in :func:`vlgp_tpu.fit`.

    Feature parity with the single-device :func:`vlgp_tpu.fit`
    (VERDICT-r3 #3): ``callbacks`` fire at iteration boundaries (block
    boundaries in block mode) as ``cb(segments, params, config)`` with the
    channel padding already trimmed from ``params`` (the reference hook
    contract, core.py:341-345, with RuntimeError swallowed); ``path=...``
    wires a :class:`~vlgp_tpu.callback.Saver` exactly like ``fit``;
    ``track_elbo``/``convergence='elbo'`` record the (real-segment,
    real-channel) ELBO trajectory; the result carries ``initial_params``.

    ``block=k`` scans k EM iterations per shard_mapped dispatch — one
    device dispatch and ONE host norms-sync per k iterations instead of
    per iteration (on multi-host pods each sync is a cross-host barrier).
    Convergence is checked per-iteration from the stacked block norms;
    like :func:`~vlgp_tpu.models.driver.vem`, ``runtime['converged_at']``
    records the first converged iteration while ``runtime['it']`` counts
    the full executed block.
    """
    config_keys = set(Config.__dataclass_fields__)
    config = default_config(**{k: v for k, v in kwargs.items() if k in config_keys})
    prep_kwargs = {k: v for k, v in kwargs.items() if k not in config_keys}
    callbacks = list(callbacks)
    saver = None
    if config.path is not None:
        from ..callback import Saver

        saver = Saver(config.path, config.saving_interval)
        callbacks.append(saver)
    data, params, fm = _prepare(trials, n_factors, config, **prep_kwargs)

    initial_params = params  # pre-VEM snapshot (api.py:60 analog)
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    ydim_real = data.ydim
    # channel count need not divide the model axis: pad with exactly-inert
    # masked channels (zero data, zero loading, Gaussian likelihood)
    data, params = pad_channels(data, params, n_model)

    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)

    segments = cut_trials(data, config.window, seed=config.seed)
    n_real_segments = segments.ntrial
    segments = shard_data(pad_segments(segments, n_data), mesh)
    from ..models.gp import effective_rank

    omega_hi = max(float(jnp.max(params.omega)), config.omega_bound[1])
    seg_rank = min(params.rank,
                   effective_rank(segments.nbin, omega_hi, params.dt))
    G_seg = make_cholesky(segments.nbin, params, rank=seg_rank)
    params_r, G_seg = replicate((params, G_seg), mesh)

    runtime = {"it": 0, "em_elapsed": []}
    params = params_r

    def _trimmed_params(p):
        """Host view of the parameters with channel padding removed, for
        callbacks/checkpoints (a padded checkpoint would not restore into
        an unpadded fit)."""
        p = jax.tree.map(jnp.asarray, to_host(p))
        if p.active is None:
            return p
        return p.replace(
            a=p.a[:, :ydim_real], b=p.b[:, :ydim_real],
            da=p.da[:, :ydim_real], db=p.db[:, :ydim_real],
            noise=p.noise[:ydim_real], poisson=p.poisson[:ydim_real],
            active=None,
        )

    def _boundary(segments, params, G_seg):
        """Iteration/block-boundary host work shared by both drivers:
        callbacks (reference hook contract) + optional ELBO tracking on
        the real (unpadded) segments/channels."""
        if callbacks or _track_elbo(config):
            p_trim = _trimmed_params(params)
            if _track_elbo(config):
                # host-side (uncommitted) copies: elbo_terms must not mix
                # mesh-committed shards with the trimmed host params in one
                # dispatch
                seg_real = jax.tree.map(
                    lambda x: jnp.asarray(x[:n_real_segments]),
                    to_host(segments),
                )
                seg_real = seg_real.replace(
                    y=seg_real.y[..., :ydim_real],
                    x=seg_real.x[..., :ydim_real],
                )
                _elbo_record(runtime, seg_real, p_trim,
                             jnp.asarray(to_host(G_seg)))
            for cb in callbacks:
                try:
                    cb(segments, p_trim, config)
                except RuntimeError:  # core.py:341-345 swallows these
                    pass

    def _elbo_converged():
        if config.convergence != "elbo":
            return False
        e = runtime.get("elbo", [])
        return (len(e) >= 2 and runtime["it"] >= config.min_iter
                and abs(e[-1] - e[-2]) <= config.tol * abs(e[-1]))

    if block > 1:
        run = sharded_em_scan(mesh, config, segments, params_r, block)
        done = False
        while runtime["it"] < config.max_iter and not done:
            k = min(block, config.max_iter - runtime["it"])
            step = run if k == block else sharded_em_scan(
                mesh, config, segments, params_r, k
            )
            tic = time.perf_counter()
            segments, params, G_seg, norms_k = step(
                segments, params, G_seg, runtime["it"]
            )
            # ONE host sync per block: the stacked norms readback
            norms_k = {key: list(map(float, v)) for key, v in norms_k.items()}
            elapsed = time.perf_counter() - tic
            for i in range(k):
                runtime["it"] += 1
                runtime["em_elapsed"].append(elapsed / k)
                norms = {key: norms_k[key][i] for key in norms_k}
                if (config.convergence == "norms"
                        and _converged(norms, config.tol)
                        and runtime["it"] >= config.min_iter and not done):
                    runtime["converged_at"] = runtime["it"]
                    done = True
            _boundary(segments, params, G_seg)
            if _elbo_converged() and not done:
                runtime["converged_at"] = runtime["it"]
                done = True
            if verbose:
                print(f"Iteration {runtime['it']}, "
                      f"EM {elapsed / k:.2f}s/it (block {k})")
    else:
        step = sharded_em_step(mesh, config, segments, params_r)
        for it in range(config.max_iter):
            runtime["it"] += 1
            tic = time.perf_counter()
            segments, params, G_seg, norms = step(
                segments, params, G_seg, it
            )
            norms = {k: float(v) for k, v in norms.items()}
            runtime["em_elapsed"].append(time.perf_counter() - tic)
            if verbose:
                print(f"Iteration {it + 1}, EM {runtime['em_elapsed'][-1]:.2f}s")
            _boundary(segments, params, G_seg)
            if _elbo_converged():
                runtime["converged_at"] = runtime["it"]
                break
            if (config.convergence == "norms"
                    and _converged(norms, config.tol)
                    and it + 1 >= config.min_iter):
                runtime["converged_at"] = runtime["it"]
                break

    interval = int(config.hyper_interval)
    if (config.Hstep and interval > 1 and runtime["it"] > 0
            and (runtime["it"] - 1) % interval != 0):
        # closing H-step (ADVICE-r4, mirroring models/driver._final_hstep):
        # the loop exited on an iteration whose H-step was skipped, so
        # omega/sigma are up to interval-1 iterations stale against the
        # final posterior.  One host-side H-step over the gathered segments
        # computes exactly the global pooled statistic the in-loop sharded
        # H-step psums (padded segments are mask-inert in both).
        from ..models.gp import hstep

        seg_h = jax.tree.map(jnp.asarray, to_host(segments))
        p_h = jax.tree.map(jnp.asarray, to_host(params))
        p_h = hstep(seg_h, p_h, config, rank=G_seg.shape[-1])
        params = replicate(p_h, mesh)
        runtime["final_hstep"] = True

    # gather the trained posterior back into the full trials
    seg_host = to_host(segments)
    seg_trim = jax.tree.map(lambda x: x[:n_real_segments], seg_host)
    data = scatter_segments(data, seg_trim)

    # final full-length inference, data-parallel over trials
    G_full = make_cholesky(data.nbin, params)
    data = update_w(data, params, config)
    data = update_v(data, params, G_full, config)
    n_trials_real = data.ntrial
    data_s = shard_data(pad_segments(data, n_data), mesh)
    params_r, G_full_r = replicate((params, G_full), mesh)
    inf = sharded_infer(mesh, config, data_s, params_r)
    data_s = inf(data_s, params_r, G_full_r)
    data = jax.tree.map(lambda x: x[:n_trials_real], to_host(data_s))
    from ..data import TrialSet

    data = TrialSet(**{f: jnp.asarray(getattr(data, f))
                       for f in ("y", "x", "mask", "mu", "w", "v", "dmu",
                                 "trial_idx", "start", "lengths")})
    data, params = trim_channels(data, jax.tree.map(jnp.asarray, to_host(params)),
                                 ydim_real)

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
