"""SPMD execution of the EM step over a ('data', 'model') mesh.

Wraps the single-device EM phases (written against :class:`Dist` axis
names) in ``shard_map``: segments are sharded over ``data``, observation
channels over ``model``.  Cross-segment reductions (M-step sufficient
statistics, H-step ELBO sums, convergence norms — the reference's
concatenations at core.py:166-171 and stacks at gp.py:77-78) become
``lax.psum('data')``; cross-channel contractions in the E-step
(``residual @ a`` and the weight refresh, core.py:87/104) become
``lax.psum('model')``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import Config, Params
from ..data import TrialSet
from ..models.driver import _jit_key, make_em_step
from ..models.vlgp import Dist, estep

__all__ = ["sharded_em_step", "sharded_em_scan", "sharded_infer", "DIST"]

DIST = Dist(data="data", model="model")

_NORM_KEYS = ("mu", "dmu", "a", "da", "b", "db")


def _trialset_specs() -> TrialSet:
    """Spec pytree for any TrialSet (structure is instance-independent).
    The field->spec mapping lives in mesh.py, the one source of truth for
    the sharding contract."""
    from .mesh import TRIALSET_SPEC_FIELDS

    return TrialSet(**TRIALSET_SPEC_FIELDS)


def _params_specs(gp_noise: float, dt: float, rank: int,
                  likelihood_kind: str = "mixed",
                  has_active: bool = False) -> Params:
    """Spec pytree for Params; the scalar statics must match the instance's
    (they ride the treedef and shard_map compares structures — including
    whether the optional ``active`` channel mask is present).  The
    field->spec mapping lives in mesh.py."""
    from .mesh import PARAMS_SPEC_FIELDS

    return Params(
        **PARAMS_SPEC_FIELDS,
        active=P("model") if has_active else None,
        gp_noise=gp_noise, dt=dt, rank=rank,
        likelihood_kind=likelihood_kind,
    )


def sharded_em_step(mesh: Mesh, config: Config, data: TrialSet, params: Params):
    """Build a jitted, shard_mapped EM step bound to ``mesh``.

    Returns a function (data, params, G, it) -> (data, params, G, norms);
    ``it`` is the (replicated) EM iteration index feeding the
    in-graph ``hyper_interval`` cond — the predicate is uniform across
    devices, so the H-step's data-axis psums can't deadlock.  (With
    ``hyper_interval=1`` the index is a dead operand; the signature stays
    fixed so callers never depend on the config.)  Cached on (mesh, config,
    params statics): repeated ``fit_sharded`` calls at the same mesh/config
    reuse the executable (review-r3: the per-call rebuild recompiled the
    SPMD graph every fit).
    """
    return _em_step_cached(mesh, _jit_key(config), params.gp_noise,
                           params.dt, params.rank, params.likelihood_kind,
                           params.active is not None)


@functools.lru_cache(maxsize=32)
def _em_step_cached(mesh, config, gp_noise, dt, rank, lik_kind="mixed",
                    has_active=False):
    em = make_em_step(config, DIST)
    dspec = _trialset_specs()
    pspec = _params_specs(gp_noise, dt, rank, lik_kind, has_active)
    norm_spec = {k: P() for k in _NORM_KEYS}
    with_it = config.hyper_interval > 1

    def stepped(data, params, G, it):
        return em(data, params, G, it=it if with_it else None)

    fn = shard_map(
        stepped,
        mesh=mesh,
        in_specs=(dspec, pspec, P(), P()),
        out_specs=(dspec, pspec, P(), norm_spec),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_em_scan(mesh: Mesh, config: Config, data: TrialSet,
                    params: Params, k: int):
    """k EM iterations as ONE shard_mapped dispatch (lax.scan over the
    fused step) — the SPMD analog of ``_scan_em_jit`` (models/driver.py).

    On a real multi-host pod every dispatch pays DCN/coordinator latency
    and every norms readback is a cross-host sync; scanning k steps per
    dispatch amortizes both (VERDICT-r2 item 6).  Per-step norms come back
    stacked (k,) so the host still sees every iteration's convergence
    numbers at the block boundary.  The returned function takes
    (data, params, G, it0) with ``it0`` the (replicated) block-start
    iteration index (dead operand at ``hyper_interval=1``; fixed signature,
    as in :func:`sharded_em_step`).  Cached like :func:`sharded_em_step`,
    so the tail block of a ``max_iter % block != 0`` fit compiles once per
    (mesh, config, k), not once per call.
    """
    return _em_scan_cached(mesh, _jit_key(config), k, params.gp_noise,
                           params.dt, params.rank, params.likelihood_kind,
                           params.active is not None)


@functools.lru_cache(maxsize=32)
def _em_scan_cached(mesh, config, k, gp_noise, dt, rank, lik_kind="mixed",
                    has_active=False):
    em = make_em_step(config, DIST)
    dspec = _trialset_specs()
    pspec = _params_specs(gp_noise, dt, rank, lik_kind, has_active)
    norm_spec = {key: P() for key in _NORM_KEYS}
    with_it = config.hyper_interval > 1

    def _scan(data, params, G, it0):
        def body(carry, i):
            d, p, g = carry
            d, p, g, norms = em(d, p, g, it=i if with_it else None)
            return (d, p, g), norms

        (data, params, G), norms = lax.scan(
            body, (data, params, G), it0 + jnp.arange(k)
        )
        return data, params, G, norms

    fn = shard_map(
        _scan,
        mesh=mesh,
        in_specs=(dspec, pspec, P(), P()),
        out_specs=(dspec, pspec, P(), norm_spec),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_infer(mesh: Mesh, config: Config, data: TrialSet, params: Params,
                  niter=None):
    """Shard_mapped inference-only E-step (core.py:260-266 analog); cached
    like :func:`sharded_em_step`."""
    n = config.max_iter if niter is None else niter
    return _infer_cached(mesh, _jit_key(config), n, params.gp_noise,
                         params.dt, params.rank, params.likelihood_kind,
                         params.active is not None)


@functools.lru_cache(maxsize=32)
def _infer_cached(mesh, config, niter, gp_noise, dt, rank,
                  lik_kind="mixed", has_active=False):
    dspec = _trialset_specs()
    pspec = _params_specs(gp_noise, dt, rank, lik_kind, has_active)

    def body(d, p, g):
        return estep(d, p, g, config, niter=niter, dist=DIST)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(dspec, pspec, P()),
        out_specs=dspec,
        check_vma=False,
    )
    return jax.jit(fn)
