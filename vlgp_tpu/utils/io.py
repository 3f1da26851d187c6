"""Persistence: save/load results and parameters.

Reference: ``util.save/load`` (util.py:181-208) pickle-via-npy of the whole
result dict.  Here results serialize to a flat ``.npz`` of arrays plus a
small JSON header (portable, no pickle execution risk), with an optional
orbax checkpoint path for training-time snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..config import Config, Params
from ..data import TrialSet
from ..init import FactorModel

__all__ = [
    "save",
    "load",
    "save_params",
    "load_params",
    "load_reference",
    "load_reference_trials",
    "from_reference_result",
]

_TRIAL_FIELDS = ("y", "x", "mask", "mu", "w", "v", "dmu", "trial_idx", "start", "lengths")
_PARAM_FIELDS = ("a", "b", "noise", "sigma", "omega", "poisson", "da", "db")
_FM_FIELDS = ("mean", "a", "psi")


def save(result, path) -> pathlib.Path:
    """Save a :class:`~vlgp_tpu.api.FitResult` to ``<path>.npz``."""
    path = pathlib.Path(path).with_suffix(".npz")
    arrays = {}
    for f in _TRIAL_FIELDS:
        arrays[f"data.{f}"] = np.asarray(getattr(result.data, f))
    for f in _PARAM_FIELDS:
        arrays[f"params.{f}"] = np.asarray(getattr(result.params, f))
    if result.factor_model is not None:
        for f in _FM_FIELDS:
            arrays[f"fm.{f}"] = np.asarray(getattr(result.factor_model, f))
    arrays["G"] = np.asarray(result.G)
    header = {
        "config": dataclasses.asdict(result.config),
        "scalars": {
            "gp_noise": result.params.gp_noise,
            "dt": result.params.dt,
            "rank": result.params.rank,
            "likelihood_kind": result.params.likelihood_kind,
        },
        "runtime": result.runtime,
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load(path):
    """Load a result back into a FitResult.

    Accepts both this package's ``.npz`` schema (written by :func:`save`)
    and the reference implementation's pickled result files
    (``vlgp/util.py:181-208``: ``np.save`` of the whole ``{'trials',
    'params', 'config'}`` dict to ``.npy``, or ``np.savez`` of its top-level
    keys) — so an existing reference result migrates with a plain
    ``vlgp_tpu.load``.  Reference files require unpickling
    (``allow_pickle=True``); only load files you trust.
    """
    from ..api import FitResult  # local import to avoid a cycle

    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if path.suffix == ".npy":
        return from_reference_result(_load_reference_object(path))
    z = np.load(path)
    if "header" not in z.files:
        z.close()
        return from_reference_result(_load_reference_object(path))
    header = json.loads(bytes(z["header"].tobytes()).decode())
    # files from versions with since-removed fields (ns_iters, ...) load
    cfg = {k: v for k, v in header["config"].items()
           if k in Config.__dataclass_fields__}
    if isinstance(cfg.get("omega_bound"), list):
        cfg["omega_bound"] = tuple(cfg["omega_bound"])
    config = Config(**cfg)
    data = TrialSet(**{f: jnp.asarray(z[f"data.{f}"]) for f in _TRIAL_FIELDS})
    params = Params(
        **{f: jnp.asarray(z[f"params.{f}"]) for f in _PARAM_FIELDS},
        **header["scalars"],
    )
    fm = None
    if "fm.mean" in z:
        fm = FactorModel(**{f: jnp.asarray(z[f"fm.{f}"]) for f in _FM_FIELDS})
    return FitResult(
        data=data,
        params=params,
        config=config,
        factor_model=fm,
        G=jnp.asarray(z["G"]),
        runtime=header.get("runtime", {}),
    )


# ---------------------------------------------------------------------------
# Reference-format migration shims (vlgp/util.py:181-208, __main__.py:18-21).
# The reference pickles its result/trials dicts via np.save; these loaders
# unpickle (trusted files only) and convert into the typed containers.
# ---------------------------------------------------------------------------

_REF_CONFIG_KEYS = (
    "constrain_loading", "use_hessian", "eps", "tol", "min_iter", "method",
    "learning_rate", "max_iter", "Eniter", "Mniter", "Hstep", "da_bound",
    "db_bound", "dmu_bound", "omega_bound", "window", "saving_interval",
)


def _load_reference_object(path):
    """np.load a reference-``save``d ``.npy``/``.npz`` back to a dict/list."""
    path = pathlib.Path(path)
    obj = np.load(path, allow_pickle=True)
    if path.suffix == ".npz" or hasattr(obj, "files"):
        out = {}
        for k in obj.files:
            v = obj[k]
            out[k] = v[()] if v.dtype == object and v.ndim == 0 else v
        return out
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return obj[()] if obj.ndim == 0 else list(obj)
    return obj


def _config_from_reference(rconfig: dict) -> Config:
    """Map a reference config dict (preprocess.py:84-112) onto :class:`Config`.

    Reference-only keys (``callbacks``, the never-read ``parallel``,
    ``runtime``) are dropped; falsy constraints normalize to ``"none"``.
    """
    kw = {}
    for k in _REF_CONFIG_KEYS:
        if k in rconfig:
            kw[k] = rconfig[k]
    for k in ("constrain_loading", "constrain_latent"):
        v = rconfig.get(k, None)
        if v is None:
            continue
        if not v or v == "none":
            kw[k] = "none"
        elif v is True:
            kw[k] = "both"
        else:
            kw[k] = str(v)
    if isinstance(kw.get("omega_bound"), (list, np.ndarray)):
        kw["omega_bound"] = tuple(float(x) for x in kw["omega_bound"])
    for k in ("use_hessian", "Hstep"):
        if k in kw:
            kw[k] = bool(kw[k])
    for k in ("min_iter", "max_iter", "Eniter", "Mniter", "window"):
        if k in kw:
            kw[k] = int(kw[k])
    for k in ("eps", "tol", "learning_rate", "da_bound", "db_bound",
              "dmu_bound", "saving_interval"):
        if k in kw:
            kw[k] = float(kw[k])
    # the reference computes everything in float64 and its config has no
    # dtype key; defaulting to this package's f32 would silently round
    # the migrated params/posteriors (~1e-7 relative) — review-r3 finding
    kw.setdefault("dtype", "float64")
    return Config(**kw)


def from_reference_result(rez):
    """Convert a reference result dict ``{'trials', 'params', 'config'}``
    (the object its ``api.fit`` returns and ``util.save`` pickles) into a
    :class:`~vlgp_tpu.api.FitResult`."""
    from ..api import FitResult  # local import to avoid a cycle
    from ..config import make_params
    from ..data import pack_trials
    from ..models.gp import make_cholesky

    if not isinstance(rez, dict) or "trials" not in rez or "params" not in rez:
        raise ValueError(
            "not a reference result (expected dict with 'trials' and 'params')"
        )
    trials = list(rez["trials"])
    rp = dict(rez["params"])
    config = _config_from_reference(dict(rez.get("config", {})))

    zdim = int(rp.get("zdim", np.asarray(rp["a"]).shape[0]))
    xdim = int(rp.get("xdim", np.asarray(rp["b"]).shape[0]))
    lik = rp.get("likelihood", "poisson")
    if isinstance(lik, np.ndarray):
        lik = [str(l) for l in lik]
    ydim = np.asarray(trials[0]["y"]).shape[-1]
    params = make_params(
        ydim, zdim, xdim, lik,
        a=np.asarray(rp["a"], np.float64) if rp.get("a") is not None else None,
        b=np.asarray(rp["b"], np.float64) if rp.get("b") is not None else None,
        noise=rp.get("noise"), sigma=rp.get("sigma"), omega=rp.get("omega"),
        rank=int(rp.get("rank", 50)),
        gp_noise=float(rp.get("gp_noise", 1e-4)),
        dt=float(rp.get("dt", 1.0)),
        dtype=jnp.dtype(config.dtype),
    )

    data = pack_trials(trials, zdim, xdim, dtype=np.dtype(config.dtype))
    # the reference's trial dicts carry the posterior state too — keep it
    lengths = np.asarray(data.lengths)
    extra = {}
    for field in ("w", "v", "dmu"):
        if all(field in t and t[field] is not None for t in trials):
            buf = np.zeros_like(np.asarray(data.mu))
            for i, t in enumerate(trials):
                buf[i, : lengths[i]] = np.asarray(t[field], buf.dtype)
            extra[field] = buf
    if extra:
        data = data.replace(**extra)

    G = make_cholesky(data.nbin, params)
    return FitResult(
        data=data, params=params, config=config, factor_model=None, G=G,
        runtime=dict(rez.get("config", {}).get("runtime", {})),
        _trials_in=trials,
    )


def load_reference(path):
    """Load a reference-``save``d *result* file into a FitResult."""
    return from_reference_result(_load_reference_object(path))


def load_reference_trials(path):
    """Load a reference-style *trials* file (the CLI input format,
    ``vlgp/__main__.py:18-21``): a pickled list of trial dicts with ``y``
    (and optional ``ID``/``x``/``mu``).  Returns a list of trial dicts."""
    obj = _load_reference_object(path)
    if isinstance(obj, dict) and "trials" in obj:
        obj = obj["trials"]
    if isinstance(obj, dict) and "y" in obj:
        obj = [obj]
    trials = list(obj)
    if not trials or not all(isinstance(t, dict) and "y" in t for t in trials):
        raise ValueError(f"no trial dicts with 'y' found in {path}")
    return trials


def save_params(params: Params, path) -> pathlib.Path:
    path = pathlib.Path(path).with_suffix(".npz")
    arrays = {f: np.asarray(getattr(params, f)) for f in _PARAM_FIELDS}
    arrays["_scalars"] = np.frombuffer(
        json.dumps(
            {"gp_noise": params.gp_noise, "dt": params.dt,
             "rank": params.rank,
             "likelihood_kind": params.likelihood_kind}
        ).encode(),
        dtype=np.uint8,
    )
    np.savez(path, **arrays)
    return path


def load_params(path) -> Params:
    z = np.load(pathlib.Path(path))
    scalars = json.loads(bytes(z["_scalars"].tobytes()).decode())
    return Params(**{f: jnp.asarray(z[f]) for f in _PARAM_FIELDS}, **scalars)


def save_checkpoint(path, params: Params, data: Optional[TrialSet] = None,
                    step: int = 0):
    """Orbax checkpoint of params (and optionally posterior state).

    Training-time alternative to the npz snapshot — async-friendly,
    multi-host-safe.  Restore with :func:`restore_checkpoint`.
    """
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    with ocp.StandardCheckpointer() as ckptr:
        tree = {"params": params}
        if data is not None:
            tree["posterior"] = {"mu": data.mu, "w": data.w, "v": data.v}
        ckptr.save(path / f"step_{step}", tree, force=True)
    return path / f"step_{step}"


def restore_checkpoint(path, params_like: Params,
                       data_like: Optional[TrialSet] = None):
    """Restore an orbax checkpoint saved by :func:`save_checkpoint`.

    ``params_like``/``data_like`` provide the pytree structure/shapes.
    Returns (params, posterior_dict_or_None).
    """
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).resolve()
    with ocp.StandardCheckpointer() as ckptr:
        target = {"params": params_like}
        if data_like is not None:
            target["posterior"] = {
                "mu": data_like.mu, "w": data_like.w, "v": data_like.v
            }
        out = ckptr.restore(path, target)
    return out["params"], out.get("posterior")
