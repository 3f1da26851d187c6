"""vlgp_tpu — variational Latent Gaussian Process framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of catniplab/vlgp
(Zhao & Park, Neural Computation 2017): recover low-dimensional smooth
latent trajectories from multi-trial neural population recordings
(Poisson spike counts and/or Gaussian channels) by variational EM with
low-rank GP priors.

Design: immutable pytrees instead of mutable dict-soup, one batched jitted
EM step instead of Python triple loops, pad+mask instead of ragged trials,
and a data x model device mesh (``vlgp_tpu.parallel``) instead of no
parallelism at all.  See SURVEY.md for the reference layer map.
"""
import logging as _logging
import os as _os
import pathlib as _pathlib

from .api import FitResult, fastfit, fit, map2vi, resume, sample_posterior, transform
from .config import Config, Params, default_config, make_params
from .data import TrialSet, cut_trials, pack_trials, unpack_trials
from . import evaluation, model_selection, simulation
from .models import gpfa
from .utils.io import load, load_reference, load_reference_trials, save

__all__ = [
    "fit",
    "transform",
    "sample_posterior",
    "fastfit",
    "map2vi",
    "resume",
    "FitResult",
    "Config",
    "Params",
    "default_config",
    "make_params",
    "TrialSet",
    "pack_trials",
    "cut_trials",
    "unpack_trials",
    "save",
    "load",
    "load_reference",
    "load_reference_trials",
    "gpfa",
    "simulation",
    "evaluation",
    "model_selection",
    "compilation_cache_dir",
    "enable_compilation_cache",
]

__version__ = "0.1.0"

# Structured logging to stderr by default; the reference appends to a file
# `vlgp.log` as an import side effect (vlgp/__init__.py:7-12) — opt in via
# vlgp_tpu.enable_file_logging() instead of surprising the importer.
logger = _logging.getLogger("vlgp_tpu")


def compilation_cache_dir() -> str:
    """Where :func:`enable_compilation_cache` keeps compiled executables:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.

    The fallback is a fixed absolute path (built from this file's location,
    not the working directory), so every process of a checkout finds the
    executables an earlier one stored.
    """
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_compilation_cache(path: str | None = None) -> str:
    """Persist compiled XLA executables across processes; returns the
    directory used (``path``, else :func:`compilation_cache_dir`).

    A flagship fit compiles a few dozen executables; with the cache a
    second process at the same shapes loads them instead of recompiling.
    """
    import jax

    path = compilation_cache_dir() if path is None else path
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def enable_file_logging(path: str = "vlgp_tpu.log", level=_logging.INFO) -> None:
    handler = _logging.FileHandler(path)
    handler.setFormatter(
        _logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
