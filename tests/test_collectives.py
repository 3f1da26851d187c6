"""Collective accounting for the SPMD EM step (VERDICT-r3 #4).

The scaling contract of the sharded design is that one EM iteration costs
a FIXED number of collectives — the data-axis psums of the M-step/H-step
sufficient statistics and convergence norms (the reference's cross-trial
concatenations, core.py:166-171, and segment stacks, gp.py:77-78) plus the
model-axis psums of the E-step channel contractions (core.py:87/104) —
independent of how many devices the mesh has.  If a change accidentally
introduces a per-shard or per-device collective (e.g. an all_gather of a
sharded operand), these tests catch it at lowering time, without needing
multi-chip hardware.
"""
import re

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from vlgp_tpu.config import default_config, make_params
from vlgp_tpu.data import cut_trials, pack_trials
from vlgp_tpu.models.gp import make_cholesky
from vlgp_tpu.models.vlgp import update_w
from vlgp_tpu.parallel.mesh import make_mesh, pad_segments, replicate, shard_data
from vlgp_tpu.parallel.spmd import sharded_em_scan, sharded_em_step

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "all-to-all", "reduce-scatter")


def _problem(ntrial=8, length=100, ydim=16, zdim=2):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(zdim, ydim)) * 0.5
    trials = []
    for _ in range(ntrial):
        z = np.column_stack(
            (np.sin(np.linspace(0, 6, length)), np.cos(np.linspace(0, 6, length)))
        )
        y = rng.poisson(np.exp(z @ a - 1.5)).astype(float)
        trials.append({"y": y, "mu": rng.normal(size=(length, zdim)) * 0.1})
    config = default_config(dtype="float64", Eniter=3, Mniter=3,
                            hyper_iters=10, estep_tol=0, mstep_tol=0)
    params = make_params(ydim, zdim, 1, "poisson", a=a,
                         b=np.full((1, ydim), -1.5),
                         omega=np.full(zdim, 1e-2), dtype=jnp.float64)
    data = pack_trials(trials, zdim, 1, dtype=np.float64)
    segments = cut_trials(data, config.window, seed=0)
    G = make_cholesky(segments.nbin, params)
    segments = update_w(segments, params, config)
    return segments, params, G, config


def _counts(txt):
    """Collective-op counts in lowered StableHLO text."""
    return {
        name: len(re.findall(name.replace("-", "[-_.]"), txt))
        for name in _COLLECTIVES
    }


def _lowered_em_step(shape):
    segments, params, G, config = _problem()
    mesh = make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
    seg_s = shard_data(pad_segments(segments, shape[0]), mesh)
    params_s, G_s = replicate((params, G), mesh)
    step = sharded_em_step(mesh, config, seg_s, params_s)
    return _counts(step.lower(seg_s, params_s, G_s, 0).as_text())


def test_collective_count_independent_of_mesh_size():
    """The per-iteration collective count must be O(1) in the number of
    devices: identical across 2-, 4- and 8-device meshes and across
    dp/tp splits of the same device count."""
    counts = {shape: _lowered_em_step(shape)
              for shape in [(2, 1), (8, 1), (4, 2), (2, 4)]}
    base = counts[(2, 1)]
    for shape, c in counts.items():
        assert c == base, (shape, c, base)
    # every cross-device op is a reduction: no gathers/permutes of
    # sharded operands anywhere in the step
    assert base["all-gather"] == 0
    assert base["collective-permute"] == 0
    assert base["all-to-all"] == 0
    assert base["all-reduce"] > 0


def test_collective_count_pinned():
    """Absolute regression pin (generous): one EM iteration lowers to a
    handful of all-reduces — the psums of the E-step channel contractions
    (in the sweep loop body, counted once), the M/H sufficient statistics,
    and the six convergence norms.  A jump past the bound means a
    collective leaked into a per-segment or per-sweep-unrolled position."""
    c = _lowered_em_step((4, 2))
    assert 0 < c["all-reduce"] <= 40, c


def test_scan_block_adds_no_collectives():
    """k scanned EM iterations lower the SAME collective set as one step
    (the loop body is shared), so blocks don't multiply collective count
    in the module — per-iteration cost stays constant."""
    segments, params, G, config = _problem()
    mesh = make_mesh((4, 2))
    seg_s = shard_data(pad_segments(segments, 4), mesh)
    params_s, G_s = replicate((params, G), mesh)
    texts = []
    for k in (1, 3):
        em = sharded_em_scan(mesh, config, seg_s, params_s, k)
        texts.append(_counts(em.lower(seg_s, params_s, G_s, 0).as_text()))
    assert texts[0] == texts[1], texts
