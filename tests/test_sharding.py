"""Multi-device SPMD tests on the 8-device virtual CPU mesh.

Verifies that the shard_mapped EM step is numerically identical to the
single-device step, and that inference composes across mesh shapes
(pure dp, dp x tp).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vlgp_tpu.config import default_config, make_params
from vlgp_tpu.data import cut_trials, pack_trials
from vlgp_tpu.models.driver import make_em_step
from vlgp_tpu.models.gp import make_cholesky
from vlgp_tpu.models.vlgp import update_w
from vlgp_tpu.parallel.mesh import make_mesh, pad_segments, replicate, shard_data
from vlgp_tpu.parallel.spmd import sharded_em_step, sharded_infer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _problem(seed=0, ntrial=8, length=100, ydim=16, zdim=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(zdim, ydim)) * 0.5
    trials = []
    for _ in range(ntrial):
        z = np.column_stack(
            (np.sin(np.linspace(0, 6, length)), np.cos(np.linspace(0, 6, length)))
        )
        y = rng.poisson(np.exp(z @ a - 1.5)).astype(float)
        trials.append({"y": y, "mu": rng.normal(size=(length, zdim)) * 0.1})
    # estep_tol=0: the 1e-8 single-vs-multi-device equality contract
    # needs identical sweep counts (the adaptive exit decides on
    # psummed norms whose reduction order differs across shardings)
    config = default_config(dtype="float64", Eniter=3, Mniter=3, hyper_iters=10,
                            estep_tol=0, mstep_tol=0)
    params = make_params(ydim, zdim, 1, "poisson", a=a,
                         b=np.full((1, ydim), -1.5), omega=np.full(zdim, 1e-2),
                         dtype=jnp.float64)
    data = pack_trials(trials, zdim, 1, dtype=np.float64)
    segments = cut_trials(data, config.window, seed=0)
    G = make_cholesky(segments.nbin, params)
    segments = update_w(segments, params, config)
    return segments, params, G, config


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_em_step_matches_single_device(shape):
    segments, params, G, config = _problem()
    # single-device truth
    ref_step = jax.jit(make_em_step(config))
    d1, p1, G1, n1 = ref_step(segments, params, G)

    mesh = make_mesh(shape)
    seg_s = pad_segments(segments, shape[0])
    assert seg_s.ntrial % shape[0] == 0
    assert seg_s.ydim % shape[1] == 0
    seg_s = shard_data(seg_s, mesh)
    params_s, G_s = replicate((params, G), mesh)
    step = sharded_em_step(mesh, config, seg_s, params_s)
    # it=0: first EM iteration, so the hyper_interval cond takes the
    # H-step branch — matching the it=None single-device reference call
    d2, p2, G2, n2 = step(seg_s, params_s, G_s, 0)

    assert np.abs(np.asarray(p1.a) - np.asarray(p2.a)).max() < 1e-8
    assert np.abs(np.asarray(p1.b) - np.asarray(p2.b)).max() < 1e-8
    assert np.abs(np.asarray(p1.omega) - np.asarray(p2.omega)).max() < 1e-8
    n = segments.ntrial
    assert np.abs(np.asarray(d1.mu) - np.asarray(d2.mu)[:n]).max() < 1e-8
    assert np.abs(np.asarray(d1.w) - np.asarray(d2.w)[:n]).max() < 1e-8
    for k in n1:
        assert abs(float(n1[k]) - float(n2[k])) < 1e-6 * max(1.0, abs(float(n1[k])))


def test_sharded_infer_matches_single_device():
    segments, params, G, config = _problem()
    from vlgp_tpu.models.driver import infer

    d1 = infer(segments, params, G, config.replace(max_iter=4))
    mesh = make_mesh((4, 2))
    seg_s = shard_data(pad_segments(segments, 4), mesh)
    params_s, G_s = replicate((params, G), mesh)
    fn = sharded_infer(mesh, config.replace(max_iter=4), seg_s, params_s)
    d2 = fn(seg_s, params_s, G_s)
    n = segments.ntrial
    assert np.abs(np.asarray(d1.mu) - np.asarray(d2.mu)[:n]).max() < 1e-8


def test_masked_pad_segments_are_inert():
    segments, params, G, config = _problem()
    mesh = make_mesh((8, 1))
    # pad by a lot: results must not change vs minimal padding
    seg_a = shard_data(pad_segments(segments, 8), mesh)
    seg_b = shard_data(pad_segments(segments, 16), mesh)
    params_s, G_s = replicate((params, G), mesh)
    step_a = sharded_em_step(mesh, config, seg_a, params_s)
    step_b = sharded_em_step(mesh, config, seg_b, params_s)
    _, pa, _, _ = step_a(seg_a, params_s, G_s, 0)
    _, pb, _, _ = step_b(seg_b, params_s, G_s, 0)
    assert np.abs(np.asarray(pa.a) - np.asarray(pb.a)).max() < 1e-9
