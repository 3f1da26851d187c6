"""H-step search contracts (models/gp.py:hstep, _golden_min, _aitken_accept).

The parabolic polish must reach the golden-24 fixed point with half the
shrinks, and the Aitken trust region must cap near-stationary jumps
without touching healthy contractions.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from vlgp_tpu.config import default_config, make_params
from vlgp_tpu.data import cut_trials, pack_trials
from vlgp_tpu.models import gp as gpmod
from vlgp_tpu.models.gp import make_cholesky
from vlgp_tpu.models.vlgp import estep, update_v, update_w


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(11)
    zdim, ydim, length, ntrial = 2, 14, 160, 5
    a = rng.normal(size=(zdim, ydim)) * 0.7
    trials = []
    for _ in range(ntrial):
        z = np.column_stack(
            (np.sin(np.linspace(0, 7, length)), np.cos(np.linspace(0, 9, length)))
        )
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.7)).astype(np.float32)})
    config = default_config(dtype="float32", window=40)
    params = make_params(ydim, zdim, 1, "poisson", a=a,
                         b=np.full((1, ydim), -1.7, np.float32),
                         omega=np.asarray([4e-3, 1.2e-2]), dtype=jnp.float32)
    data = pack_trials(trials, zdim, 1, dtype=np.float32)
    seg = cut_trials(data, config.window, seed=0)
    G = make_cholesky(seg.nbin, params)
    seg = update_w(seg, params, config)
    seg = update_v(seg, params, G, config)
    seg = estep(seg, params, G, config)
    return seg, params, G, config


def test_hstep_polish_matches_golden24_fixed_point(state):
    """hyper_iters=12 + parabolic polish must land on the same fixed point
    as the 24-shrink golden search (models/gp.py:_golden_min).

    Pinned at hyper_grid=0 / hyper_learn_sigma=False: the contract is
    about golden-bracket PRECISION, which is only well-posed on the
    continuous fixed-sigma path — with the grid + profiled-sigma
    defaults, the 12-vs-24 shrink difference perturbs the joint
    (omega, sigma) fixed point and near-tied basins legitimately resolve
    differently (this fixture deliberately initializes one latent sharp)."""
    seg, params, G, config = state
    base = config.replace(hyper_grid=0, hyper_learn_sigma=False)
    cfgs = (base, base.replace(hyper_iters=12, hyper_polish=True))
    oms = []
    for cfg in cfgs:
        p = params
        for _ in range(10):
            p = gpmod.hstep(seg, p, cfg, rank=G.shape[-1])
        oms.append(np.asarray(p.omega))
    err = np.abs(np.log(oms[0]) - np.log(oms[1])).max()
    assert err < 5e-2, (err, oms)


# ---------------------------------------------------------------------------
# Aitken acceptance trust region (unpolished hyper_refines<=2 mode)
# ---------------------------------------------------------------------------


def test_aitken_trust_region_caps_near_stationary_jump():
    """A contraction ratio near 1 must not teleport the iterate to the
    bound when trust > 0; with trust=0 the raw extrapolation is kept."""
    from vlgp_tpu.models.gp import _aitken_accept

    lo, hi = jnp.asarray(-7.6), jnp.asarray(-3.0)
    # crawling fixed point: d1 = -0.10, d2 = -0.099 (ratio 0.99) from -4.0
    x0, x1, x2 = jnp.asarray(-4.0), jnp.asarray(-4.10), jnp.asarray(-4.199)
    raw = _aitken_accept(x0, x1, x2, lo, hi, trust=0.0)
    capped = _aitken_accept(x0, x1, x2, lo, hi, trust=4.0)
    # raw Aitken jumps ~ d2*r/(1-r) ~ -9.8 -> clipped to lo (the collapse)
    assert float(raw) == pytest.approx(float(lo))
    # trust region: at most 4 steps ahead of x2, well inside the box
    assert float(capped) == pytest.approx(-4.199 - 4 * 0.099, abs=1e-6)
    assert float(capped) > float(lo) + 1.0


def test_aitken_trust_region_inactive_on_small_jumps():
    """Near convergence the extrapolation is within the cap and the trust
    region must not perturb it; non-contracting sequences keep x2."""
    from vlgp_tpu.models.gp import _aitken_accept

    lo, hi = jnp.asarray(-7.6), jnp.asarray(-3.0)
    # healthy contraction: ratio 0.5 -> jump = d2*r/(1-r) = 1*d2 < 4*|d2|
    x0, x1, x2 = jnp.asarray(-4.0), jnp.asarray(-4.2), jnp.asarray(-4.3)
    raw = _aitken_accept(x0, x1, x2, lo, hi, trust=0.0)
    capped = _aitken_accept(x0, x1, x2, lo, hi, trust=4.0)
    np.testing.assert_allclose(float(raw), float(capped), rtol=1e-12)
    # oscillating (non-contracting): acceptance falls back to x2 either way
    x0, x1, x2 = jnp.asarray(-4.0), jnp.asarray(-4.2), jnp.asarray(-4.1)
    assert float(_aitken_accept(x0, x1, x2, lo, hi, trust=4.0)) == pytest.approx(-4.1)
