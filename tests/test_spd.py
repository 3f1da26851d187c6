"""ops/spd tests: the exact batched inverse (Cholesky + triangular solve),
its wrappers' shapes, and the Gram route of inv_one_plus_gram against a
dense float64 oracle, in float32 (the card's dtype) and float64."""
import numpy as np
import jax.numpy as jnp
import pytest

from vlgp_tpu.ops.spd import (
    inv_one_plus_gram, inv_one_plus_psd, spd_inverse, spd_solve,
)


def _psd(batch, R, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=batch + (R, R // 2)).astype(np.float32)
    return jnp.asarray(np.einsum("...rk,...qk->...rq", G, G) * scale)


@pytest.mark.parametrize("scale", [0.3, 50.0, 1e3])
def test_inv_one_plus_psd_matches_inverse(scale):
    """Up to lambda_max ~4e4 (scale 1e3): the f32 relative error stays at
    eps_f32 * cond(I + A)."""
    A = _psd((4,), 16, scale, seed=7)
    M = np.asarray(A, np.float64) + np.eye(16)
    X_ref = np.linalg.inv(M)
    X = np.asarray(inv_one_plus_psd(A), np.float64)
    assert np.isfinite(X).all()
    cond = np.linalg.cond(M).max()
    assert np.abs(X - X_ref).max() / np.abs(X_ref).max() < 10 * 6e-8 * cond


def test_spd_inverse_matches_inverse():
    B = _psd((4,), 16, 0.5, seed=8) + jnp.eye(16)
    Xi = np.asarray(spd_inverse(B))
    assert np.abs(Xi - np.linalg.inv(np.asarray(B))).max() < 1e-4


def test_spd_solve():
    A = _psd((3,), 12, 0.5, seed=5) + jnp.eye(12)
    rng = np.random.default_rng(6)
    b = jnp.asarray(rng.normal(size=(3, 12)).astype(np.float32))
    x = np.asarray(spd_solve(A, b))
    ref = np.linalg.solve(np.asarray(A), np.asarray(b)[..., None])[..., 0]
    assert np.abs(x - ref).max() < 1e-4


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)])
def test_inv_one_plus_psd_batch_shapes(batch):
    """Any leading batch dims, including none."""
    A = _psd(batch, 10, 0.5, seed=9)
    X = inv_one_plus_psd(A)
    assert X.shape == batch + (10, 10)
    ref = np.linalg.inv(np.asarray(A, np.float64) + np.eye(10))
    assert np.abs(np.asarray(X) - ref).max() < 1e-5


# ---------------------------------------------------------------------------
# Gram route: X = (I + G'diag(w)G)^{-1} and v = diag(G X G') from the
# einsum-built Gram, against a float64 oracle.
# ---------------------------------------------------------------------------

DTYPES = ("float32", "float64")
TOL = {"float32": 1e-5, "float64": 1e-11}


def _gram_problem(Z=2, S=5, T=12, R=8, seed=11, scale=1.0, dtype="float32"):
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=(Z, T, R)) * 0.5).astype(dtype)
    w = (rng.uniform(size=(Z, S, T)) * scale).astype(dtype)
    return G, w


def _oracle(G, w):
    G64 = np.asarray(G, np.float64)
    w64 = np.asarray(w, np.float64)
    R = G64.shape[-1]
    X = np.linalg.inv(np.einsum("ztr,zst,ztq->zsrq", G64, w64, G64)
                      + np.eye(R))
    return X, np.einsum("ztr,zsrq,ztq->zst", G64, X, G64)


def _gram(G, w, **kw):
    return inv_one_plus_gram(jnp.asarray(G), jnp.asarray(w), **kw)


def _err(x, ref):
    return float(np.abs(np.asarray(x, np.float64) - ref).max())


def test_gram_route_equals_inverse_of_gram():
    """inv_one_plus_gram is inv_one_plus_psd of the einsum Gram."""
    G, w = _gram_problem(seed=12)
    X, v = _gram(G, w, want_v=True)
    A = jnp.einsum("ztr,zst,ztq->zsrq", G, w, G,
                   precision="highest")
    np.testing.assert_array_equal(np.asarray(X),
                                  np.asarray(inv_one_plus_psd(A)))
    X_ref, v_ref = _oracle(G, w)
    assert _err(X, X_ref) < 1e-5
    assert _err(v, v_ref) < 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_route_cold(dtype):
    G, w = _gram_problem(Z=3, S=6, T=20, R=10, seed=20, scale=2.0,
                         dtype=dtype)
    X_ref, _ = _oracle(G, w)
    X = _gram(G, w)
    assert X.dtype == jnp.dtype(dtype)
    assert _err(X, X_ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_route_want_v(dtype):
    G, w = _gram_problem(seed=21, dtype=dtype)
    X_ref, v_ref = _oracle(G, w)
    X, v = _gram(G, w, want_v=True)
    assert _err(X, X_ref) < TOL[dtype]
    assert _err(v, v_ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_route_odd_segment_count(dtype):
    """S and T prime: nothing is tiled or padded to a multiple."""
    G, w = _gram_problem(Z=2, S=7, T=13, R=5, seed=25, dtype=dtype)
    X_ref, v_ref = _oracle(G, w)
    X, v = _gram(G, w, want_v=True)
    assert X.shape == (2, 7, 5, 5) and v.shape == (2, 7, 13)
    assert _err(X, X_ref) < TOL[dtype]
    assert _err(v, v_ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_route_zero_masked_segments(dtype):
    """Ragged padding: an all-masked segment has w = 0, so X = I and
    v = diag(G G') exactly, and its neighbours are unaffected."""
    G, w = _gram_problem(Z=2, S=6, T=12, R=8, seed=26, dtype=dtype)
    w = w.copy()
    w[:, 2] = 0.0
    w[:, 4, 5:] = 0.0  # a short trial's tail
    X_ref, v_ref = _oracle(G, w)
    X, v = _gram(G, w, want_v=True)
    np.testing.assert_allclose(np.asarray(X)[:, 2],
                               np.broadcast_to(np.eye(8), (2, 8, 8)),
                               atol=1e-6)
    assert _err(X, X_ref) < TOL[dtype]
    assert _err(v, v_ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_route_rank50(dtype):
    """The default factor rank (50), beyond the window-segment rank."""
    G, w = _gram_problem(Z=2, S=4, T=60, R=50, seed=27, scale=0.5,
                         dtype=dtype)
    X_ref, v_ref = _oracle(G, w)
    X, v = _gram(G, w, want_v=True)
    assert _err(X, X_ref) < 10 * TOL[dtype]
    assert _err(v, v_ref) / np.abs(v_ref).max() < 10 * TOL[dtype]
