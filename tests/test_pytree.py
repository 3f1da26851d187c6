"""The local dataclass pytree base (vlgp_tpu.pytree) that carries Params,
TrialSet and FactorModel, and that the package needs no flax."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vlgp_tpu.config import Params, make_params
from vlgp_tpu.data import TrialSet, pack_trials
from vlgp_tpu.init import FactorModel
from vlgp_tpu.pytree import PyTreeNode, static_field

REPO = Path(__file__).resolve().parent.parent


def test_params_flatten_unflatten_roundtrip():
    p = make_params(4, 2, rank=7, gp_noise=1e-3)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    # eight array leaves; active=None contributes none, statics are meta
    assert len(leaves) == 8
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, Params)
    assert (q.rank, q.gp_noise, q.likelihood_kind) == (7, 1e-3, "poisson")
    for x, y in zip(jax.tree_util.tree_leaves(q), leaves):
        assert x is y


def test_static_fields_are_static_under_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.rank)
        # a static field is a Python value inside the trace
        assert isinstance(p.rank, int)
        return p.a * p.rank

    p = make_params(3, 2, rank=5)
    np.testing.assert_array_equal(np.asarray(f(p)), np.zeros((2, 3)))
    f(p.replace(a=jnp.ones_like(p.a)))  # same statics: no retrace
    assert traces == [5]
    assert float(f(p.replace(rank=6, a=jnp.ones_like(p.a)))[0, 0]) == 6.0
    assert traces == [5, 6]  # a new static value retraces


def test_replace_returns_new_frozen_instance():
    p = make_params(3, 2)
    q = p.replace(omega=p.omega * 2, rank=9)
    assert q is not p and q.rank == 9 and p.rank == 50
    np.testing.assert_allclose(np.asarray(q.omega), 2 * np.asarray(p.omega))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.rank = 1
    with pytest.raises(TypeError):
        p.replace(not_a_field=1)


def test_trialset_and_factor_model_are_pytrees():
    data = pack_trials([{"y": np.ones((5, 3))}], zdim=2)
    assert len(jax.tree_util.tree_leaves(data)) == len(
        dataclasses.fields(TrialSet))
    doubled = jax.tree_util.tree_map(lambda x: x * 2, data)
    assert isinstance(doubled, TrialSet)
    np.testing.assert_array_equal(np.asarray(doubled.y), 2 * np.ones((1, 5, 3)))
    fm = FactorModel(mean=jnp.zeros(3), a=jnp.ones((2, 3)), psi=jnp.ones(3))
    out = jax.jit(lambda m: m.transform(jnp.ones((4, 3))))(fm)
    assert out.shape == (4, 2)


def test_static_field_subclass():
    class Box(PyTreeNode):
        x: jnp.ndarray
        tag: str = static_field(default="t")

    b = Box(x=jnp.arange(3.0))
    leaves, treedef = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 1
    assert jax.tree_util.tree_unflatten(treedef, leaves).tag == "t"
    assert b.replace(tag="u").tag == "u"


def test_import_without_flax():
    """The main path imports nothing beyond JAX, NumPy and the standard
    library: a process in which flax cannot be imported still imports the
    package and builds its pytrees."""
    script = (
        "import sys; sys.modules['flax'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np, vlgp_tpu\n"
        "from vlgp_tpu.config import make_params\n"
        "p = make_params(3, 2)\n"
        "print('ok', type(p).__mro__[1].__name__, 'flax' in str(type(p).__mro__))\n"
    )
    env = dict(os.environ)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ok PyTreeNode False" in proc.stdout
