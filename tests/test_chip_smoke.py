"""chip_smoke.py and the entry points' device and cache handling.

On the CPU the smoke script must refuse at once; its check functions run
here at a small width (the card runs them at flagship width).  Tests
marked ``gpu`` wrap the card phases (b) and (c) and skip without a GPU.
"""
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

import chip_smoke  # noqa: E402
import vlgp_tpu  # noqa: E402
from vlgp_tpu.config import default_config  # noqa: E402


def _run(args, cwd=REPO, **env_updates):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="",
               PYTHONPATH=str(REPO))
    env.update(env_updates)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


# ---- no hidden device ----------------------------------------------------

def test_chip_smoke_refuses_cpu_before_work():
    t0 = time.perf_counter()
    proc = _run([str(REPO / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr
    assert time.perf_counter() - t0 < 120  # refused before any flagship work


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_mesh_refuses_too_few_devices():
    proc = _run([str(REPO / "bench.py"), "--mesh", "1x1,2x1"])
    assert proc.returncode != 0
    assert "needs 2 devices" in (proc.stdout + proc.stderr)
    assert "--virtual-cpu" in (proc.stdout + proc.stderr)


def test_multichip_example_refuses_too_few_devices():
    proc = _run([str(REPO / "examples" / "multichip.py"), "--data", "2",
                 "--model", "1"])
    assert proc.returncode != 0
    assert "need 2 devices" in (proc.stdout + proc.stderr)


# ---- compile cache placement ---------------------------------------------

def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert vlgp_tpu.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_repo_path(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)  # independent of the working directory
    assert vlgp_tpu.compilation_cache_dir() == str(REPO / ".jax_cache")


@pytest.mark.parametrize("env_dir", [True, False])
def test_enable_compilation_cache_sets_that_dir(env_dir, tmp_path):
    script = ("import vlgp_tpu, jax; d = vlgp_tpu.enable_compilation_cache();"
              " print(d); print(jax.config.jax_compilation_cache_dir)")
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    if not env_dir:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    proc = _run(["-c", script], cwd=tmp_path, **env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = str(tmp_path) if env_dir else str(REPO / ".jax_cache")
    assert proc.stdout.split() == [want, want]


# ---- the smoke checks at a small width on the CPU -------------------------

def _small_state(config):
    trials, a, _ = _small_trials()
    return chip_smoke.segment_state(trials, a, config)


def _small_trials():
    rng = np.random.default_rng(0)
    zdim, ydim, length = 3, 20, 150
    a = (rng.normal(size=(zdim, ydim)) * 0.3).astype(np.float32)
    z = np.stack([np.sin(np.linspace(0, 6 + 2 * i, length))
                  for i in range(zdim)], 1)
    trials = [{"y": rng.poisson(np.exp(z @ a - 1.0)).astype(np.float32),
               "mu": (rng.normal(size=(length, zdim)) * 0.1).astype(np.float32)}
              for _ in range(4)]
    return trials, a, np.concatenate([z] * len(trials))


def test_woodbury_parity_check_on_cpu():
    config = default_config()
    seg, params, G = _small_state(config)
    w = np.moveaxis(np.asarray(seg.w), -1, 0) * np.asarray(seg.mask)[None]
    res = chip_smoke.woodbury_parity(G, w, jax.devices("cpu")[0])
    assert res["finite"]
    assert res["resid"] <= chip_smoke.TOL_RESID
    assert res["v_rel"] <= chip_smoke.TOL_V_REL


def test_hstep_and_nystrom_checks_on_cpu():
    config = default_config()
    seg, params, G = _small_state(config)
    cpu = jax.devices("cpu")[0]
    hs = chip_smoke.hstep_parity(np.asarray(seg.w)[..., 0],
                                 np.asarray(seg.mu)[..., 0], cpu,
                                 config.omega_bound)
    assert hs["postcov_rel"] <= chip_smoke.TOL_POSTCOV_REL
    assert hs["elbo_rel"] <= chip_smoke.TOL_ELBO_REL
    assert hs["objective_rel"] <= chip_smoke.TOL_HOBJ_REL
    ny = chip_smoke.nystrom_check(cpu, config, G.shape[-1], seg.nbin, n=16)
    assert ny["nonfinite"] == 0 and ny["max_recon_err"] < 1e-2


def test_hstep_objective_check_sees_a_wrong_objective(monkeypatch):
    """The objective check compares against its own float64 oracle: a
    device objective off by 5% must read as such."""
    config = default_config()
    seg, params, G = _small_state(config)
    real = chip_smoke.gp_elbo_stats

    def off(*args, **kw):
        ll, s = real(*args, **kw)
        return ll * 1.05, s

    monkeypatch.setattr(chip_smoke, "gp_elbo_stats", off)
    hs = chip_smoke.hstep_parity(np.asarray(seg.w)[..., 0],
                                 np.asarray(seg.mu)[..., 0],
                                 jax.devices("cpu")[0], config.omega_bound)
    assert hs["objective_rel"] > chip_smoke.TOL_HOBJ_REL


def test_em_iteration_check_is_deterministic_on_cpu():
    config = default_config()
    seg, params, G = _small_state(config)
    cpu = jax.devices("cpu")[0]
    first = chip_smoke.em_iteration(seg, params, G, config, cpu)
    again = chip_smoke.em_iteration(seg, params, G, config, cpu)
    for k in chip_smoke.TOL_EM_REL:
        assert np.isfinite(first[k]).all()
        assert chip_smoke.rel(again[k], first[k]) == 0.0


def test_estep_compile_reports_cold_and_cached(capsys, tmp_path):
    config = default_config()
    seg, params, G = _small_state(config)
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    try:
        chip_smoke.estep_compile(seg, params, G, config, "cpu")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("(d)")][-1]
    assert '"cold"' in line and '"warm_cache"' in line
    assert "temp_size_in_bytes" in line


def test_cache_off_neither_reads_nor_writes_the_cache(tmp_path):
    """JAX decides once per process whether to use the persistent cache;
    cache_off must still keep a compile away from it, and leave it in use
    afterwards."""
    import jax.numpy as jnp

    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    chip_smoke.compilation_cache.reset_cache()
    try:
        jax.jit(lambda x: x * 2.0 + 1.0)(jnp.ones(3))  # the cache is in use
        n0 = len(list(tmp_path.rglob("*")))
        assert n0 > 0
        with chip_smoke.cache_off():
            jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(5))
        assert len(list(tmp_path.rglob("*"))) == n0
        jax.jit(lambda x: jnp.cos(x) - 4.0)(jnp.ones(7))
        assert len(list(tmp_path.rglob("*"))) > n0
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])
        chip_smoke.compilation_cache.reset_cache()


def test_phase_fit_finds_the_gate_iteration(monkeypatch):
    """Phase (d) scores R^2 after every EM iteration and refits to the
    first that reaches the gate.  (One iteration: every fit here shares
    one set of executables.)"""
    trials, a, zt = _small_trials()
    first = []
    real_fit = chip_smoke.vlgp_tpu.fit

    def spy(*args, **kw):
        res = real_fit(*args, **kw)
        first.append(kw["max_iter"])
        return res

    monkeypatch.setattr(chip_smoke.vlgp_tpu, "fit", spy)
    monkeypatch.setattr(chip_smoke, "QUALITY_R2", 0.3)
    monkeypatch.setattr(chip_smoke, "MAX_ITER", 1)
    res = chip_smoke.phase_fit(trials, a, zt, jax.devices("cpu")[0], "cpu")
    assert first == [1, 1, 1] and res.runtime["it"] == 1


def test_phase_fit_fails_below_the_gate(monkeypatch):
    trials, a, zt = _small_trials()
    monkeypatch.setattr(chip_smoke, "QUALITY_R2", 1.01)
    monkeypatch.setattr(chip_smoke, "MAX_ITER", 1)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_fit(trials, a, zt, jax.devices("cpu")[0], "cpu")
    assert exc.value.code == 1


@pytest.mark.parametrize("on_device_0", [False, True])
def test_placement_check(on_device_0):
    """Every card must hold its own 1/n_data rows and 1/n_model channels."""
    devs = jax.devices("cpu")[:4]
    ids = [0, 0, 0, 0] if on_device_0 else [0, 1, 2, 3]
    placement = {"mu": [(i, (10, 50, 3)) for i in ids],
                 "y": [(i, (10, 50, 20)) for i in ids], "rows": 20}
    if on_device_0:
        with pytest.raises(SystemExit):
            chip_smoke._check_placement(placement, (2, 2), devs, 40)
    else:
        chip_smoke._check_placement(placement, (2, 2), devs, 40)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_placement_recorder_reads_the_shards(shape):
    """Phase (f)'s callback records each device's shard of mu and y, as
    fit_sharded lays them out on four of the suite's virtual devices."""
    import types

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlgp_tpu.parallel.mesh import make_mesh

    devs = jax.devices("cpu")[:4]
    mesh = make_mesh(shape, devices=devs)
    mu = jax.device_put(jnp.zeros((8, 5, 3)), NamedSharding(mesh, P("data")))
    y = jax.device_put(jnp.zeros((8, 5, 6)),
                       NamedSharding(mesh, P("data", None, "model")))
    placement, record = chip_smoke._placement_recorder()
    record(types.SimpleNamespace(mu=mu, y=y), None, None)
    record(None, None, None)  # records once
    assert sorted(d for d, _ in placement["mu"]) == [0, 1, 2, 3]
    assert placement["rows"] == 8
    chip_smoke._check_placement(placement, shape, devs, 6)


# ---- the card phases (skip without a GPU) ---------------------------------

@pytest.fixture
def flagship(gpu_device):
    import bench

    config = default_config()
    trials, a, _ = bench.make_workload()
    return (*chip_smoke.segment_state(trials, a, config), config, gpu_device)


@pytest.mark.gpu
def test_gpu_woodbury_and_hstep_parity(flagship):
    seg, params, G, config, dev = flagship
    chip_smoke.phase_woodbury(seg, params, G, config, dev)


@pytest.mark.gpu
def test_gpu_em_iteration_matches_cpu(flagship):
    seg, params, G, config, dev = flagship
    chip_smoke.phase_em_vs_cpu(seg, params, G, config, dev)
