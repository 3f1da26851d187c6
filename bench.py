"""Benchmark: EM iterations/sec on the BASELINE.json flagship config.

Workload (BASELINE.md "Large-scale"): 100 trials x 1000 bins x 100 Poisson
neurons, 5 latents, default algorithmic budget (Eniter 25 / Mniter 25 /
rank 50 / window 50) -> 2000 training segments of 50 bins.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "iter/s", "vs_baseline": N}

vs_baseline is the speedup over the reference NumPy implementation's
per-EM-iteration wall clock on this host's CPU (measured once and cached
in BASELINE_MEASURED.json; the reference needs a scipy>=1.11 compat shim
for its removed `sym_pos` kwarg).
"""
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

import vlgp_tpu  # noqa: E402

NTRIAL, LENGTH, YDIM, ZDIM = 100, 1000, 100, 5
CACHE = ROOT / "BASELINE_MEASURED.json"


QUALITY_R2 = 0.95  # convergence threshold for the seconds_to_converged metric


def make_workload(dtype=np.float32):
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(ZDIM, YDIM)) * 0.3).astype(dtype)
    trials, zs = [], []
    for _ in range(NTRIAL):
        z = np.stack(
            [np.sin(np.linspace(0, 20 + 3 * i, LENGTH)) for i in range(ZDIM)], 1
        )
        y = rng.poisson(np.exp(z @ a - 2.0)).astype(dtype)
        trials.append(
            {"y": y, "mu": (rng.normal(size=(LENGTH, ZDIM)) * 0.1).astype(dtype)}
        )
        zs.append(z)
    return trials, a, np.concatenate(zs)


def _r2_aligned(mu, zt):
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    return float(1 - np.sum((X @ beta - zt) ** 2)
                 / np.sum((zt - zt.mean(0)) ** 2))


def bench_ours(trials, a, zt, iters=10):
    import jax
    import jax.numpy as jnp

    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import cut_trials, pack_trials, scatter_segments
    from vlgp_tpu.models.driver import _scan_em_jit
    from vlgp_tpu.models.gp import effective_rank, make_cholesky
    from vlgp_tpu.models.vlgp import update_w

    config = default_config()
    params = make_params(
        YDIM, ZDIM, 1, "poisson", a=a,
        b=np.full((1, YDIM), -2.0, np.float32), omega=np.full(ZDIM, 1e-2),
    )
    data = pack_trials(trials, ZDIM, 1)
    seg = cut_trials(data, config.window, seed=0)
    seg_rank = min(params.rank,
                   effective_rank(seg.nbin, config.omega_bound[1], 1.0))
    G = make_cholesky(seg.nbin, params, rank=seg_rank)
    seg = update_w(seg, params, config)
    # production driver shape: `iters` EM iterations scanned into one
    # device dispatch (api.fit(fused=True, block=k))
    em = _scan_em_jit(config, iters)

    # warmup/compile; the host readback waits for the device
    d, p, g, _ = em(seg, params, G)
    float(jnp.sum(p.a))

    def run(n):
        assert n == iters
        t0 = time.perf_counter()
        dd, pp, gg, norms = em(d, p, g)
        checksum = float(jnp.sum(pp.a)) + float(jnp.sum(dd.mu))
        assert np.isfinite(checksum)
        return (time.perf_counter() - t0) / n

    run(iters)  # second warmup (cache effects)
    per_iter = min(run(iters), run(iters))

    # ---- seconds_to_converged + quality (BASELINE.json's full metric) ----
    # restart from the initial state and run timed blocks until the
    # lstsq-aligned latent-recovery R^2 crosses QUALITY_R2.  Scoring runs
    # the full fit ending (scatter + full-length inference under the
    # current params, api.py:66-71) so the metric reflects what `fit`
    # would deliver if stopped at that iteration; the score probes are
    # untimed, but the one final inference that produces the converged
    # deliverable is counted.  (The reference-side measurement,
    # tools/ref_convergence.py, scores its raw trial posterior without a
    # final inference pass — a concession in ITS favor.)
    from vlgp_tpu.models.driver import _infer_jit, _jit_key
    from vlgp_tpu.models.vlgp import Dist, update_v

    dd, pp, gg = seg, params, G
    full = pack_trials(trials, ZDIM, 1)
    infer_fn = _infer_jit(_jit_key(config), config.max_iter, Dist())

    from vlgp_tpu.evaluation import elbo_terms

    def score(dd, pp):
        # scatter reads only mu/w/v from the segments (no y/x readback)
        scat = scatter_segments(full, dd)
        G_full = make_cholesky(full.nbin, pp)
        scat = update_w(scat, pp, config)
        scat = update_v(scat, pp, G_full, config)
        scat = infer_fn(scat, pp, G_full)
        mu = np.asarray(scat.mu).reshape(-1, ZDIM)
        # full-data ELBO at this point of the trajectory (BASELINE.json's
        # stated metric is wall-clock to ELBO convergence; recovery R^2 is
        # the quality gate) — untimed, like the R^2 probe
        elbo = elbo_terms(scat, pp, G_full)["elbo"]
        return _r2_aligned(mu, zt), elbo, scat

    total, it_count, r2 = 0.0, 0, float("nan")
    elbo_track = []
    while it_count < 80:
        t0 = time.perf_counter()
        dd, pp, gg, _ = em(dd, pp, gg)
        checksum = float(jnp.sum(dd.mu))
        assert np.isfinite(checksum)
        total += time.perf_counter() - t0
        it_count += iters
        r2, elbo, _ = score(dd, pp)
        elbo_track.append(elbo)
        if r2 >= QUALITY_R2:
            break
    # the deliverable includes one final inference: time it once
    t0 = time.perf_counter()
    _, elbo, scat = score(dd, pp)
    jax.block_until_ready(scat.mu)
    total += time.perf_counter() - t0
    return per_iter, total, it_count, r2, elbo_track


def bench_reference(trials):
    """One reference EM iteration (estep+mstep+hstep on segments), CPU."""
    sys.path.insert(0, str(ROOT / "tests"))
    from refshim import load_reference

    ref = load_reference()
    if ref is None:
        return None
    from vlgp.core import constrain_loading, estep, mstep, update_v, update_w
    from vlgp.gp import make_cholesky, optimize
    from vlgp.preprocess import fill_params, fill_trials, get_config, get_params
    from vlgp.util import cut_trials

    ref_trials = [
        {"y": np.asarray(t["y"], float), "mu": np.asarray(t["mu"], float),
         "x": np.ones((LENGTH, 1, YDIM))}
        for t in trials
    ]
    config = get_config()
    params = get_params(ref_trials, ZDIM, omega_bound=config["omega_bound"])
    rng = np.random.default_rng(0)
    params["a"] = rng.normal(size=(ZDIM, YDIM)) * 0.3
    params["b"] = np.full((1, YDIM), -2.0)
    fill_params(params)
    fill_trials(ref_trials)
    np.random.seed(0)
    splits = cut_trials(ref_trials, params, config)
    make_cholesky(splits, params, config)
    fill_trials(splits)
    update_w(splits, params, config)
    update_v(splits, params, config)

    t0 = time.perf_counter()
    constrain_loading(splits, params, config)
    estep(splits, params, config)
    mstep(splits, params, config)
    optimize(splits, params, config)
    return time.perf_counter() - t0


def bench_mesh(shapes, iters=5, out_path=None):
    """Sharded-EM scaling study over device meshes (VERDICT-r3 #4).

    For each ('data','model') mesh shape, time the shard_mapped k-step EM
    scan (the production multi-chip dispatch, parallel/spmd.py) and report
    EM it/s plus per-device segment-sweep throughput.  On a virtual CPU
    mesh (``--virtual-cpu``) wall-clock measures the host, not the
    interconnect, so only *relative* scaling is meaningful there.
    """
    import jax
    import jax.numpy as jnp

    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import cut_trials, pack_trials
    from vlgp_tpu.models.gp import effective_rank, make_cholesky
    from vlgp_tpu.models.vlgp import update_w
    from vlgp_tpu.parallel.mesh import (
        make_mesh, pad_channels, pad_segments, replicate, shard_data,
    )
    from vlgp_tpu.parallel.spmd import sharded_em_scan

    # scaled-down flagship: the virtual CPU mesh executes every "device"
    # on host cores, so the full 2000-segment workload would swamp the
    # signal with raw CPU time.  32x250x32x3 -> 160 window-50 segments.
    ntrial, length, ydim, zdim = 32, 250, 32, 3
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(zdim, ydim)) * 0.3).astype(np.float32)
    trials = []
    for _ in range(ntrial):
        z = np.stack(
            [np.sin(np.linspace(0, 8 + 3 * i, length)) for i in range(zdim)],
            1,
        )
        y = rng.poisson(np.exp(z @ a - 2.0)).astype(np.float32)
        trials.append(
            {"y": y, "mu": (rng.normal(size=(length, zdim)) * 0.1).astype(np.float32)}
        )

    config = default_config()
    params = make_params(
        ydim, zdim, 1, "poisson", a=a,
        b=np.full((1, ydim), -2.0, np.float32),
        omega=np.full(zdim, 1e-2),
    )
    data = pack_trials(trials, zdim, 1)
    seg = cut_trials(data, config.window, seed=0)
    seg_rank = min(params.rank,
                   effective_rank(seg.nbin, config.omega_bound[1], 1.0))
    G = make_cholesky(seg.nbin, params, rank=seg_rank)
    seg = update_w(seg, params, config)

    results = []
    for d_ax, m_ax in shapes:
        mesh = make_mesh((d_ax, m_ax), devices=jax.devices()[: d_ax * m_ax])
        seg_s = pad_segments(seg, d_ax)
        seg_s, params_s = (seg_s, params) if ydim % m_ax == 0 else \
            pad_channels(seg_s, params, m_ax)
        nseg = seg_s.ntrial
        seg_s = shard_data(seg_s, mesh)
        params_r, G_r = replicate((params_s, G), mesh)
        em = sharded_em_scan(mesh, config, seg_s, params_r, iters)
        dd, pp, gg, _ = em(seg_s, params_r, G_r, 0)  # compile+warm
        float(jnp.sum(pp.a))

        def run():
            # it0=0: every timed block sees the same H-step cadence as the
            # warm block and the single-chip headline bench (an odd it0
            # with hyper_interval=2 would time an H-light block and
            # overstate absolute throughput ~5-10%)
            t0 = time.perf_counter()
            d2, p2, g2, _ = em(dd, pp, gg, 0)
            assert np.isfinite(float(jnp.sum(p2.a)) + float(jnp.sum(d2.mu)))
            return (time.perf_counter() - t0) / iters

        run()
        per_iter = min(run(), run())
        ndev = d_ax * m_ax
        rec = {
            "mesh": [d_ax, m_ax],
            "devices": ndev,
            "platform": jax.devices()[0].platform,
            "segments": nseg,
            "em_iters_per_sec": round(1.0 / per_iter, 4),
            "segment_sweeps_per_sec_per_device": round(
                nseg / per_iter / ndev, 2
            ),
        }
        results.append(rec)
        print(json.dumps(rec))
    if out_path:
        base = results[0]["em_iters_per_sec"]
        note = None
        if results and results[0]["platform"] == "cpu":
            import os as _os

            note = (
                f"virtual CPU mesh on {_os.cpu_count()} host core(s): all "
                "'devices' time-share the host, so absolute it/s and "
                "speedup_vs_first measure the virtual mesh, NOT device "
                "scaling.  The collective-placement signal is that k-device "
                "meshes stay near the 1-device rate despite k-way "
                "time-slicing (total work is constant, collectives O(1) "
                "per iteration — see tests/test_collectives.py); on real "
                "multi-chip hardware the same dispatch path applies "
                "unchanged."
            )
        pathlib.Path(out_path).write_text(json.dumps({
            "workload": f"{ntrial}x{length}x{ydim}x{zdim}, window 50, "
                        f"block {iters}",
            "note": note,
            "results": results,
            "speedup_vs_first": [
                round(r["em_iters_per_sec"] / base, 3) for r in results
            ],
        }, indent=1))
    return results


def _mesh_main(argv):
    """`bench.py --mesh 1x1,4x1 [--mesh-out FILE] [--virtual-cpu]`: run the
    scaling study on the default devices; fails when there are too few,
    unless ``--virtual-cpu`` asks for a virtual CPU mesh explicitly."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True,
                    help="comma-separated DATAxMODEL shapes, e.g. 1x1,4x1")
    ap.add_argument("--mesh-out", default=None)
    ap.add_argument("--mesh-iters", type=int, default=5)
    ap.add_argument("--virtual-cpu", action="store_true",
                    help="run on that many virtual CPU devices")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.mesh.split(",")]
    need = max(d * m for d, m in shapes)

    if args.virtual_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", need)
    have = len(jax.devices())
    if have < need:
        raise SystemExit(
            f"--mesh needs {need} devices, {jax.devices()[0].platform} has "
            f"{have}; pass --virtual-cpu for a virtual CPU mesh"
        )
    bench_mesh(shapes, iters=args.mesh_iters, out_path=args.mesh_out)


def main():
    vlgp_tpu.enable_compilation_cache()
    trials, a, zt = make_workload()
    per_iter, sec_conv, it_conv, r2, elbo_track = bench_ours(trials, a, zt)
    value = 1.0 / per_iter

    cache = {}
    if CACHE.exists():
        try:
            cache = json.loads(CACHE.read_text())
        except Exception:
            cache = {}
    baseline = cache.get("ref_em_iter_seconds")
    if baseline is None:
        try:
            baseline = bench_reference(trials)
            if baseline is not None:
                cache.update(
                    ref_em_iter_seconds=baseline,
                    config=f"{NTRIAL}x{LENGTH}x{YDIM}, {ZDIM} latents, "
                           "window 50, Eniter/Mniter 25",
                )
                CACHE.write_text(json.dumps(cache))
        except Exception:
            baseline = None

    vs = (baseline / per_iter) if baseline else None
    out = {
        "metric": f"vem_em_iters_per_sec_{NTRIAL}x{LENGTH}x{YDIM}x{ZDIM}",
        "value": round(value, 4),
        "unit": "iter/s",
        "vs_baseline": round(vs, 2) if vs else None,
        # BASELINE.json's full driver metric: wall-clock to a fixed
        # recovery threshold, plus the quality number itself
        "seconds_to_converged": round(sec_conv, 3),
        "converged_iters": it_conv,
        "quality_r2": round(r2, 4),
        "quality_threshold": QUALITY_R2,
        # honest-flag: seconds_to_converged is the 80-iteration-cap time,
        # not a convergence time, whenever this is false (the reference
        # measurement records ref_converged the same way)
        "converged": bool(r2 >= QUALITY_R2),
        # ELBO view of the same trajectory (sampled at the scoring probes,
        # every `iters` EM iterations): final value and whether the last
        # probe-to-probe delta had stalled below 1e-4 relative
        "elbo_final": round(elbo_track[-1], 2) if elbo_track else None,
        "elbo_converged": bool(
            len(elbo_track) >= 2
            and abs(elbo_track[-1] - elbo_track[-2])
            <= 1e-4 * abs(elbo_track[-1])
        ),
    }
    # the reference's own convergence numbers on this workload, measured
    # once by tools/ref_convergence.py and cached
    for k in ("ref_seconds_to_converged", "ref_converged_iters",
              "ref_quality_r2"):
        if k in cache:
            out[k] = cache[k]
    print(json.dumps(out))


if __name__ == "__main__":
    if "--mesh" in sys.argv:
        vlgp_tpu.enable_compilation_cache()
        _mesh_main(sys.argv[1:])
    else:
        main()
