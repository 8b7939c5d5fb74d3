"""Benchmark CLI: reproduce the BASELINE table and measure the engine.

Examples:
    python -m benchmarks.run --config cluster --n 65536 --steps 200
    python -m benchmarks.run --config cluster --n 4096 --drift-steps 10000
    python -m benchmarks.run --config solar26 --steps 5000
    python -m benchmarks.run --config sun_earth_moon --steps 10000
    python -m benchmarks.run --config ensemble --n 32 --ensemble 1024
    python -m benchmarks.run --config cluster --n 8192 --profile /tmp/trace

Each invocation prints one JSON line: {config, n, body_steps_per_s,
ms_per_step, energy_drift, ...}. The reference's measured numbers are in
BASELINE.md (e.g. ~2.7 body-steps/s extrapolated at N=65536).
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np


def cluster_state(n: int, precision: str, seed: int = 0):
    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    from bench import make_cluster  # reuse the virialized IC

    pos, vel, mass, eps2 = make_cluster(n, seed)
    state = make_state(pos, vel, mass, precision=precision)
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2)
    return state, cfg


def scene_state(preset: str, precision: str):
    """Physical presets: sun_earth_moon / lagrange3 / solar26."""
    import orbital_tpu as ot
    from orbital_tpu.engine.state import Rescale, make_state
    from orbital_tpu.models.datasets import solar_system_v2
    from orbital_tpu.models.scene import compile_system

    G = ot.STANDARD.G
    if preset == "solar26":
        scene = compile_system(solar_system_v2(moons=True), compose_parents=True)
        pos, vel, mass, radius = scene.pos, scene.vel, scene.mass, scene.radius
        dt, eps = 1800.0, 1e6
    elif preset == "sun_earth_moon":
        from tests.test_golden_vs_reference import _sun_earth_moon_ic

        pos, vel, mass, radius = _sun_earth_moon_ic()
        dt, eps = 3600.0, 1e3
    elif preset == "lagrange3":
        m, R = 1e22, 1e7
        pos = np.array([[R, 0, 0], [-R / 2, math.sqrt(3) / 2 * R, 0],
                        [-R / 2, -math.sqrt(3) / 2 * R, 0]])
        z = np.array([0.0, 0.0, 1.0])
        v = math.sqrt(G * m / (math.sqrt(3) * R))
        vel = np.stack([v * np.cross(z, p / np.linalg.norm(p)) for p in pos])
        mass = np.full(3, m)
        radius = np.full(3, (m / 5000.0) ** (1 / 3))
        dt, eps = 50.0, 1e3
    else:
        raise ValueError(preset)

    rescale = Rescale.identity() if precision == "f64" else Rescale.natural(pos, mass, G)
    state = make_state(pos, vel, mass, radius, precision=precision, rescale=rescale)
    cfg = __import__("orbital_tpu").SimConfig(
        dt=dt / rescale.time, G=rescale.g_internal(G),
        eps2=(eps / rescale.length) ** 2,
    )
    return state, cfg


def measure(state, cfg, steps: int, drift_steps: int, iters: int):
    import jax

    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_accel_jerk_fn, resolve_force_fn
    from orbital_tpu.utils.timing import bench_chained

    from bench import energy_hybrid

    n = state.n_bodies
    state = ot.init_forces(state, cfg)
    aj = resolve_accel_jerk_fn(cfg, n) if cfg.integrator == "hermite" else None
    step = make_step_fn(cfg, resolve_force_fn(cfg, n), accel_jerk_fn=aj)
    sec = bench_chained(step, state, iters=iters, iters_hi=3 * iters)

    drift = None
    if drift_steps:
        E0 = energy_hybrid(state, cfg.eps2)
        final = state
        done = 0
        while done < drift_steps:
            chunk = min(500 if n > 16384 else drift_steps, drift_steps - done)
            final, _ = ot.rollout_jit(final, cfg, chunk)
            float(final.time)
            done += chunk
        drift = abs((energy_hybrid(final, cfg.eps2) - E0) / E0)
    return dict(n=n, ms_per_step=sec * 1e3, body_steps_per_s=n / sec,
                energy_drift=drift, drift_steps=drift_steps)


def measure_ensemble(n: int, n_ens: int, steps: int, precision: str):
    import jax

    import orbital_tpu as ot
    from orbital_tpu.parallel.ensemble import energy_drift, ensemble_rollout, make_ensemble

    state, cfg = cluster_state(n, precision)
    states = make_ensemble(state, n_ens, jax.random.key(0), pos_sigma=1e-5)
    # warm
    finals, trajs = ensemble_rollout(states, cfg, steps, record_every=steps)
    float(np.asarray(finals.time)[0])
    t0 = time.perf_counter()
    finals, trajs = ensemble_rollout(states, cfg, steps, record_every=steps)
    float(np.asarray(finals.time)[0])
    dt_wall = time.perf_counter() - t0
    rate = n_ens * n * steps / dt_wall
    return dict(n=n, ensemble=n_ens, steps=steps,
                body_steps_per_s=rate, ms_per_ensemble_step=dt_wall / steps * 1e3,
                max_member_drift=float(np.max(energy_drift(trajs))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="cluster",
                    choices=["cluster", "solar26", "sun_earth_moon", "lagrange3",
                             "ensemble"])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--drift-steps", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ensemble", type=int, default=1024)
    ap.add_argument("--precision", default="ds32", choices=["f32", "ds32", "f64"])
    ap.add_argument("--integrator", default="kdk",
                    choices=["kdk", "euler", "rk4", "hermite", "yoshida4"])
    ap.add_argument("--force-impl", default="auto",
                    choices=["auto", "dense", "chunked", "pallas", "mxu",
                             "pm"])
    ap.add_argument("--pm-grid", type=int, default=64)
    ap.add_argument("--profile", default=None, help="jax.profiler trace dir")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force a jax backend (cpu keeps tiny configs off "
                         "the card)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    if args.profile:
        jax.profiler.start_trace(args.profile)

    if args.config == "ensemble":
        out = measure_ensemble(args.n, args.ensemble, args.steps, args.precision)
    else:
        if args.config == "cluster":
            state, cfg = cluster_state(args.n, args.precision)
        else:
            state, cfg = scene_state(args.config, args.precision)
        cfg = cfg.replace(integrator=args.integrator,
                          force_impl=args.force_impl, pm_grid=args.pm_grid)
        out = measure(state, cfg, args.steps, args.drift_steps, args.iters)

    if args.profile:
        jax.profiler.stop_trace()

    out.update(config=args.config, precision=args.precision,
               integrator=getattr(args, "integrator", "kdk"),
               force_impl=getattr(args, "force_impl", "auto"),
               backend=jax.default_backend())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
