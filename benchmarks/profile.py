"""Per-phase profiling of the headline step (SURVEY §5).

Two complementary tools:

1. ``--trace DIR`` wraps a short compiled rollout in
   ``jax.profiler.trace`` and dumps a TensorBoard/Perfetto trace. Every
   stepper phase is labeled with ``jax.named_scope`` annotations
   (kdk.kick1 / kdk.drift / kdk.forces / kdk.kick2 / collisions in
   engine/integrators.py; respa.pack / respa.near0 / respa.inner /
   respa.full_force / respa.unpack in engine/multirate.py), and the
   exact sweep's kernels are named ``pair_sweep*``, so the trace
   attributes device time to phases.

2. The default mode produces a per-phase table by differential timing
   with ``utils.timing.bench_chained``: whole step, force-eval-only,
   force-eval without the PE sum, and integration-only (kick/drift
   arithmetic with a frozen force) — the phase costs fall out as
   differences of chained-slope timings.

Run from the repo root on the GPU: ``python benchmarks/profile.py
[--n 65536] [--trace DIR]``.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=50,
                    help="rollout length under --trace")
    ap.add_argument("--trace", default=None,
                    help="dump a jax.profiler trace to this directory")
    args = ap.parse_args()

    import jax

    import orbital_tpu as ot
    from bench import make_cluster
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import init_forces, resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.runtime import require_gpu, setup_compile_cache
    from orbital_tpu.utils.timing import bench_chained

    require_gpu()
    setup_compile_cache()

    n = args.n
    pos, vel, mass, eps2 = make_cluster(n)
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2)
    state = init_forces(make_state(pos, vel, mass, precision="ds32"), cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n))

    if args.trace:
        roll = jax.jit(lambda s: jax.lax.fori_loop(
            0, args.steps, lambda _, x: step(x), s))
        roll(state).pos.block_until_ready()  # compile outside the trace
        with jax.profiler.trace(args.trace):
            out = roll(state)
            np.asarray(out.pos)  # a real fetch forces completion
        print(f"trace written to {args.trace} "
              "(open with TensorBoard's profile plugin)")
        return

    # differential phase table (all numbers chained-slope seconds/iter)
    import jax.numpy as jnp

    tiny = jnp.float32(1e-20)
    t_step = bench_chained(step, state, iters=4, iters_hi=10)

    force = resolve_force_fn(cfg, n)
    force_nope = resolve_force_fn(cfg.replace(track_potential=False), n)

    def force_only(p):
        a, _ = force(p, state.mass.astype(p.dtype), state.alive)
        return p + tiny * a

    t_force = bench_chained(force_only, state.pos, iters=4, iters_hi=10)

    def force_no_pe(p):
        a, _ = force_nope(p, state.mass.astype(p.dtype), state.alive)
        return p + tiny * a

    t_force_nope = bench_chained(force_no_pe, state.pos, iters=4,
                                 iters_hi=10)

    cfg_np = cfg.replace(track_potential=False)
    step_np = make_step_fn(cfg_np, resolve_force_fn(cfg_np, n))
    st_np = init_forces(make_state(pos, vel, mass, precision="ds32"),
                        cfg_np)
    t_step_nope = bench_chained(step_np, st_np, iters=4, iters_hi=10)

    table = {
        "n": n,
        "ms_step_total": round(1e3 * t_step, 3),
        "ms_force_eval": round(1e3 * t_force, 3),
        "ms_pe_sum": round(1e3 * (t_force - t_force_nope), 3),
        "ms_integration_and_overhead": round(1e3 * (t_step - t_force), 3),
        "ms_step_no_potential": round(1e3 * t_step_nope, 3),
        "note": ("phases by differential chained-slope timing; "
                 "named_scope trace labels available via --trace"),
    }
    print(json.dumps(table))


if __name__ == "__main__":
    main()
