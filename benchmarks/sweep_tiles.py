"""Time the exact-sweep Pallas kernel against the chunked XLA sweep on the GPU.

Prints one JSON line per (variant, N, tiles) with the median of ``--reps``
timed calls (each ended by ``block_until_ready``), the max relative error
of the kernel's accelerations against a float64 numpy reference on 256
sampled rows, and the card's name and power limit. Then one line per N
for a KDK step through ``rollout`` with ``force_impl="pallas"`` and
``"chunked"``. Needs a GPU:

    python benchmarks/sweep_tiles.py [--n 4096 65536 131072] [--reps 5]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, reps):
    import jax

    jax.block_until_ready(fn())            # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[4096, 65536, 131072])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiles", default="32,64,128:32,64:2,4,8",
                    help="TI list : TJ list : num_warps list")
    ap.add_argument("--kdk", action="store_true",
                    help="also time a KDK step with each sweep")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from orbital_tpu.ops import pallas_forces as pf
    from orbital_tpu.ops.forces import accel_jerk_chunked, pairwise_acc_chunked
    from orbital_tpu.utils.runtime import (card_info, require_gpu,
                                           setup_compile_cache)

    require_gpu()
    setup_compile_cache()
    card = card_info()
    tis, tjs, warps = ([int(v) for v in s.split(",")]
                       for s in args.tiles.split(":"))
    rng = np.random.default_rng(0)
    for n in args.n:
        pos_np = rng.normal(size=(n, 3)).astype(np.float32)
        vel_np = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
        m_np = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
        pos, vel, mass = (jnp.asarray(a) for a in (pos_np, vel_np, m_np))
        eps2 = 1e-4
        rows = rng.choice(n, 256, replace=False)
        d = pos_np[None, :, :].astype(np.float64) - pos_np[rows, None, :]
        r2 = (d ** 2).sum(-1) + eps2
        ref = (m_np[None, :, None] * d / r2[..., None] ** 1.5).sum(1)

        def err(a):
            a = np.asarray(a, np.float64)[rows]
            return float(np.max(np.linalg.norm(a - ref, axis=1)
                                / np.linalg.norm(ref, axis=1)))

        xla = {
            "acc_pe": lambda: pairwise_acc_chunked(pos, mass, G=1.0, eps2=eps2),
            "jerk": lambda: accel_jerk_chunked(pos, vel, mass, G=1.0,
                                               eps2=eps2),
        }
        for name, fn in xla.items():
            t = _timed(fn, args.reps)
            print(json.dumps({"impl": "xla_chunked", "variant": name, "n": n,
                              "median_s": t, "max_rel_err": err(fn()[0]),
                              "card": card}), flush=True)
        for ti, tj, w in itertools.product(tis, tjs, warps):
            for variant in ("acc", "jerk"):
                pf.DEFAULT_TILES[variant] = (ti, tj, w)
            pf._build_call.cache_clear()
            jax.clear_caches()
            kern = {
                "acc": lambda: pf.pairwise_acc_pallas(
                    pos, mass, G=1.0, eps2=eps2, with_potential=False),
                "acc_pe": lambda: pf.pairwise_acc_pallas(
                    pos, mass, G=1.0, eps2=eps2),
                "jerk": lambda: pf.accel_jerk_pallas(
                    pos, vel, mass, G=1.0, eps2=eps2),
            }
            for name, fn in kern.items():
                try:
                    t = _timed(fn, args.reps)
                    row = {"median_s": t, "max_rel_err": err(fn()[0])}
                except Exception as e:  # a tile the compiler refuses
                    row = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
                print(json.dumps({"impl": "pallas", "variant": name, "n": n,
                                  "tiles": [ti, tj, w], **row,
                                  "card": card}), flush=True)
        if args.kdk:
            _kdk_steps(pos, vel, mass, eps2, args.reps, card)


def _kdk_steps(pos, vel, mass, eps2, reps, card, steps=10):
    """Seconds per KDK step through the public rollout, both sweeps."""
    import jax

    import orbital_tpu as ot

    st = ot.make_state(pos, vel, mass, precision="f32")
    for impl in ("pallas", "chunked", "chunked", "pallas"):
        cfg = ot.SimConfig(dt=1e-3, eps2=eps2, force_impl=impl,
                           track_potential=False)
        st0 = ot.init_forces(st, cfg)
        t = _timed(lambda: ot.rollout_jit(st0, cfg, steps)[0].pos, reps)
        print(json.dumps({"impl": impl, "variant": "kdk_step",
                          "n": int(pos.shape[0]), "median_s": t / steps,
                          "card": card}), flush=True)
    jax.clear_caches()


if __name__ == "__main__":
    main()
