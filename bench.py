"""Headline benchmark: body-steps/s/chip for the leapfrog KDK stepper.

Needs a GPU (it exits non-zero without one) and prints one JSON line on
stdout, this run's own numbers only:
  {"metric": "body-steps/s/chip @ N=65536 ...", "value": ..., "unit":
   "body-steps/s", "vs_baseline": ..., "device": {...}, "extras": {...}}
``device`` carries the platform, device kind and count as JAX reports
them, and the card's name and power limit from ``nvidia-smi``. A rung that
fails records ``<rung>_error`` in ``extras``; if the headline itself fails
the script exits non-zero.

Baseline: the reference's pure-Python engine measured on a CPU
extrapolates to ~2.7 body-steps/s at N=65536 (BASELINE.md); ~44 at N=4096.

Configs (BASELINE.json 3-4): random virialized cluster in natural units
(G=1), softened O(N^2) exact sweep (the Pallas GPU kernel through
``force_impl="auto"``), ds32 state. Timing uses dependency-chained loops
with slope extraction (``orbital_tpu.utils.timing``).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_65K = 2.7     # body-steps/s, reference extrapolation at N=65536
BASELINE_4K = 44.0     # body-steps/s, reference extrapolation at N=4096

def device_potential(pos32, mass32, eps2: float) -> float:
    """Softened pairwise potential via the resolved exact sweep
    (``force_impl="auto"``; float32 sums)."""
    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import resolve_force_fn

    n = pos32.shape[0]
    cfg = ot.SimConfig(dt=1.0, G=1.0, eps2=eps2, chunk=min(1024, n))
    _, U = resolve_force_fn(cfg, n)(pos32, mass32, None)
    return float(U)


def energy_oracle() -> str:
    """Which potential the energies below come from."""
    from orbital_tpu.utils import native

    return "native_f64" if native.HAVE_NATIVE else "device_exact_sweep_f32"


def make_cluster(n: int, seed: int = 0):
    """Virialized Plummer-like cluster, natural units (G = 1, M = 1)."""
    import jax.numpy as jnp

    from orbital_tpu.utils import native

    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    eps2 = 1e-4
    if native.HAVE_NATIVE:
        U = native.potential_f64(pos, mass, eps2)
    else:
        U = device_potential(jnp.asarray(pos, jnp.float32),
                             jnp.asarray(mass, jnp.float32), eps2)
    K = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    vel *= np.sqrt(0.5 * abs(U) / K)
    return pos, vel, mass, eps2


def energy_hybrid(state, eps2: float) -> float:
    """Energy in f64 from the ds32 state: kinetic on host, potential via
    the native C++ oracle when built (exact f64), else the f32 device
    sweep (~1e-7 relative noise floor); :func:`energy_oracle` says
    which."""
    import jax.numpy as jnp

    from orbital_tpu.utils import native

    vel = np.asarray(state.vel, np.float64)
    pos = np.asarray(state.pos, np.float64)
    if state.vel_lo is not None:
        vel = vel + np.asarray(state.vel_lo, np.float64)
        pos = pos + np.asarray(state.pos_lo, np.float64)
    mass = np.asarray(state.mass, np.float64)
    K = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    if native.HAVE_NATIVE:
        U = native.potential_f64(pos, mass, eps2)
    else:
        U = device_potential(state.pos, state.mass.astype(jnp.float32), eps2)
    return K + U


def _rate_with_collision_mode(n: int, iters: int, **coll_kw) -> float:
    """Step rate with a collision mode armed: detection is fused into the
    force sweep (+~4 flops/pair, every step) and the O(N^2) resolution
    pass is lax.cond-executed only on steps where something actually
    touches (none in this IC; semantics are identical to the always-sweep
    path because a contact-free pass is a no-op)."""
    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import (resolve_force_detect_fn,
                                            resolve_force_fn)
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.timing import bench_chained

    pos, vel, mass, eps2 = make_cluster(n)
    state = make_state(pos, vel, mass, np.full(n, 1e-4), precision="ds32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="auto",
                       **coll_kw)
    state = ot.init_forces(state, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n),
                        force_detect_fn=resolve_force_detect_fn(cfg, n))
    sec = bench_chained(step, state, iters=iters, iters_hi=3 * iters)
    return n / sec


def bench_rate_with_collisions(n: int, iters: int = 4) -> float:
    """Bounce-mode step rate — the like-for-like comparison against the
    reference, whose measured numbers include its own per-step O(N^2)
    collision scan."""
    return _rate_with_collision_mode(n, iters, collisions="bounce",
                                     restitution=1.0)


def bench_rate_with_resolve(n: int, iters: int = 4) -> float:
    """Step rate with the absorb/fragment/bounce OUTCOME model armed
    (collisions='resolve'; ops.collisions.resolve_outcomes_subset above
    the dense ceiling) — the standing cost of having the debris model ON
    at the headline scale."""
    return _rate_with_collision_mode(n, iters, collisions="resolve",
                                     frag_seed=11, debris_k=2)


def bench_config(n: int, drift_steps: int, iters: int,
                 track_potential: bool = True):
    import jax

    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.timing import bench_chained

    pos, vel, mass, eps2 = make_cluster(n)
    state = make_state(pos, vel, mass, precision="ds32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="auto",
                       track_potential=track_potential)
    state = ot.init_forces(state, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n))

    sec_per_step = bench_chained(step, state, iters=iters, iters_hi=3 * iters)
    rate = n / sec_per_step
    if drift_steps <= 0:
        return rate, sec_per_step, None

    E0 = energy_hybrid(state, eps2)
    final, _ = ot.rollout_jit(state, cfg, drift_steps)
    E1 = energy_hybrid(final, eps2)
    drift = abs((E1 - E0) / E0)
    return rate, sec_per_step, drift


def bench_hermite(n: int, iters: int = 2) -> float:
    """Hermite (acc+jerk exact sweep) step rate at the flagship N."""
    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import (resolve_accel_jerk_fn,
                                            resolve_force_fn)
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.timing import bench_chained

    pos, vel, mass, eps2 = make_cluster(n)
    state = make_state(pos, vel, mass, precision="ds32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, integrator="hermite")
    state = ot.init_forces(state, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n),
                        accel_jerk_fn=resolve_accel_jerk_fn(cfg, n))
    sec = bench_chained(step, state, iters=iters, iters_hi=3 * iters)
    return n / sec


def bench_respa(n: int = 65536, k: int = 16, drift_steps: int = 10000,
                headroom: float = 2.2, refresh: int = 1,
                w_headroom: float = None):
    """Multirate (RESPA) stepper at the headline config: one exact O(N^2)
    evaluation per ``k`` leapfrog substeps, the switched XLA near sweep
    every substep (engine/multirate.py). Rate counts SUBSTEPS
    (each is a real KDK step at the headline dt); drift runs the same
    10k-step/f64-energy protocol as bench_config. Returns
    ``(body_steps_per_s, drift, overflow, skin_violation)`` — nonzero
    counters disqualify the run from headline promotion."""
    import orbital_tpu as ot
    from orbital_tpu.engine.multirate import (make_respa_macro,
                                              respa_rollout_dyn)
    from orbital_tpu.engine.rollout import init_forces, resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.ops.neighbor import neighbor_budgets
    from orbital_tpu.utils.timing import bench_chained

    pos, vel, mass, eps2 = make_cluster(n)
    rc = 5.0 * float(np.sqrt(eps2))
    cell = 2.0 * rc
    m_grid, k_ch, w_blk = neighbor_budgets(pos, cell=cell, chunk=32, rj=4,
                                           headroom=headroom,
                                           w_headroom=w_headroom)
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, integrator="respa",
                       respa_k=k, respa_rc=rc, respa_cell=cell,
                       respa_m=m_grid, respa_max_chunks=k_ch,
                       respa_w_blk=w_blk, respa_refresh=refresh)
    state = init_forces(make_state(pos, vel, mass, precision="ds32"), cfg)
    macro = make_respa_macro(cfg, resolve_force_fn(cfg, state.n_bodies))
    sec = bench_chained(lambda s: macro(s)[0], state, iters=2, iters_hi=5,
                        repeats=2)
    rate = n * k / sec
    drift = None
    ovf = skin = 0
    if drift_steps:
        E0 = energy_hybrid(state, eps2)
        chunk_m = max(1, int(20.0 / max(sec, 1e-3)))
        final, done = state, 0
        while done < drift_steps:
            n_m = min(chunk_m, -(-(drift_steps - done) // k))
            final, d = respa_rollout_dyn(final, cfg, n_m)
            float(final.time)
            ovf = max(ovf, int(d["overflow"]))
            skin = max(skin, int(d["skin_violation"]))
            done += n_m * k
        drift = abs((energy_hybrid(final, eps2) - E0) / E0)
    return rate, drift, ovf, skin


def bench_pm(n: int, grid: int = 128, iters: int = 3) -> float:
    """Particle-mesh KDK step rate beyond the exact sweep's ceiling
    (capability extension; collisionless accuracy contract, ops/pm.py)."""
    import jax.numpy as jnp

    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.timing import bench_chained

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(n, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    state = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=0.01, force_impl="pm",
                       pm_grid=grid, track_potential=False)
    state = ot.init_forces(state, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n))
    sec = bench_chained(step, state, iters=iters, iters_hi=3 * iters)
    return n / sec


def make_plummer(n: int, seed: int = 0):
    """Concentrated Plummer sphere positions/velocities (tree regime)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = r[:, None] * v
    vel = 0.05 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    return pos, vel, mass


def tree_cfg_probed(pos, levels: int, **kw):
    """Probe-size ALL the tree's static budgets from the distribution
    (capacity, occupied cells/columns, and the big/frontier class lists —
    the K//8 / K//4 heuristics are heavily sentinel-padded on concentrated
    systems). ``tree_near="columns"`` probes at column
    granularity via tree_column_probe."""
    import jax.numpy as jnp

    import orbital_tpu as ot
    from orbital_tpu.ops.tree import tree_class_probe, tree_column_probe

    ws = kw.pop("tree_ws", 1)
    near = kw.pop("tree_near", "cells")
    chunk = kw.pop("tree_chunk", 32)
    pbox = kw.get("pm_box")
    if pbox is not None:
        # probe with the SAME pinned cube the config will bin with
        pbox = (jnp.asarray(np.asarray(pbox[:3], np.float32)),
                jnp.float32(pbox[3]))
    if near == "pairs":
        from orbital_tpu.ops.tree import tree_pairs_budgets

        kch, entries = tree_pairs_budgets(
            jnp.asarray(pos, jnp.float32), levels=levels, ws=ws,
            chunk=chunk, box=pbox)
        return ot.SimConfig(
            force_impl="tree", tree_levels=levels, tree_ws=ws,
            tree_near="pairs", tree_chunk=chunk, tree_max_chunks=kch,
            tree_pair_entries=entries, **kw)
    nchunks = 0
    if near == "columns":
        cap, occ, nbig, nfront, nchunks = tree_column_probe(
            jnp.asarray(pos, jnp.float32), levels=levels, ws=ws, box=pbox,
            with_chunks=True)
    else:
        cap, occ, nbig, nfront = tree_class_probe(
            jnp.asarray(pos, jnp.float32), levels=levels, ws=ws, box=pbox)
    kcells = int(np.ceil((int(occ) * 1.3) / 512) * 512)
    return ot.SimConfig(
        force_impl="tree", tree_levels=levels, tree_ws=ws, tree_near=near,
        tree_capacity=int(np.ceil((int(cap) + 8) / 16) * 16),
        tree_max_cells=kcells,
        tree_max_big=min(kcells, max(256, int(np.ceil(int(nbig) * 1.3 / 256) * 256))),
        tree_max_frontier=min(kcells, max(256, int(np.ceil(int(nfront) * 1.3 / 256) * 256))),
        tree_max_chunks=max(256, int(np.ceil(int(nchunks) * 1.3 / 256) * 256)),
        **kw)


def _tree_kw_from_cfg(cfg):
    """tree_acc_potential kwargs from a probed SimConfig (any near mode) —
    the FULL force the config describes (G, order, pinned box included),
    so staged benchmarks measure exactly the configured evaluation."""
    kw = dict(G_grav=cfg.G, eps2=cfg.eps2, levels=cfg.tree_levels,
              ws=cfg.tree_ws, order=cfg.tree_order, near=cfg.tree_near,
              max_chunks=cfg.tree_max_chunks, box=cfg.pm_box_arrays(),
              with_potential=False)
    if cfg.tree_near == "pairs":
        kw.update(chunk=cfg.tree_chunk,
                  pair_entries=tuple(cfg.tree_pair_entries))
    else:
        kw.update(capacity=cfg.tree_capacity, max_cells=cfg.tree_max_cells,
                  max_big=cfg.tree_max_big,
                  max_frontier=cfg.tree_max_frontier)
    return kw


def bench_tree(n: int = 65536, levels: int = 7, iters: int = 3,
               near: str = "pairs") -> float:
    """Tree-gravity KDK step rate on a concentrated Plummer sphere (the
    regime P3M's fixed capacity excludes; ops/tree.py conv far field).
    Budgets probe-sized via tree_class_probe."""
    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.utils.timing import bench_chained

    pos, vel, mass = make_plummer(n)
    state = make_state(pos, vel, mass, precision="f32")
    # pairs/c64 near field: simulate()'s own choice at l7/65k
    cfg = tree_cfg_probed(pos, levels, dt=1e-4, G=1.0, eps2=1e-6,
                          tree_near=near,
                          tree_chunk=64 if near == "pairs" else 32,
                          track_potential=False)
    state = ot.init_forces(state, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n))
    sec = bench_chained(step, state, iters=iters, iters_hi=3 * iters)
    return n / sec


def bench_tree_staged(n: int, levels: int = 8, iters: int = 1,
                      near: str = "pairs") -> tuple[float, int]:
    """Large-N tree rate via the STAGED evaluation (ops/tree.py
    tree_acc_potential_staged), the path simulate() takes at levels=8,
    N>=512k. Reported s/eval = far-phase slope + near-phase slope +
    KDK-update slope, each measured with bench_chained (device time; the
    host loop's dispatches are not counted).
    Returns (body-steps/s, overflow from one checked eval)."""
    import jax.numpy as jnp

    from orbital_tpu.ops.tree import tree_acc_potential
    from orbital_tpu.utils.timing import bench_chained

    pos_np, vel_np, mass_np = make_plummer(n)
    pos = jnp.asarray(pos_np, jnp.float32)
    vel = jnp.asarray(vel_np, jnp.float32)
    mass = jnp.asarray(mass_np, jnp.float32)
    cfg = tree_cfg_probed(pos_np, levels, dt=1e-4, G=1.0, eps2=1e-6,
                          tree_near=near,
                          tree_chunk=64 if near == "pairs" else 32,
                          track_potential=False)
    kw = _tree_kw_from_cfg(cfg)

    def phase_step(ph):
        def step(p):
            a, _, _ = tree_acc_potential(p, mass, _phase=ph, **kw)
            return p + jnp.float32(1e-20) * a  # chain through the force
        return step

    sec = 0.0
    for ph in ("far", "near"):
        sec += bench_chained(phase_step(ph), pos, iters=iters,
                             iters_hi=iters + 1, repeats=2)
    dt = jnp.float32(1e-4)
    a0, _, overflow = tree_acc_potential(pos, mass, _phase="near", **kw)
    overflow = int(overflow)

    def upd(carry):  # the step's non-force work: two half-kicks + drift
        p, v = carry
        v = v + (0.5 * dt) * a0
        p = p + dt * v
        v = v + (0.5 * dt) * a0
        return (p, v)

    sec += bench_chained(upd, (pos, vel), iters=4, iters_hi=12)
    return n / sec, overflow


def _make_solar_ensemble(n_ens: int):
    """The BASELINE config-5 ensemble: n_ens perturbed 26-body solar
    systems, ds32, natural rescale. Returns (states, cfg, force, n_bodies).
    Member 0 is the unperturbed control (make_ensemble contract)."""
    import jax

    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import Rescale, make_state
    from orbital_tpu.models.scene import compile_system
    from orbital_tpu.parallel.ensemble import make_ensemble

    scene = compile_system(ot.solar_system_v2(moons=True), compose_parents=True)
    rs = Rescale.natural(scene.pos, scene.mass, ot.STANDARD.G)
    base = make_state(scene.pos, scene.vel, scene.mass, scene.radius,
                      precision="ds32", rescale=rs)
    cfg = ot.SimConfig(dt=1800.0 / rs.time, G=rs.g_internal(ot.STANDARD.G),
                       eps2=(1e6 / rs.length) ** 2)
    states = make_ensemble(base, n_ens, jax.random.key(7), pos_sigma=1e-8)
    force = resolve_force_fn(cfg, base.n_bodies)
    acc, U = jax.vmap(force)(states.pos, states.mass, states.alive)
    states = states.replace(acc=acc, potential=U)
    return states, cfg, force, base.n_bodies


def bench_ensemble(n_ens: int = 1024) -> float:
    """Config 5: vmapped perturbed solar systems; ensemble body-steps/s."""
    import jax

    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.utils.timing import bench_chained

    states, cfg, force, n_bodies = _make_solar_ensemble(n_ens)
    vstep = jax.vmap(make_step_fn(cfg, force))
    sec = bench_chained(vstep, states, iters=200, iters_hi=600)
    return n_ens * n_bodies / sec


def _member_energies_f64(states, G: float, eps2: float) -> np.ndarray:
    """Per-member total energy in host f64 from a (possibly ds32)
    ensemble state [E, n, ...]. 26-body pair sums are trivial host-side,
    so this IS the f64 oracle for the ensemble drift rung."""
    pos = np.asarray(states.pos, np.float64)
    vel = np.asarray(states.vel, np.float64)
    if states.pos_lo is not None:
        pos = pos + np.asarray(states.pos_lo, np.float64)
        vel = vel + np.asarray(states.vel_lo, np.float64)
    mass = (np.asarray(states.mass, np.float64)
            * np.asarray(states.alive, np.float64))
    K = 0.5 * np.sum(mass * np.sum(vel * vel, -1), axis=-1)
    d = pos[:, :, None, :] - pos[:, None, :, :]
    r = np.sqrt(np.sum(d * d, -1) + eps2)
    mm = mass[:, :, None] * mass[:, None, :]
    self_e = np.sum(mass * mass, axis=-1) / np.sqrt(eps2)
    U = -0.5 * G * (np.sum(mm / r, axis=(1, 2)) - self_e)
    return K + U


def bench_ensemble_drift(n_ens: int = 1024, steps: int = 10000,
                         chunk: int = 2000) -> tuple[float, float]:
    """Certify the ensemble config's conservation: roll
    the full 1024x26 solar ensemble for the complete 10k-step horizon and
    measure per-member |dE/E| via host-f64 start/end energies. Returns
    (max over members, member-0 control), rolled in ``chunk``-step
    programs."""
    from orbital_tpu.parallel.ensemble import ensemble_rollout

    states, cfg, _, _ = _make_solar_ensemble(n_ens)
    E0 = _member_energies_f64(states, cfg.G, cfg.eps2)
    done = 0
    while done < steps:
        states, _ = ensemble_rollout(states, cfg, min(chunk, steps - done))
        float(states.time[0])  # sync: one program per chunk
        done += min(chunk, steps - done)
    E1 = _member_energies_f64(states, cfg.G, cfg.eps2)
    drift = np.abs((E1 - E0) / E0)
    return float(drift.max()), float(drift[0])


def _rung(extras: dict, name: str, fn) -> None:
    """Run one extra rung; a failure is recorded as ``<name>_error``."""
    try:
        extras.update(fn())
    except Exception as e:  # noqa: BLE001 — one rung never sinks the rest
        extras[f"bench_{name}_error"] = f"{type(e).__name__}: {str(e)[:200]}"


def main() -> int:
    from orbital_tpu.utils.runtime import (card_info, device_info,
                                           require_gpu, setup_compile_cache)

    require_gpu()
    setup_compile_cache()
    device = dict(device_info(), card=card_info())
    # soft budget for SCHEDULING rungs: a rung that cannot fit is skipped
    # and named in rungs_skipped_for_time
    t_deadline = time.monotonic() + float(
        os.environ.get("BENCH_WALL_BUDGET_S", 18 * 60))
    skipped: list[str] = []

    def _fits(name: str, est_s: float) -> bool:
        if t_deadline - time.monotonic() < est_s:
            skipped.append(name)
            return False
        return True

    # Headline: potential at RECORD cadence (the production stepper; drift
    # is measured start/end-of-horizon from f64 energies computed on the
    # host, so the per-step PE sum never enters the protocol). A failure
    # here propagates: the script exits non-zero.
    rate_65k, sps_65k, drift_65k = bench_config(
        65536, drift_steps=10000, iters=4, track_potential=False)
    extras = {
        "ms_per_step_65536": sps_65k * 1e3,
        "energy_drift_65536_10000steps": drift_65k,
        "energy_oracle": energy_oracle(),
        "rungs_skipped_for_time": skipped,
    }

    if _fits("with_potential", 60):
        _rung(extras, "with_potential", lambda: {
            "body_steps_per_s_65536_with_potential": bench_config(
                65536, drift_steps=0, iters=4, track_potential=True)[0]})

    def _r4k():
        rate, sps, drift = bench_config(4096, drift_steps=10000, iters=100)
        return dict(body_steps_per_s_4096=rate,
                    vs_baseline_4096=rate / BASELINE_4K,
                    ms_per_step_4096=sps * 1e3,
                    energy_drift_4096_10000steps=drift)

    if _fits("4096", 70):
        _rung(extras, "4096", _r4k)
    if _fits("ensemble", 60):
        _rung(extras, "ensemble", lambda: {
            "ensemble_1024x26solar_body_steps_per_s": bench_ensemble(1024)})

    def _rens_drift():
        d_max, d_m0 = bench_ensemble_drift(1024, steps=10000)
        return dict(ensemble_drift_10000steps=d_max,
                    ensemble_drift_member0_10000steps=d_m0)

    if _fits("ensemble_drift", 150):
        _rung(extras, "ensemble_drift", _rens_drift)

    def _rcoll():
        rate = bench_rate_with_collisions(65536)
        return dict(body_steps_per_s_65536_with_collision_sweep=rate,
                    vs_baseline_65536_with_collision_sweep=rate / BASELINE_65K)

    if _fits("collisions", 60):
        _rung(extras, "collisions", _rcoll)
    if _fits("resolve", 60):
        _rung(extras, "resolve", lambda: {
            "body_steps_per_s_65536_with_resolve":
                bench_rate_with_resolve(65536)})
    if _fits("hermite", 60):
        _rung(extras, "hermite", lambda: {
            "hermite_body_steps_per_s_65536": bench_hermite(65536)})
    if _fits("pm_rate", 90):
        _rung(extras, "pm", lambda: {
            "pm_body_steps_per_s_1048576_grid128": bench_pm(1 << 20)})
    if _fits("tree_65k", 120):
        _rung(extras, "tree", lambda: {
            "tree_body_steps_per_s_65536_plummer": bench_tree()})

    def _r131k():
        rate, sps, _ = bench_config(131072, drift_steps=0, iters=2)
        return dict(body_steps_per_s_131072=rate,
                    ms_per_step_131072=sps * 1e3)

    if _fits("131072", 60):
        _rung(extras, "131072", _r131k)

    # conservation extras: drift per approximate family. PM on the
    # headline cluster (10k steps, PINNED box): the cluster's eps is ~10x
    # below the grid-128 cell spacing, outside PM's collisionless
    # contract, so its drift is fluctuation-dominated. Tree on the
    # headline cluster at a shorter, key-labeled horizon; P3M on a
    # uniform box (its regime).
    import jax.numpy as jnp

    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    def _drift(cfg, state, steps, eps2_):
        E0 = energy_hybrid(state, eps2_)
        final, _ = ot.rollout_jit(state, cfg, steps)
        return abs((energy_hybrid(final, eps2_) - E0) / E0)

    pos, vel, mass, eps2 = make_cluster(65536)
    box = (0.0, 0.0, 0.0, 8.0)

    def _rpm_drift():
        cfg_pm = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="pm",
                              pm_grid=128, pm_box=box)
        st = ot.init_forces(make_state(pos, vel, mass, precision="f32"),
                            cfg_pm)
        return {"pm_drift_65536_10000steps": _drift(cfg_pm, st, 10000, eps2)}

    if _fits("pm_drift", 220):
        _rung(extras, "pm_drift", _rpm_drift)

    def _rtree_drift():
        cfg_tr = tree_cfg_probed(pos, 7, dt=1e-3, G=1.0, eps2=eps2,
                                 tree_near="pairs", tree_chunk=64,
                                 pm_box=box)
        st = ot.init_forces(make_state(pos, vel, mass, precision="f32"),
                            cfg_tr)
        return {"tree_drift_65536_1000steps": _drift(cfg_tr, st, 1000, eps2)}

    if _fits("tree_drift", 260):
        _rung(extras, "tree_drift", _rtree_drift)

    # multirate (RESPA) rungs on the XLA near sweep: candidates under the
    # drift wall (drift ~ K^2..K^3.7, 1e-6 budget -> K <= 5 at rc = 5 eps;
    # M*K = 16 is the free frozen-geometry window at cell = 2 rc). They
    # stay extras; the headline is the exact stepper.
    for k_mr in (5, 4):
        def _rrespa(k_mr=k_mr):
            rate, drift, ovf, skin = bench_respa(
                65536, k=k_mr, headroom=2.2, refresh=16 // k_mr,
                w_headroom=1.5)
            return {f"respa_k{k_mr}_body_steps_per_s_65536": rate,
                    f"respa_k{k_mr}_drift_65536_10000steps": drift,
                    f"respa_k{k_mr}_overflow": ovf,
                    f"respa_k{k_mr}_skin_violation": skin}

        if _fits(f"respa_k{k_mr}", 380):
            _rung(extras, f"respa_k{k_mr}", _rrespa)

    def _rp3m_drift():
        from orbital_tpu.ops.p3m import p3m_max_occupancy

        rng_u = np.random.default_rng(11)
        pos_u = rng_u.uniform(-4.0, 4.0, size=(65536, 3))
        vel_u = 0.1 * rng_u.normal(size=(65536, 3))
        ubox = (0.0, 0.0, 0.0, 6.0)
        occ = int(p3m_max_occupancy(
            jnp.asarray(pos_u, jnp.float32), grid=64,
            box=(jnp.zeros(3, jnp.float32), jnp.float32(6.0))))
        cap = max(32, -(-int(occ * 1.5) // 8) * 8)
        if cap > 4096:
            raise RuntimeError(f"p3m capacity {cap} unsafe to compile")
        cfg_p3 = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="p3m",
                              pm_grid=64, p3m_capacity=cap, pm_box=ubox)
        st = ot.init_forces(make_state(pos_u, vel_u, mass, precision="f32"),
                            cfg_p3)
        return {"p3m_uniform_drift_65536_4000steps":
                _drift(cfg_p3, st, 4000, eps2)}

    if _fits("p3m_drift", 240):
        _rung(extras, "p3m_drift", _rp3m_drift)

    # the tree's own regime: concentrated large N, staged two-program
    # evaluation, in this process (one process per card)
    for n_large in (524288, 1048576):
        def _rstaged(n_large=n_large):
            rate, ovf = bench_tree_staged(n_large, levels=8)
            return {f"tree_body_steps_per_s_{n_large}_plummer": rate,
                    f"tree_s_per_eval_{n_large}": n_large / rate,
                    f"tree_overflow_{n_large}": ovf}

        if _fits(f"tree_staged_{n_large}", 150):
            _rung(extras, f"tree_{n_large}", _rstaged)

    print(json.dumps({
        "metric": ("body-steps/s/chip @ N=65536 (KDK leapfrog, softened "
                   "O(N^2) exact sweep on the Pallas GPU kernel, ds32, "
                   "potential at record cadence)"),
        "value": rate_65k,
        "unit": "body-steps/s",
        "vs_baseline": rate_65k / BASELINE_65K,
        "device": device,
        "extras": extras,
    }))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
