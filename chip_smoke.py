"""Smoke test on the GPU: the main paths at real sizes, every kernel compiled.

    python chip_smoke.py               # one GPU: all single-card phases
    python chip_smoke.py --multichip   # four GPUs: the body-sharded ring only

Each phase prints one JSON line (``"phase"``, ``"ok"``, its numbers and the
card's name and power limit). The single-card phases are

  kernels  — each kept Pallas kernel and its XLA counterpart compiled at
             4,096, 65,536 and 131,072 bodies: ``memory_analysis()``,
             error against a float64 numpy reference on 1,024 sampled
             rows, exact contact counts against a k-d tree, median times,
             and a 65k KDK step with each sweep;
  main     — ``ot.simulate`` on a 65,536-body cluster (KDK, ds32, auto
             force path) with |dE/E| from float64 energies, and
             ``python -m orbital_tpu simulate`` run in this process;
  paths    — Hermite, bounce and resolve collisions (with contacts),
             PM at 1,048,576, P3M, the tree at 65k and the staged tree at
             1,048,576, RESPA K=4, the 1024x26 solar ensemble;
  gpu_tests — the chip tests of ``gpu_tests/``, in this process.

With ``--multichip`` the script runs the ring exact force body-sharded
over four GPUs at N = 262,144 and compares it, and 10 steps of
``simulate(mesh=...)``, with the single-device exact sweep.

The next-to-last line is the card's name and power limit as ``nvidia-smi``
gives them; the last line is ``{"ok": true, "device": {...}}``. Without a
GPU, or outside a checkout of this repository, it exits non-zero and
prints no result. Everything runs in this one process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# accuracy bounds for a float32 sweep against float64, per sampled row
# |a - a_ref| / |a_ref|: each of the kernel's TJ lanes sums N/TJ terms in
# order, so rounding grows like sqrt(N/TJ) * 2^-24 (~4e-6 at 131k); the
# bounds leave room for the approximate rsqrt. The kernel must also stay
# within 2x XLA's own error, or below 1e-6 where both are rounding noise.
ACC_RMS_BOUND = 1e-5
ACC_MAX_BOUND = 1e-4
JERK_RMS_BOUND = 1e-4   # jerk terms cancel more than acceleration terms
NOISE_FLOOR = 1e-6
DRIFT_BUDGET = 1e-6     # |dE/E| of the exact KDK stepper (BASELINE.json)
EPS2 = 1e-4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Body counts of each phase; tests shrink them to run on the CPU."""

    kernel_n: tuple = (4096, 65536, 131072)
    kdk_n: int = 65536
    sample_rows: int = 1024
    reps: int = 5
    main_n: int = 65536
    main_steps: int = 300
    main_record_every: int = 30
    paths_n: int = 65536
    pm_n: int = 1 << 20
    pm_grid: int = 128
    tree_levels: int = 7
    staged_n: int = 1 << 20
    staged_levels: int = 8
    ensemble: int = 1024
    ensemble_steps: int = 100
    multichip_n: int = 262144


# ---------------------------------------------------------------- helpers

def _interpret() -> bool:
    from orbital_tpu.ops import backend

    return backend.INTERPRET


def potential_f64(pos, mass, eps2: float, chunk: int = 1024) -> float:
    """Softened potential (pairs once) in float64 on the default device,
    through the row-chunked XLA sweep."""
    import jax
    import jax.numpy as jnp

    from orbital_tpu.ops.forces import pairwise_acc_chunked

    n = len(mass)
    chunk = min(chunk, n)
    with jax.enable_x64(True):
        p = jnp.asarray(np.asarray(pos, np.float64))
        m = jnp.asarray(np.asarray(mass, np.float64))
        _, U = pairwise_acc_chunked(p, m, G=1.0, eps2=eps2, chunk=chunk)
        return float(U)


def energy_f64(pos, vel, mass, eps2: float) -> float:
    vel = np.asarray(vel, np.float64)
    mass = np.asarray(mass, np.float64)
    kin = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    return kin + potential_f64(pos, mass, eps2)


def full_f64(hi, lo) -> np.ndarray:
    """A ds32 (hi, lo) pair, or a plain array, as float64 on the host."""
    out = np.asarray(hi, np.float64)
    return out if lo is None else out + np.asarray(lo, np.float64)


def make_cluster(n: int, seed: int = 0, radius: float = 0.0):
    """Virialised Gaussian cluster in natural units (G = 1, M = 1) as
    host float64 arrays; the virial scaling uses the float64 device
    potential."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    U = potential_f64(pos, mass, EPS2)
    kin = 0.5 * float(np.sum(mass * np.sum(vel * vel, -1)))
    vel *= np.sqrt(0.5 * abs(U) / kin)
    return pos, vel, mass, np.full(n, radius)


def make_plummer(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    pos = r[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
    vel = 0.05 * rng.normal(size=(n, 3))
    return pos, vel, np.full(n, 1.0 / n), np.zeros(n)


def contact_radius(n: int, pairs: float = 200.0) -> float:
    """Radius at which a unit Gaussian cloud of n bodies has about
    ``pairs`` touching pairs: pairs ~ n^2/2 * (4 pi/3) d^3 * int rho^2,
    with int rho^2 = 1 / (8 pi^1.5) and d = 2 R."""
    d = (pairs / (n * n / 2 * (4 * np.pi / 3) / (8 * np.pi ** 1.5))) ** (1 / 3)
    return d / 2


def scene(pos, vel, mass, radius):
    from orbital_tpu.models.scene import SceneArrays

    n = len(mass)
    return SceneArrays(pos=np.asarray(pos, np.float64),
                       vel=np.asarray(vel, np.float64),
                       mass=np.asarray(mass, np.float64),
                       radius=np.asarray(radius, np.float64),
                       names=[f"b{i}" for i in range(n)])


def natural_units():
    """simulate() keywords for scenes already in natural units (G = 1)."""
    import orbital_tpu as ot
    from orbital_tpu.engine.state import Rescale

    return dict(unit_profile=dataclasses.replace(ot.STANDARD, G=1.0),
                rescale=Rescale.identity())


def reference_rows(pos, vel, mass, rows, eps2: float, chunk: int = 32):
    """float64 numpy acc, jerk and pe row of the sampled rows against all
    bodies (the self-pair is skipped by index)."""
    p = np.asarray(pos, np.float64)
    v = np.asarray(vel, np.float64)
    m = np.asarray(mass, np.float64)
    acc = np.zeros((len(rows), 3))
    jerk = np.zeros((len(rows), 3))
    pe = np.zeros(len(rows))
    for s in range(0, len(rows), chunk):
        idx = rows[s:s + chunk]
        d = p[None, :, :] - p[idx, None, :]
        dv = v[None, :, :] - v[idx, None, :]
        s2 = (d * d).sum(-1) + eps2
        inv = 1.0 / np.sqrt(s2)
        inv[np.arange(len(idx)), idx] = 0.0
        w = m[None, :] * inv ** 3
        acc[s:s + chunk] = (w[..., None] * d).sum(1)
        rv = (d * dv).sum(-1)
        jerk[s:s + chunk] = (w[..., None] * (
            dv - 3.0 * (rv * inv * inv)[..., None] * d)).sum(1)
        pe[s:s + chunk] = (m[None, :] * inv).sum(1)
    return acc, jerk, pe


def row_errors(got, ref) -> dict:
    """RMS and max over rows of |got - ref| / |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.ndim == 1:
        rel = np.abs(got - ref) / np.abs(ref)
    else:
        rel = (np.linalg.norm(got - ref, axis=1)
               / np.linalg.norm(ref, axis=1))
    return {"rms": float(np.sqrt(np.mean(rel * rel))),
            "max": float(np.max(rel))}


def median_time(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def memory(jitted, *args) -> dict:
    """``compiled.memory_analysis()`` of a jitted function at these args."""
    ma = jitted.lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kdtree_contacts(pos32, radius: float) -> int:
    """Directed touching-pair count of equal-radius bodies, from scipy's
    k-d tree on the same float32 positions (the kernel's 1e-5 inflation
    applied)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(pos32, np.float64)
    pairs = cKDTree(pts).query_pairs(2.0 * radius * 1.00001,
                                     output_type="ndarray")
    return 2 * len(pairs)


# ----------------------------------------------------------------- phases

def phase_kernels(sizes: Sizes) -> dict:
    """Every kept kernel against its XLA counterpart at real widths."""
    import jax
    import jax.numpy as jnp

    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.ops import forces
    from orbital_tpu.ops import pallas_forces as pf
    from orbital_tpu.ops.collisions import count_contacts_chunked

    interp = _interpret()
    out = {}
    for n in sizes.kernel_n:
        rng = np.random.default_rng(n)
        pos_np = rng.normal(size=(n, 3)).astype(np.float32)
        vel_np = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
        mass_np = np.full(n, 1.0 / n, np.float32)
        rad = contact_radius(n)
        pos, vel, mass = (jnp.asarray(a) for a in (pos_np, vel_np, mass_np))
        radius = jnp.full((n,), rad, jnp.float32)
        alive = jnp.ones((n,), bool)
        rows = np.sort(rng.choice(n, min(sizes.sample_rows, n),
                                  replace=False))
        acc_ref, jerk_ref, pe_ref = reference_rows(pos_np, vel_np, mass_np,
                                                   rows, EPS2)
        n_contacts = kdtree_contacts(pos_np, rad)
        chunk = min(1024, n)
        kw = dict(G=1.0, eps2=EPS2)
        blk = n // 4
        variants = {
            "force": (
                lambda p, m: pf.pairwise_acc_pallas(
                    p, m, with_potential=False, interpret=interp, **kw),
                lambda p, m: forces.pairwise_acc_chunked(p, m, chunk=chunk,
                                                         **kw),
                (pos, mass)),
            "force_pe": (
                lambda p, m: pf.pairwise_acc_pallas(p, m, interpret=interp,
                                                    **kw),
                lambda p, m: forces.pairwise_acc_chunked(p, m, chunk=chunk,
                                                         **kw),
                (pos, mass)),
            "detect": (
                lambda p, m, r, a: pf.pairwise_acc_detect_pallas(
                    p, m, r, a, interpret=interp, **kw),
                lambda p, m, r, a: forces.pairwise_acc_chunked(
                    p, m, a, chunk=chunk, **kw)
                + (count_contacts_chunked(p, r, a, chunk=chunk),),
                (pos, mass, radius, alive)),
            "jerk": (
                lambda p, v, m: pf.accel_jerk_pallas(p, v, m,
                                                     interpret=interp, **kw),
                lambda p, v, m: forces.accel_jerk_chunked(p, v, m,
                                                          chunk=chunk, **kw),
                (pos, vel, mass)),
            "jerk_detect": (
                lambda p, v, m, r, a: pf.accel_jerk_detect_pallas(
                    p, v, m, r, a, interpret=interp, **kw),
                lambda p, v, m, r, a: forces.accel_jerk_chunked(
                    p, v, m, a, chunk=chunk, **kw)
                + (count_contacts_chunked(p, r, a, chunk=chunk),),
                (pos, vel, mass, radius, alive)),
            "ring_block": (
                lambda pi, pj, m: pf.block_acc_pallas(pi, pj, m,
                                                      interpret=interp, **kw),
                lambda pi, pj, m: forces.block_acc_chunked(
                    pi, pj, m, chunk=min(chunk, blk), **kw),
                (pos[:blk], pos, mass)),
        }
        res_n = {}
        for name, (kern, xla, args) in variants.items():
            kern, xla = jax.jit(kern), jax.jit(xla)
            r = {"kernel_memory": memory(kern, *args),
                 "xla_memory": memory(xla, *args)}
            ko = jax.block_until_ready(kern(*args))
            xo = jax.block_until_ready(xla(*args))
            if name == "ring_block":
                sel = rows[rows < blk]
                r["kernel_acc_err"] = row_errors(np.asarray(ko[0])[sel],
                                                 acc_ref[rows < blk])
                r["xla_acc_err"] = row_errors(np.asarray(xo[0])[sel],
                                              acc_ref[rows < blk])
                # the block's pe row includes the i == j term m_i/eps
                self_pe = mass_np[sel] / np.sqrt(EPS2)
                r["kernel_pe_err"] = row_errors(
                    np.asarray(ko[1])[sel] - self_pe, pe_ref[rows < blk])
            else:
                r["kernel_acc_err"] = row_errors(np.asarray(ko[0])[rows],
                                                 acc_ref)
                r["xla_acc_err"] = row_errors(np.asarray(xo[0])[rows],
                                              acc_ref)
            if name.startswith("jerk"):
                r["kernel_jerk_err"] = row_errors(np.asarray(ko[1])[rows],
                                                  jerk_ref)
                r["xla_jerk_err"] = row_errors(np.asarray(xo[1])[rows],
                                               jerk_ref)
                check(r["kernel_jerk_err"]["rms"] <= JERK_RMS_BOUND,
                      f"{name} N={n} jerk rms {r['kernel_jerk_err']}")
            if name in ("force_pe", "jerk"):
                u_k = float(ko[-1])
                u_x = float(xo[-1])
                r["U_rel_diff_vs_xla"] = abs(u_k - u_x) / abs(u_x)
                check(r["U_rel_diff_vs_xla"] <= 1e-5,
                      f"{name} N={n} potential differs from XLA's")
            if name.endswith("detect"):
                r["contacts"] = int(ko[-1])
                r["contacts_xla"] = int(xo[-1])
                r["contacts_kdtree"] = n_contacts
                check(n_contacts > 0, f"N={n}: the IC has no contacts")
                check(int(ko[-1]) == n_contacts == int(xo[-1]),
                      f"{name} N={n} contacts {r['contacts']} vs "
                      f"k-d tree {n_contacts}, XLA {r['contacts_xla']}")
            ke, xe = r["kernel_acc_err"], r["xla_acc_err"]
            check(ke["rms"] <= ACC_RMS_BOUND and ke["max"] <= ACC_MAX_BOUND,
                  f"{name} N={n} acc error {ke}")
            check(ke["rms"] <= max(2.0 * xe["rms"], NOISE_FLOOR),
                  f"{name} N={n} kernel error {ke['rms']} vs XLA "
                  f"{xe['rms']}")
            r["kernel_s"] = median_time(lambda: kern(*args), sizes.reps)
            r["xla_s"] = median_time(lambda: xla(*args), sizes.reps)
            res_n[name] = r
        out[str(n)] = res_n

    # the end-to-end decision: one KDK step with each exact sweep
    n = sizes.kdk_n
    rng = np.random.default_rng(1)
    st = make_state(rng.normal(size=(n, 3)), 0.1 * rng.normal(size=(n, 3)),
                    np.full(n, 1.0 / n), precision="ds32")
    steps = 10
    kdk = {}
    for impl in ("pallas", "chunked", "chunked", "pallas"):
        cfg = ot.SimConfig(dt=1e-3, eps2=EPS2, force_impl=impl,
                           track_potential=False)
        s0 = ot.init_forces(st, cfg)
        t = median_time(lambda: ot.rollout_jit(s0, cfg, steps)[0].pos,
                        sizes.reps) / steps
        kdk.setdefault(impl, []).append(t)
    out["kdk_step_s"] = {"n": n, **kdk}
    return out


def phase_main(sizes: Sizes) -> dict:
    """The user's main path through simulate() and the CLI."""
    import orbital_tpu as ot
    from orbital_tpu import __main__ as cli

    n = sizes.main_n
    pos, vel, mass, radius = make_cluster(n, seed=2)
    res = ot.simulate(scene(pos, vel, mass, radius), steps=sizes.main_steps,
                      dt=1e-3, softening=EPS2 ** 0.5, precision="ds32",
                      record_every=sizes.main_record_every,
                      **natural_units())
    fin = res.final_state
    check(res.pos.shape == (sizes.main_steps // sizes.main_record_every,
                            n, 3), f"records {res.pos.shape}")
    check(bool(np.isfinite(res.pos).all()), "non-finite positions")
    e0 = energy_f64(pos, vel, mass, EPS2)
    e1 = energy_f64(full_f64(fin.pos, fin.pos_lo),
                    full_f64(fin.vel, fin.vel_lo), mass, EPS2)
    drift = abs((e1 - e0) / e0)
    check(drift <= DRIFT_BUDGET, f"|dE/E| {drift} over {DRIFT_BUDGET}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["simulate"])
    cli_out = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(cli_out["steps"] == 365 and np.isfinite(cli_out["energy_drift"]),
          f"CLI output {cli_out}")
    return {"simulate": {"n": n, "steps": sizes.main_steps,
                         "force_impl": res.config.force_impl,
                         "records": int(res.pos.shape[0]),
                         "energy_drift_f64": drift,
                         "drift_budget": DRIFT_BUDGET},
            "cli_simulate": cli_out}


def phase_paths(sizes: Sizes) -> dict:
    """The other paths users reach through simulate(), a few steps each."""
    import jax

    import orbital_tpu as ot
    from orbital_tpu.engine.state import Rescale, make_state
    from orbital_tpu.models.scene import compile_system
    from orbital_tpu.ops.collisions import count_contacts_chunked
    from orbital_tpu.parallel.ensemble import ensemble_rollout, make_ensemble

    nat = natural_units()
    out = {}

    def run(name, sc, **kw):
        t0 = time.perf_counter()
        res = ot.simulate(sc, **nat, **kw)
        fin = res.final_state
        check(bool(np.isfinite(np.asarray(fin.pos)).all()),
              f"{name}: non-finite positions")
        out[name] = {"n": int(fin.n_bodies), "steps": kw["steps"],
                     "seconds_with_compile": time.perf_counter() - t0,
                     "alive_end": int(np.sum(np.asarray(fin.alive)))}
        return res

    n = sizes.paths_n
    cl = make_cluster(n, seed=3)
    run("hermite", scene(*cl), steps=4, dt=1e-3, softening=EPS2 ** 0.5,
        precision="ds32", integrator="hermite")

    rad = contact_radius(n)
    pos, vel, mass, _ = cl
    touching = scene(pos, vel, mass, np.full(n, rad))
    p32 = np.asarray(pos, np.float32)
    contacts0 = int(count_contacts_chunked(
        p32, np.full(n, rad, np.float32), np.ones(n, bool),
        chunk=min(1024, n)))
    check(contacts0 > 0, "collision IC has no contacts")
    momentum0 = np.sum(mass[:, None] * vel, axis=0)
    for mode in ("bounce", "resolve"):
        res = run(mode, touching, steps=4, dt=1e-3, softening=EPS2 ** 0.5,
                  precision="ds32", collisions=mode, restitution=0.5,
                  frag_seed=5)
        fin = res.final_state
        m = np.asarray(fin.mass, np.float64) * np.asarray(fin.alive)
        dp = np.sum(m[:, None] * full_f64(fin.vel, fin.vel_lo), 0)
        out[mode]["contacts_at_start"] = contacts0
        out[mode]["momentum_change"] = float(np.linalg.norm(dp - momentum0))

    rng = np.random.default_rng(4)
    npm = sizes.pm_n
    run("pm", scene(rng.normal(size=(npm, 3)), 0.3 * rng.normal(
        size=(npm, 3)), np.full(npm, 1.0 / npm), np.zeros(npm)),
        steps=4, dt=1e-3, softening=0.1, precision="f32", force_impl="pm",
        pm_grid=sizes.pm_grid)

    uni = rng.uniform(-4.0, 4.0, size=(n, 3))
    run("p3m", scene(uni, 0.1 * rng.normal(size=(n, 3)), np.full(n, 1.0 / n),
                     np.zeros(n)),
        steps=4, dt=1e-3, softening=EPS2 ** 0.5, precision="f32",
        force_impl="p3m", pm_grid=64)

    run("tree_pairs", scene(*make_plummer(n, seed=5)), steps=4, dt=1e-4,
        softening=1e-3, precision="f32", force_impl="tree",
        tree_levels=sizes.tree_levels, tree_near="pairs")
    res = run("tree_staged", scene(*make_plummer(sizes.staged_n, seed=6)),
              steps=2, dt=1e-4, softening=1e-3, precision="f32",
              force_impl="tree", tree_levels=sizes.staged_levels,
              tree_near="pairs")
    out["tree_staged"]["tree_levels"] = res.config.tree_levels

    run("respa_k4", scene(*cl), steps=8, dt=1e-3, softening=EPS2 ** 0.5,
        precision="ds32", integrator="respa", respa_k=4)

    sc = compile_system(ot.solar_system_v2(moons=True), compose_parents=True)
    rs = Rescale.natural(sc.pos, sc.mass, ot.STANDARD.G)
    base = make_state(sc.pos, sc.vel, sc.mass, sc.radius, precision="ds32",
                      rescale=rs)
    cfg = ot.SimConfig(dt=1800.0 / rs.time, G=rs.g_internal(ot.STANDARD.G),
                       eps2=(1e6 / rs.length) ** 2)
    states = make_ensemble(base, sizes.ensemble, jax.random.key(7),
                           pos_sigma=1e-8)
    t0 = time.perf_counter()
    fin, _ = ensemble_rollout(states, cfg, sizes.ensemble_steps)
    pos_e = full_f64(fin.pos, fin.pos_lo)
    check(bool(np.isfinite(pos_e).all()), "ensemble: non-finite positions")
    out["ensemble"] = {"members": sizes.ensemble,
                       "bodies": int(base.n_bodies),
                       "steps": sizes.ensemble_steps,
                       "seconds_with_compile": time.perf_counter() - t0}
    return out


def phase_gpu_tests() -> dict:
    """The chip tests, in this process (one process holds the card)."""
    import pytest

    code = pytest.main(["-q", "-p", "no:cacheprovider",
                        os.path.join(REPO, "gpu_tests")])
    check(int(code) == 0, f"gpu_tests exit code {int(code)}")
    return {"pytest_exit": int(code)}


def phase_multichip(sizes: Sizes, devices=None) -> dict:
    """The ring exact force body-sharded over every device, against the
    single-device exact sweep: forces on sampled rows, and positions
    after 10 steps of simulate(mesh=...)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.parallel.mesh import make_mesh
    from orbital_tpu.parallel.sharded import ring_force_fn, shard_state

    n = sizes.multichip_n
    devices = list(devices or jax.devices())
    n_dev = len(devices)
    mesh = make_mesh(devices=devices)
    pos, vel, mass, radius = make_cluster(n, seed=8)
    st = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, eps2=EPS2, shard_axis="body")
    a_one, u_one = resolve_force_fn(cfg, n)(st.pos, st.mass, st.alive)
    ring = jax.jit(jax.shard_map(
        ring_force_fn(cfg, n_dev), mesh=mesh,
        in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()), check_vma=False))
    sh = shard_state(mesh, st)
    a_ring, u_ring = ring(sh.pos, sh.mass, sh.alive)
    rows = np.sort(np.random.default_rng(9).choice(
        n, min(sizes.sample_rows, n), replace=False))
    acc_ref, _, _ = reference_rows(np.asarray(st.pos), np.zeros((n, 3)),
                                   np.asarray(st.mass), rows, EPS2)
    err_ring = row_errors(np.asarray(a_ring)[rows], acc_ref)
    err_one = row_errors(np.asarray(a_one)[rows], acc_ref)
    ring_vs_one = row_errors(np.asarray(a_ring)[rows],
                             np.asarray(a_one, np.float64)[rows])
    check(err_ring["rms"] <= ACC_RMS_BOUND
          and err_ring["max"] <= ACC_MAX_BOUND, f"ring error {err_ring}")
    check(ring_vs_one["rms"] <= ACC_RMS_BOUND, f"ring vs one {ring_vs_one}")
    u_diff = abs(float(u_ring) - float(u_one)) / abs(float(u_one))
    check(u_diff <= 1e-5, f"ring potential differs by {u_diff}")

    kw = dict(steps=10, dt=1e-3, softening=EPS2 ** 0.5, precision="ds32",
              record_every=10, **natural_units())
    sc = scene(pos, vel, mass, radius)
    t0 = time.perf_counter()
    res_mesh = ot.simulate(sc, mesh=mesh, **kw)
    t_mesh = time.perf_counter() - t0
    res_one = ot.simulate(sc, **kw)
    dpos = np.max(np.abs(res_mesh.pos[-1] - res_one.pos[-1]))
    scale = float(np.sqrt(np.mean(res_one.pos[-1] ** 2)))
    check(dpos <= 1e-6 * scale, f"positions after 10 steps differ by {dpos}")
    return {"n": n, "devices": n_dev, "ring_acc_err": err_ring,
            "single_acc_err": err_one, "ring_vs_single": ring_vs_one,
            "U_rel_diff": u_diff, "pos_max_diff_10_steps": float(dpos),
            "pos_rms_scale": scale, "mesh_simulate_seconds": t_mesh}


# ------------------------------------------------------------------- main

def _emit(record: dict) -> None:
    print(json.dumps(record, default=float), flush=True)


def run_phase(name: str, fn, card: str) -> bool:
    t0 = time.perf_counter()
    try:
        result = fn()
        ok = True
    except Exception as e:  # noqa: BLE001 — report, and fail the run
        result = {"error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
        ok = False
    _emit({"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
           **result, "card": card})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the ring over four GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from orbital_tpu.utils.runtime import (card_info, device_info,
                                               require_gpu,
                                               setup_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: the orbital_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    try:
        require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    setup_compile_cache()
    import jax

    card = card_info()
    sizes = Sizes()
    if args.multichip:
        if len(jax.devices()) != 4:
            print(f"chip_smoke: --multichip needs 4 GPUs, found "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 1
        phases = [("multichip", lambda: phase_multichip(sizes))]
    else:
        phases = [("kernels", lambda: phase_kernels(sizes)),
                  ("main", lambda: phase_main(sizes)),
                  ("paths", lambda: phase_paths(sizes)),
                  ("gpu_tests", phase_gpu_tests)]
    ok = all([run_phase(name, fn, card) for name, fn in phases])
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(card, flush=True)
    _emit({"ok": True, "device": device_info()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
