"""Compiled multi-step rollouts with on-device trajectory recording.

The reference advances with a Python loop appending positions to dicts and
writing JSONL inside the step (core/engine.py:88-101). Here the whole
rollout is one ``lax.scan``: the carry is the :class:`NBodyState`, the scan
ys are strided position snapshots recorded *on device*, and the host gets
one transfer per rollout call. File I/O (checkpoints, JSONL frames) happens
between rollout calls, never inside the compiled step.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import backend
from ..ops.forces import pairwise_acc_chunked, pairwise_acc_dense
from ..utils.config import SimConfig
from .integrators import ForceFn, make_step_fn
from .state import NBodyState

__all__ = ["Trajectory", "resolve_force_fn", "resolve_force_detect_fn",
           "resolve_accel_jerk_fn", "resolve_accel_jerk_detect_fn",
           "init_forces", "init_forces_staged", "rollout", "rollout_jit",
           "rollout_staged"]

def _exact_impl(cfg: SimConfig, n: int) -> str:
    """``cfg.force_impl`` with ``"auto"`` resolved by ``ops.backend``."""
    if cfg.force_impl == "auto":
        return backend.exact_sweep_impl(n)
    return cfg.force_impl


@partial(jax.tree_util.register_dataclass,
         data_fields=["pos", "vel", "time", "energy", "ang_mom", "alive"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Strided rollout recording, time-major: [n_records, ...]."""

    pos: jax.Array      # [R, N, 3]
    vel: jax.Array      # [R, N, 3]
    time: jax.Array     # [R]
    energy: jax.Array   # [R] kinetic + cached softened potential
    ang_mom: jax.Array  # [R, 3]
    alive: jax.Array    # [R, N] bool per-record alive mask (merge tracking)

    @property
    def n_records(self) -> int:
        return self.pos.shape[0]


def resolve_force_fn(cfg: SimConfig, n: int) -> ForceFn:
    """Pick the force implementation for a config and body count."""
    impl = _exact_impl(cfg, n)

    if impl == "dense":
        return lambda pos, mass, alive: pairwise_acc_dense(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2
        )
    if impl == "chunked":
        return lambda pos, mass, alive: pairwise_acc_chunked(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2, chunk=min(cfg.chunk, n)
        )
    if impl == "pallas":
        from ..ops.pallas_forces import pairwise_acc_pallas

        interpret = backend.INTERPRET
        return lambda pos, mass, alive: pairwise_acc_pallas(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
            with_potential=cfg.track_potential, interpret=interpret,
        )
    if impl == "mxu":
        from ..ops.mxu_forces import pairwise_acc_mxu

        return lambda pos, mass, alive: pairwise_acc_mxu(
            pos, mass, alive, G=cfg.G, eps2=cfg.eps2,
            chunk=min(cfg.chunk, n), with_potential=cfg.track_potential
        )
    if impl in ("pm", "p3m"):
        box = cfg.pm_box_arrays()
        if impl == "pm":
            from ..ops.pm import pm_acc_potential

            return lambda pos, mass, alive: pm_acc_potential(
                pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2,
                grid=cfg.pm_grid, with_potential=cfg.track_potential,
                box=box)
        from ..ops.p3m import p3m_acc_potential

        def fn(pos, mass, alive):
            # the overflow counter is dropped on the hot path; size
            # cfg.p3m_capacity by probing p3m_acc_potential directly
            acc, U, _ = p3m_acc_potential(
                pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2,
                grid=cfg.pm_grid, capacity=cfg.p3m_capacity,
                with_potential=cfg.track_potential, box=box)
            return acc, U
        return fn
    if impl == "tree":
        from ..ops.tree import tree_acc_potential

        def fn(pos, mass, alive):
            # the overflow counter is dropped on the hot path; size
            # cfg.tree_capacity / tree_max_cells via tree_occupancy_probe
            # (simulate(force_impl="tree") does) and re-probe between
            # rollout chunks if the system contracts
            acc, U, _ = tree_acc_potential(
                pos, mass, alive, G_grav=cfg.G, eps2=cfg.eps2,
                levels=cfg.tree_levels, capacity=cfg.tree_capacity,
                ws=cfg.tree_ws, max_cells=cfg.tree_max_cells,
                order=cfg.tree_order, max_big=cfg.tree_max_big,
                max_frontier=cfg.tree_max_frontier,
                max_chunks=cfg.tree_max_chunks, near=cfg.tree_near,
                chunk=cfg.tree_chunk,
                pair_entries=tuple(cfg.tree_pair_entries),
                with_potential=cfg.track_potential, box=cfg.pm_box_arrays())
            return acc, U
        return fn
    if impl == "ring":
        # the ring force needs the mesh's shard count and must run inside
        # shard_map; it cannot be resolved from a config alone
        raise ValueError(
            "force_impl='ring' is built via parallel.sharded.make_sharded_step"
            " (it needs a Mesh), not resolve_force_fn"
        )
    raise ValueError(f"unknown force_impl {impl!r}")


def resolve_force_detect_fn(cfg: SimConfig, n: int):
    """Force + fused contact detection:
    ``fn(pos, mass, radius, alive) -> (acc, U, contacts)`` with ``contacts``
    an int32 directed touching-pair count (0 exactly when no live bodies
    overlap). On the GPU kernel detection shares the force sweep's r^2
    tiles (about 4 extra flops/pair); dense/chunked pay a cheap sqrt-free
    second pass. The stepper uses the count to ``lax.cond``-skip the
    collision resolution sweep — the reference instead pays a second full
    O(N^2) scan every step (core/physics.py:510-518).

    Returns None for force implementations without a fused-detect variant
    (mxu / pm / p3m / tree / ring) — callers then keep the user's force
    path and fall back to the unconditional resolution sweep. The Gram
    (mxu) and PM paths could not gate correctly anyway: their r^2 noise
    floor can sit above contact thresholds."""
    from ..ops.collisions import count_contacts_chunked, count_contacts_dense

    impl = _exact_impl(cfg, n)
    if impl == "pallas":
        from ..ops.pallas_forces import pairwise_acc_detect_pallas

        interpret = backend.INTERPRET
        return lambda pos, mass, radius, alive: pairwise_acc_detect_pallas(
            pos, mass, radius, alive, G=cfg.G, eps2=cfg.eps2,
            with_potential=cfg.track_potential, interpret=interpret)

    if impl == "dense":
        def fn(pos, mass, radius, alive):
            acc, U = pairwise_acc_dense(pos, mass, alive, G=cfg.G, eps2=cfg.eps2)
            return acc, U, count_contacts_dense(pos, radius, alive)
        return fn
    if impl == "chunked":
        def fn(pos, mass, radius, alive):
            acc, U = pairwise_acc_chunked(pos, mass, alive, G=cfg.G,
                                          eps2=cfg.eps2, chunk=min(cfg.chunk, n))
            return acc, U, count_contacts_chunked(pos, radius, alive,
                                                  chunk=min(cfg.chunk, n))
        return fn
    return None


def _jerk_impl(cfg: SimConfig, n: int) -> str:
    impl = cfg.force_impl
    if impl in ("pm", "p3m", "tree"):
        raise ValueError(
            "integrator='hermite' needs exact per-pair jerks, which the "
            f"mesh/tree solvers cannot provide; use kdk/euler/rk4 with "
            f"force_impl={impl!r}, or an exact force path for hermite")
    if impl in ("auto", "mxu", "ring"):
        return backend.exact_sweep_impl(n)
    return impl


def resolve_accel_jerk_fn(cfg: SimConfig, n: int):
    """Pick the combined acc+jerk implementation (Hermite) for a body count,
    mirroring :func:`resolve_force_fn`, so Hermite runs at the flagship N."""
    from ..ops.forces import accel_jerk_chunked, accel_jerk_dense

    impl = _jerk_impl(cfg, n)
    if impl == "dense":
        return lambda pos, vel, mass, alive: accel_jerk_dense(
            pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2)
    if impl == "chunked":
        return lambda pos, vel, mass, alive: accel_jerk_chunked(
            pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2,
            chunk=min(cfg.chunk, n))
    from ..ops.pallas_forces import accel_jerk_pallas

    interpret = backend.INTERPRET
    return lambda pos, vel, mass, alive: accel_jerk_pallas(
        pos, vel, mass, alive, G=cfg.G, eps2=cfg.eps2, interpret=interpret)


def resolve_accel_jerk_detect_fn(cfg: SimConfig, n: int):
    """Hermite acc+jerk with fused contact detection:
    ``fn(pos, vel, mass, radius, alive) -> (acc, jerk, U, contacts)``.
    On the GPU kernel detection rides the jerk sweep's r^2 tiles; the
    dense/chunked paths pay a cheap sqrt-free second pass at the same
    (predicted) positions. The Hermite stepper uses the count to
    lax.cond-skip its collision resolution sweep."""
    from ..ops.collisions import count_contacts_chunked, count_contacts_dense
    from ..ops.forces import accel_jerk_chunked, accel_jerk_dense

    impl = _jerk_impl(cfg, n)
    if impl == "dense":
        def fn(pos, vel, mass, radius, alive):
            acc, jerk, U = accel_jerk_dense(pos, vel, mass, alive,
                                            G=cfg.G, eps2=cfg.eps2)
            return acc, jerk, U, count_contacts_dense(pos, radius, alive)
        return fn
    if impl == "chunked":
        def fn(pos, vel, mass, radius, alive):
            acc, jerk, U = accel_jerk_chunked(pos, vel, mass, alive,
                                              G=cfg.G, eps2=cfg.eps2,
                                              chunk=min(cfg.chunk, n))
            return acc, jerk, U, count_contacts_chunked(
                pos, radius, alive, chunk=min(cfg.chunk, n))
        return fn
    from ..ops.pallas_forces import accel_jerk_detect_pallas

    interpret = backend.INTERPRET
    return lambda pos, vel, mass, radius, alive: accel_jerk_detect_pallas(
        pos, vel, mass, radius, alive, G=cfg.G, eps2=cfg.eps2,
        interpret=interpret)


def init_forces(state: NBodyState, cfg: SimConfig, force_fn: Optional[ForceFn] = None) -> NBodyState:
    """Seed the acceleration cache (the reference does this in the engine
    constructor, core/engine.py:41). Hermite also seeds the jerk cache."""
    if cfg.integrator == "hermite":
        aj = resolve_accel_jerk_fn(cfg, state.n_bodies)
        acc, jerk, potential = aj(state.pos, state.vel, state.mass, state.alive)
        return state.replace(acc=acc, jerk=jerk, potential=potential)
    fn = force_fn or resolve_force_fn(cfg, state.n_bodies)
    acc, potential = fn(state.pos, state.mass, state.alive)
    return state.replace(acc=acc, potential=potential)


def _snapshot(state: NBodyState) -> dict:
    from ..ops import diagnostics as diag

    vel = state.vel_full()
    return dict(
        pos=state.pos_full(),
        vel=vel,
        time=state.time,
        energy=diag.total_energy(vel, state.mass, state.potential),
        ang_mom=diag.angular_momentum(state.pos_full(), vel, state.mass),
        alive=state.alive,
    )


def rollout(
    state: NBodyState,
    cfg: SimConfig,
    steps: int,
    record_every: int = 0,
    force_fn: Optional[ForceFn] = None,
) -> tuple[NBodyState, Optional[Trajectory]]:
    """Advance ``steps`` steps; optionally record every ``record_every``-th.

    With recording, ``steps`` must divide into records; the snapshot after
    each block of ``record_every`` steps is stored (the initial state is not
    included — prepend it host-side for reference-style seeded history,
    core/engine.py:34).
    """
    fn = force_fn or resolve_force_fn(cfg, state.n_bodies)
    aj = (resolve_accel_jerk_fn(cfg, state.n_bodies)
          if cfg.integrator == "hermite" else None)
    fd = None
    ajd = None
    if cfg.collisions != "none" and cfg.integrator in ("kdk", "euler",
                                                       "rk4", "yoshida4"):
        # None for force paths without a fused-detect variant -> the
        # stepper keeps the user's force path + unconditional sweep
        fd = resolve_force_detect_fn(cfg, state.n_bodies)
    if cfg.collisions != "none" and cfg.integrator == "hermite":
        ajd = resolve_accel_jerk_detect_fn(cfg, state.n_bodies)
    step_fn = make_step_fn(cfg, fn, accel_jerk_fn=aj, force_detect_fn=fd,
                           accel_jerk_detect_fn=ajd)

    if record_every <= 0:
        final = lax.fori_loop(0, steps, lambda _, s: step_fn(s), state)
        return final, None

    if steps % record_every != 0:
        raise ValueError(f"steps={steps} not divisible by record_every={record_every}")
    n_records = steps // record_every

    def block(s: NBodyState, _):
        s = lax.fori_loop(0, record_every, lambda _, x: step_fn(x), s)
        return s, _snapshot(s)

    final, ys = lax.scan(block, state, None, length=n_records)
    return final, Trajectory(**ys)


@partial(jax.jit, static_argnames=("cfg", "steps", "record_every"))
def rollout_jit(
    state: NBodyState, cfg: SimConfig, steps: int, record_every: int = 0
) -> tuple[NBodyState, Optional[Trajectory]]:
    """jit-wrapped :func:`rollout` (cfg/steps/record_every static)."""
    return rollout(state, cfg, steps, record_every)


@partial(jax.jit, static_argnames=("dt", "ds32"))
def _staged_kick_drift(s: NBodyState, dt: float, ds32: bool) -> NBodyState:
    """KDK half-kick + drift, jitted ONCE per (dt, precision) — the
    staged loop calls it every step, so per-call closures would retrace
    and recompile on every rollout_staged invocation (and every viewer
    tick)."""
    from .integrators import _accumulate

    vel, vel_lo = _accumulate(s.vel, s.vel_lo, 0.5 * dt * s.acc)
    if not ds32:
        pos, pos_lo = _accumulate(s.pos, s.pos_lo, dt * vel)
    else:
        pos, pos_lo = _accumulate(s.pos, s.pos_lo, dt * vel, dt * vel_lo)
    return s.replace(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo)


@partial(jax.jit, static_argnames=("dt",))
def _staged_close(s: NBodyState, acc, potential, dt: float) -> NBodyState:
    from .integrators import _accumulate

    vel, vel_lo = _accumulate(s.vel, s.vel_lo, 0.5 * dt * acc)
    return s.replace(vel=vel, vel_lo=vel_lo, acc=acc, potential=potential,
                     time=s.time + dt, step=s.step + 1)


_snapshot_jit = None


def _staged_force_kwargs(cfg: SimConfig) -> dict:
    kw = dict(G_grav=cfg.G, eps2=cfg.eps2, levels=cfg.tree_levels,
              ws=cfg.tree_ws, order=cfg.tree_order, near=cfg.tree_near,
              max_chunks=cfg.tree_max_chunks,
              with_potential=cfg.track_potential,
              box=cfg.pm_box_arrays())
    if cfg.tree_near == "pairs":
        kw.update(chunk=cfg.tree_chunk,
                  pair_entries=tuple(cfg.tree_pair_entries))
    else:
        kw.update(capacity=cfg.tree_capacity, max_cells=cfg.tree_max_cells,
                  max_big=cfg.tree_max_big,
                  max_frontier=cfg.tree_max_frontier)
    return kw


@functools.lru_cache(maxsize=8)
def _staged_sharded_phase_fns(cfg: SimConfig, mesh, shard_axis: str):
    """Jitted shard_map programs for the tree's far and near phases over a
    body-sharded mesh — the multi-chip analog of the two host dispatches in
    :func:`rollout_staged`. Each returns ``(acc_shard, U, overflow)``.
    Memoized on (cfg, mesh, axis) — both frozen/hashable — so
    ``init_forces_staged`` + ``rollout_staged`` (and segmented reruns)
    share one pair of compiled programs instead of re-tracing."""
    from jax.sharding import PartitionSpec as P

    from ..ops.tree import tree_sharded_force

    kw = _staged_force_kwargs(cfg)
    n_shards = mesh.shape[shard_axis]

    def mk(phase):
        def f(p, m, a):
            return tree_sharded_force(
                p, m, a, axis_name=shard_axis, n_shards=n_shards,
                _phase=phase, with_overflow=True, **kw)

        return jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(shard_axis, None), P(shard_axis), P(shard_axis)),
            out_specs=(P(shard_axis, None), P(), P())))

    return mk("far"), mk("near")


def init_forces_staged(state: NBodyState, cfg: SimConfig,
                       mesh=None, shard_axis: str = "body") -> NBodyState:
    """:func:`init_forces` via the tree's two-program staged evaluation
    (companion of :func:`rollout_staged`). With ``mesh`` the two
    phases run sharded (see :func:`rollout_staged`) and the state is
    placed on the mesh."""
    if mesh is not None:
        from ..parallel.sharded import shard_state

        state = shard_state(mesh, state, shard_axis)
        far_fn, near_fn = _staged_sharded_phase_fns(cfg, mesh, shard_axis)
        a_f, u_f, _ = far_fn(state.pos, state.mass, state.alive)
        a_n, u_n, _ = near_fn(state.pos, state.mass, state.alive)
        return state.replace(acc=a_f + a_n, potential=u_f + u_n)
    from ..ops.tree import tree_acc_potential_staged

    acc, potential, _ = tree_acc_potential_staged(
        state.pos, state.mass, state.alive, **_staged_force_kwargs(cfg))
    return state.replace(acc=acc, potential=potential)


def rollout_staged(
    state: NBodyState,
    cfg: SimConfig,
    steps: int,
    record_every: int = 0,
    mesh=None,
    shard_axis: str = "body",
) -> tuple[NBodyState, Optional[Trajectory], int]:
    """Host-driven KDK rollout on the tree's STAGED two-program force.

    The compiled :func:`rollout` traces the force into one XLA program.
    This loop keeps the KDK update exactly as ``make_step_fn`` composes
    it (half-kick / drift / force / half-kick, ds32 accumulation
    included) but dispatches the far and near force phases as separate
    programs from the host (see ``ops.tree.tree_acc_potential_staged``),
    about 4 dispatches and one overflow read-back per step.

    With ``mesh`` (a ``jax.sharding.Mesh`` with a ``shard_axis`` body
    axis) the same loop runs MULTI-CHIP: the state lives body-sharded on
    the mesh, the kick/drift stays elementwise on local shards, and each
    phase dispatch is one shard_map program (``ops.tree.
    tree_sharded_force(_phase=...)`` — replicated conv far field;
    near-field sweeps split 1/n_devices per device + one psum). This is
    the path simulate() takes for the tree's own regime (N >= 512k) on
    a mesh.

    Requires ``integrator='kdk'``, ``collisions='none'``, and
    ``force_impl='tree'``. Returns ``(final, trajectory | None,
    max_overflow)`` — unlike the compiled hot loop, the near-field
    overflow counter is CHECKED every step and the maximum is returned
    (0 means every near pair was summed exactly for the whole run,
    for the staged path)."""
    from ..ops.tree import tree_acc_potential

    if cfg.integrator != "kdk" or cfg.collisions != "none":
        raise ValueError(
            "rollout_staged supports integrator='kdk' with "
            "collisions='none' (the staged force cannot live inside a "
            "compiled collision step)")
    if cfg.force_impl != "tree":
        raise ValueError("rollout_staged is the force_impl='tree' "
                         "large-N path; use rollout() otherwise")
    if record_every and steps % record_every != 0:
        raise ValueError(
            f"steps={steps} not divisible by record_every={record_every}")
    kw = _staged_force_kwargs(cfg)
    dt = float(cfg.dt)
    ds32 = state.vel_lo is not None
    if mesh is not None:
        from ..parallel.sharded import shard_state

        state = shard_state(mesh, state, shard_axis)
        far_fn, near_fn = _staged_sharded_phase_fns(cfg, mesh, shard_axis)
    else:
        def far_fn(p, m, a):
            return tree_acc_potential(p, m, a, _phase="far", **kw)

        def near_fn(p, m, a):
            return tree_acc_potential(p, m, a, _phase="near", **kw)

    global _snapshot_jit
    if _snapshot_jit is None:
        _snapshot_jit = jax.jit(_snapshot)
    snap = _snapshot_jit
    records: list = []
    max_overflow = 0
    for i in range(steps):
        state = _staged_kick_drift(state, dt, ds32)
        a_f, u_f, _ = far_fn(state.pos, state.mass, state.alive)
        a_n, u_n, ovf = near_fn(state.pos, state.mass, state.alive)
        max_overflow = max(max_overflow, int(ovf))
        state = _staged_close(state, a_f + a_n, u_f + u_n, dt)
        if record_every and (i + 1) % record_every == 0:
            records.append(snap(state))
    if not record_every:
        return state, None, max_overflow
    if not records:
        # steps=0: same empty-Trajectory contract as the compiled rollout
        z = snap(state)
        stacked = {k: jnp.zeros((0,) + v.shape, v.dtype)
                   for k, v in z.items()}
        return state, Trajectory(**stacked), max_overflow
    stacked = {k: jnp.stack([r[k] for r in records])
               for k in records[0]}
    return state, Trajectory(**stacked), max_overflow
