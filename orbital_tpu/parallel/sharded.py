"""Body-sharded O(N^2) forces: a shard_map ppermute ring between devices.

The O(N^2) interaction sweep is structurally identical to unnormalized
attention scores, so the multi-chip strategy is ring attention's (see
SURVEY §5): each device keeps its body shard ("queries") resident and a
rotating copy of another shard ("keys" = positions+masses) streams around
the ring via ``lax.ppermute``; every round contributes partial
accelerations and potential. After D rounds every shard has seen every
body. XLA overlaps the ppermute with the force block of the previous round.

No NCCL/MPI equivalent is hand-built: the collectives are XLA's, laid out
by ``shard_map`` over a ``Mesh`` (NCCL between GPUs).

Each round's block force is the exact-sweep choice of ``ops.backend``
(the GPU kernel or a row-chunked XLA block), never a dense [B, B] block
past 4096 bodies per shard. Cross-shard bounce collisions
ride the same ring (``ring_bounce_fn``); cross-shard merge gates an
all_gather + exact global merge on a ring contact count
(``ring_contacts_fn``), so contact-free steps never gather.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..engine.integrators import ForceFn, make_step_fn
from ..engine.state import NBodyState
from ..ops import backend
from ..ops.forces import block_acc_chunked, block_acc_dense
from ..utils.config import SimConfig

__all__ = ["ring_force_fn", "ring_bounce_fn", "make_sharded_step",
           "make_sharded_rollout", "make_sharded_respa_rollout",
           "make_sharded_ensemble_step", "state_sharding", "shard_state"]


def _ring_block_impl(cfg: SimConfig, block: int) -> str:
    """The ring's per-round block force for ``block`` bodies per shard:
    ``cfg.ring_block_impl``, with "auto" resolved like the single-device
    exact sweep (``ops.backend.exact_sweep_impl``)."""
    if cfg.ring_block_impl == "auto":
        return backend.exact_sweep_impl(block)
    return cfg.ring_block_impl


def _check_vma(cfg: SimConfig, n: int, n_shards: int) -> bool:
    """shard_map's varying-manual-axes checker does not see through
    pallas_call, so disable it exactly when the ring's exact force runs
    the Pallas block kernel and keep it on otherwise."""
    return not (cfg.force_impl in ("auto", "pallas", "ring")
                and _ring_block_impl(cfg, n // n_shards) == "pallas")


def _block_bounce(pos_i, vel_i, mass_i, radius_i,
                  pos_j, vel_j, mass_j, radius_j, alive_j,
                  *, restitution: float):
    """Partial bounce impulses of visiting shard j on local shard i.

    Mirrors ``ops.collisions.bounce_deltas`` pair math (reference impulse
    model, core/physics.py:391-422) for an (i-shard, j-shard) block. Exact
    self-pairs are excluded by the dist > 0 requirement, so the diagonal
    round needs no index masking.
    """
    dx = pos_i[:, None, 0] - pos_j[None, :, 0]
    dy = pos_i[:, None, 1] - pos_j[None, :, 1]
    dz = pos_i[:, None, 2] - pos_j[None, :, 2]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    touching = (
        alive_j[None, :]
        & (dist <= radius_i[:, None] + radius_j[None, :])
        & (dist > 0.0)
        & (mass_j[None, :] > 0.0)
    )
    inv_d = jnp.where(dist > 0.0, 1.0 / jnp.where(dist > 0.0, dist, 1.0), 0.0)
    nx, ny, nz = dx * inv_d, dy * inv_d, dz * inv_d

    v_rel_n = ((vel_i[:, None, 0] - vel_j[None, :, 0]) * nx
               + (vel_i[:, None, 1] - vel_j[None, :, 1]) * ny
               + (vel_i[:, None, 2] - vel_j[None, :, 2]) * nz)
    active = touching & (v_rel_n < 0.0)

    inv_mi = jnp.where(mass_i > 0.0, 1.0 / jnp.where(mass_i > 0.0, mass_i, 1.0), 0.0)
    inv_mj = jnp.where(mass_j > 0.0, 1.0 / jnp.where(mass_j > 0.0, mass_j, 1.0), 0.0)
    inv_sum = inv_mi[:, None] + inv_mj[None, :]
    e = min(max(float(restitution), 0.0), 1.0)
    j_mag = jnp.where(active, -(1.0 + e) * v_rel_n / inv_sum, 0.0)

    scale_v = j_mag * inv_mi[:, None]
    dvel = jnp.stack([jnp.sum(scale_v * nx, axis=1),
                      jnp.sum(scale_v * ny, axis=1),
                      jnp.sum(scale_v * nz, axis=1)], axis=-1)

    overlap = radius_i[:, None] + radius_j[None, :] - dist
    corr = jnp.where(active & (overlap > 0.0), overlap / inv_sum, 0.0)
    scale_r = corr * inv_mi[:, None]
    dpos = jnp.stack([jnp.sum(scale_r * nx, axis=1),
                      jnp.sum(scale_r * ny, axis=1),
                      jnp.sum(scale_r * nz, axis=1)], axis=-1)
    return dpos, dvel


def ring_bounce_fn(cfg: SimConfig, n_shards: int):
    """Cross-shard restitution collisions over the same ppermute ring as
    the forces: each round contributes the visiting shard's impulses on the
    local bodies; impulses are computed from pre-collision velocities
    everywhere (consistent with the unsharded ``bounce_deltas``)."""
    axis = cfg.shard_axis
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def fn(pos, vel, mass, radius, alive):
        mass_eff = mass * alive.astype(mass.dtype)

        def round_k(k, carry):
            dpos, dvel, visit = carry
            pos_j, vel_j, mass_j, radius_j, alive_j = visit
            dp, dv = _block_bounce(pos, vel, mass_eff, radius,
                                   pos_j, vel_j, mass_j, radius_j, alive_j,
                                   restitution=cfg.restitution)
            visit = tuple(lax.ppermute(x, axis, perm=fwd) for x in visit)
            return dpos + dp, dvel + dv, visit

        zeros = jnp.zeros_like(pos)
        visit0 = (pos, vel, mass_eff, radius, alive)
        dpos, dvel, _ = lax.fori_loop(0, n_shards, round_k,
                                      (zeros, zeros, visit0))
        keep = alive[:, None].astype(pos.dtype)
        return dpos * keep, dvel * keep

    return fn



def _mesh_force_fn(cfg: SimConfig, axis: str, n_shards: int):
    """PM / P3M force closure for a body-sharded axis (shared by the 1D
    and 2D step builders so their force dispatch can't drift apart). PM is
    local deposit + one grid psum; P3M additionally rings its short-range
    cell-list correction (see ops.p3m.p3m_ring_force for the scaling
    contract)."""
    pm_box = cfg.pm_box_arrays()

    if cfg.force_impl == "tree":
        from ..ops.tree import tree_sharded_force

        def force(pos, mass, alive):
            return tree_sharded_force(
                pos, mass, alive, axis_name=axis, n_shards=n_shards,
                G_grav=cfg.G, eps2=cfg.eps2, levels=cfg.tree_levels,
                capacity=cfg.tree_capacity, ws=cfg.tree_ws,
                max_cells=cfg.tree_max_cells, order=cfg.tree_order,
                max_big=cfg.tree_max_big, near=cfg.tree_near,
                max_frontier=cfg.tree_max_frontier,
                max_chunks=cfg.tree_max_chunks, chunk=cfg.tree_chunk,
                pair_entries=tuple(cfg.tree_pair_entries),
                with_potential=cfg.track_potential, box=pm_box)
        return force

    if cfg.force_impl == "p3m":
        from ..ops.p3m import p3m_ring_force

        def force(pos, mass, alive):
            return p3m_ring_force(pos, mass, alive, G_grav=cfg.G,
                                  eps2=cfg.eps2, grid=cfg.pm_grid,
                                  capacity=cfg.p3m_capacity,
                                  with_potential=cfg.track_potential,
                                  box=pm_box, axis_name=axis,
                                  n_shards=n_shards)
        return force

    from ..ops.pm import pm_acc_potential

    def force(pos, mass, alive):
        return pm_acc_potential(pos, mass, alive, G_grav=cfg.G,
                                eps2=cfg.eps2, grid=cfg.pm_grid,
                                with_potential=cfg.track_potential,
                                axis_name=axis, box=pm_box)

    return force


def ring_contacts_fn(cfg: SimConfig, n_shards: int):
    """Global directed touching-pair count over the sharded system: each
    ring round counts local-vs-visiting contacts with the sqrt-free
    geometric test (global ids travel with the visiting block so self-pairs
    are excluded exactly); one psum replicates the total. Used to
    lax.cond-gate the merge gather — contact-free steps (the overwhelming
    majority) pay only this cheap sweep."""
    from ..ops.collisions import _contacts_block

    axis = cfg.shard_axis
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def fn(pos, radius, alive):
        block = pos.shape[0]
        ids = (lax.axis_index(axis) * block
               + jnp.arange(block)).astype(jnp.int32)

        def round_k(k, carry):
            cnt, visit = carry
            pos_j, rad_j, alive_j, ids_j = visit
            cnt = cnt + _contacts_block(pos, radius, alive, ids,
                                        pos_j, rad_j, alive_j, ids_j)
            visit = tuple(lax.ppermute(x, axis, perm=fwd) for x in visit)
            return cnt, visit

        # the initial count derives from a shard-varying value so the
        # carry's varying-manual-axes match the loop body's output
        cnt0 = jnp.sum(ids, dtype=jnp.int32) * 0
        cnt, _ = lax.fori_loop(
            0, n_shards, round_k, (cnt0, (pos, radius, alive, ids)))
        return lax.psum(cnt, axis)

    return fn


def ring_force_fn(cfg: SimConfig, n_shards: int) -> ForceFn:
    """ForceFn for use *inside* shard_map: per-device shards in, per-device
    acc shard + replicated total potential out.

    Each round's [local x visiting] block force runs through
    :func:`_ring_block_impl`: the GPU kernel
    (``ops.pallas_forces.block_acc_pallas``) on the GPU, a row-chunked
    XLA block on the CPU, dense only for small shards."""
    axis = cfg.shard_axis
    if axis is None:
        raise ValueError("ring force requires cfg.shard_axis")
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def fn(pos, mass, alive):
        mass_eff = mass * alive.astype(mass.dtype)
        block = pos.shape[0]
        impl = _ring_block_impl(cfg, block)
        kw = dict(G=cfg.G, eps2=cfg.eps2)

        def block_force(pos_i, pos_j, mass_j):
            if impl == "pallas":
                from ..ops.pallas_forces import block_acc_pallas

                return block_acc_pallas(
                    pos_i, pos_j, mass_j, vma=(axis,),
                    interpret=backend.INTERPRET, **kw)
            if impl == "chunked":
                return block_acc_chunked(pos_i, pos_j, mass_j,
                                         chunk=min(cfg.chunk, block), **kw)
            return block_acc_dense(pos_i, pos_j, mass_j, **kw)

        def round_k(k, carry):
            acc, pe, pos_j, mass_j = carry
            a_k, pe_k = block_force(pos, pos_j, mass_j)
            acc = acc + a_k
            pe = pe + pe_k
            pos_j = lax.ppermute(pos_j, axis, perm=fwd)
            mass_j = lax.ppermute(mass_j, axis, perm=fwd)
            return acc, pe, pos_j, mass_j

        acc0 = jnp.zeros_like(pos)
        pe0 = jnp.zeros_like(mass)
        acc, pe_row, _, _ = lax.fori_loop(
            0, n_shards, round_k, (acc0, pe0, pos, mass_eff)
        )
        acc = acc * alive[:, None].astype(acc.dtype)
        if cfg.eps2 > 0.0:
            # remove the analytic self-term included by the mask-free sweep
            pe_row = pe_row - mass_eff * (1.0 / float(cfg.eps2) ** 0.5)
        U = -0.5 * cfg.G * lax.psum(jnp.sum(mass_eff * pe_row), axis)
        return acc, U

    return fn


def state_sharding(mesh: Mesh, state: NBodyState, axis: str = "body"):
    """NamedSharding pytree for a body-sharded state (scalars replicated)."""
    specs = _state_specs(state, axis)
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_state(mesh: Mesh, state: NBodyState, axis: str = "body") -> NBodyState:
    """Place a host-built state onto the mesh with body sharding."""
    return jax.device_put(state, state_sharding(mesh, state, axis))


def _state_specs(state: NBodyState, axis: str) -> NBodyState:
    """PartitionSpec pytree matching a state (scalars replicated)."""
    mat, vec, rep = P(axis, None), P(axis), P()
    return NBodyState(
        pos=mat, vel=mat, mass=vec, radius=vec, alive=vec, acc=mat,
        potential=rep, time=rep, step=rep,
        pos_lo=mat if state.pos_lo is not None else None,
        vel_lo=mat if state.vel_lo is not None else None,
        jerk=mat if state.jerk is not None else None,
    )


def _normalize_sharded_cfg(cfg: SimConfig, axis: str) -> tuple[SimConfig, bool]:
    """Resolve the force routing for a body-sharded axis: mesh solvers
    (pm/p3m/tree) keep their impl, everything else becomes the ring."""
    use_mesh_solver = cfg.force_impl in ("pm", "p3m", "tree")
    cfg = cfg.replace(shard_axis=axis,
                      force_impl=cfg.force_impl if use_mesh_solver else "ring")
    return cfg, use_mesh_solver


def _resolve_gathered_fn(cfg: SimConfig, n_bodies: int, axis: str):
    """Resolve-outcome pass for a body-sharded axis: all_gather the body
    arrays, run the UNCHANGED outcome model (dense below the ceiling, the
    contact-subset wrapper above it) replicated on every device — the
    step counter is replicated, so the per-step PRNG fold and therefore
    the fragmentation rolls are identical mesh-wide — and slice the local
    shard back out. Same gather-run-slice shape as the cross-shard merge
    above; the outcome model itself is ops.collisions.resolve_outcomes /
    resolve_outcomes_subset verbatim (reference semantics:
    core/physics.py:361-388)."""
    from ..engine.integrators import _DENSE_BOUNCE_MAX_N
    from ..ops import collisions as _coll

    kw = dict(restitution=cfg.restitution, debris_k=cfg.debris_k,
              debris_max_pairs=cfg.debris_max_pairs,
              debris_energy_frac=cfg.debris_energy_frac,
              debris_sep=cfg.debris_sep)

    def do_resolve(s: NBodyState) -> NBodyState:
        def g(x):
            return lax.all_gather(x, axis, tiled=True)

        key = jax.random.fold_in(jax.random.PRNGKey(cfg.frag_seed),
                                 s.step)
        args = (g(s.pos_full()), g(s.vel_full()), g(s.mass),
                g(s.radius), g(s.alive), key)
        if n_bodies > _DENSE_BOUNCE_MAX_N:
            p, v, m, r, a, _ = _coll.resolve_outcomes_subset(
                *args, subset=cfg.resolve_subset, **kw)
        else:
            p, v, m, r, a = _coll.resolve_outcomes(*args, **kw)
        block = s.pos.shape[0]
        off = lax.axis_index(axis) * block

        def sl(x):
            return lax.dynamic_slice_in_dim(x, off, block, axis=0)

        out = dict(pos=sl(p), vel=sl(v), mass=sl(m), radius=sl(r),
                   alive=sl(a))
        if s.pos_lo is not None:
            # like the unsharded resolve: compensation terms reset
            out["pos_lo"] = jnp.zeros_like(s.pos_lo)
            out["vel_lo"] = jnp.zeros_like(s.vel_lo)
        return s.replace(**out)

    return do_resolve


def _build_local_step(cfg: SimConfig, n_shards: int, n_bodies: int,
                      use_mesh_solver: bool):
    """The per-device step closure shared by :func:`make_sharded_step` and
    :func:`make_sharded_rollout` — runs INSIDE shard_map on local shards."""
    axis = cfg.shard_axis
    if use_mesh_solver:
        # mesh solvers across the mesh: local deposit + one psum of the
        # grid (PM), plus a ringed short-range correction (P3M) or a
        # sharded near-field sweep (tree); the O(N^2) ring never runs
        force = _mesh_force_fn(cfg, axis, n_shards)
    else:
        force = ring_force_fn(cfg, n_shards)
    kdk = make_step_fn(cfg.replace(collisions="none"), force)

    if cfg.collisions == "bounce":
        from ..engine.integrators import _accumulate

        bounce = ring_bounce_fn(cfg, n_shards)
        contacts = ring_contacts_fn(cfg, n_shards)

        def local_step(state: NBodyState) -> NBodyState:
            state = kdk(state)
            # same gating as the single-chip fused-detect path
            # (integrators._apply_collisions): a cheap sqrt-free detection
            # ring counts contacts mesh-wide, and the full impulse ring —
            # ~4x the per-pair arithmetic plus the accumulation passes —
            # runs only on steps where something actually touches. The
            # count is psum'd, so every device takes the same branch.
            cnt = contacts(state.pos, state.radius, state.alive)

            def do_bounce(s: NBodyState) -> NBodyState:
                dpos, dvel = bounce(s.pos, s.vel, s.mass,
                                    s.radius, s.alive)
                pos, pos_lo = _accumulate(s.pos, s.pos_lo, dpos)
                vel, vel_lo = _accumulate(s.vel, s.vel_lo, dvel)
                return s.replace(pos=pos, pos_lo=pos_lo, vel=vel,
                                 vel_lo=vel_lo)

            return lax.cond(cnt > 0, do_bounce, lambda s: s, state)
    elif cfg.collisions == "merge":
        # cross-shard merge: contact chains are global, so when (and only
        # when) the ring contact count is nonzero, all_gather the body
        # arrays (a few MB at 65k), run the exact global merge,
        # and slice the local shard back out. Contact-free steps pay one
        # cheap detection ring and no gather.
        from ..ops import collisions as _coll

        contacts = ring_contacts_fn(cfg, n_shards)
        merge_chunk = 1024 if n_bodies > 4096 else None

        def local_step(state: NBodyState) -> NBodyState:
            state = kdk(state)
            cnt = contacts(state.pos, state.radius, state.alive)

            def do_merge(s: NBodyState) -> NBodyState:
                def g(x):
                    return lax.all_gather(x, axis, tiled=True)

                p, v, m, r, a = _coll.merge_groups(
                    g(s.pos_full()), g(s.vel_full()), g(s.mass),
                    g(s.radius), g(s.alive), chunk=merge_chunk)
                block = s.pos.shape[0]
                off = lax.axis_index(axis) * block

                def sl(x):
                    return lax.dynamic_slice_in_dim(x, off, block, axis=0)

                kw = dict(pos=sl(p), vel=sl(v), mass=sl(m), radius=sl(r),
                          alive=sl(a))
                if s.pos_lo is not None:
                    # like the unsharded merge: compensation terms reset
                    kw["pos_lo"] = jnp.zeros_like(s.pos_lo)
                    kw["vel_lo"] = jnp.zeros_like(s.vel_lo)
                return s.replace(**kw)

            return lax.cond(cnt > 0, do_merge, lambda s: s, state)
    elif cfg.collisions == "resolve":
        # absorb/fragment/bounce outcome model across shards: gated on
        # the same psum'd ring contact count as merge, then the
        # gather-run-slice pass of _resolve_gathered_fn
        contacts = ring_contacts_fn(cfg, n_shards)
        do_resolve = _resolve_gathered_fn(cfg, n_bodies, axis)

        def local_step(state: NBodyState) -> NBodyState:
            state = kdk(state)
            cnt = contacts(state.pos, state.radius, state.alive)
            return lax.cond(cnt > 0, do_resolve, lambda s: s, state)
    else:
        local_step = kdk
    return local_step


def make_sharded_step(cfg: SimConfig, mesh: Mesh, state_example: NBodyState,
                      axis: Optional[str] = None):
    """Compiled full simulation step over a body-sharded mesh.

    Returns a jitted ``step(state) -> state`` where every body array of
    ``state`` is sharded along ``axis`` of ``mesh``. The KDK update runs
    elementwise on local shards. Force collectives by path: the exact
    force is the ppermute ring plus one psum for the potential;
    ``force_impl="pm"`` instead runs NO ring — pmin/pmax agree the mesh
    box (skipped with a static ``cfg.pm_box``) and one psum of the G^3
    mass grid globalizes the density; ``force_impl="p3m"`` adds a
    ppermute ring for its short-range cell-list correction (memory
    scales, short-range compute is ring-replicated — see
    ops.p3m.p3m_ring_force); ``force_impl="tree"`` psums the deposited
    moment grids (far field) and splits the near-field sweep across
    shards (see ops.tree.tree_sharded_force). Collision modes add their
    own (bounce: impulse ring; merge: contact-count ring + gated
    all_gather).
    """
    axis = axis or cfg.shard_axis or "body"
    cfg, use_mesh_solver = _normalize_sharded_cfg(cfg, axis)
    n_shards = mesh.shape[axis]
    n_bodies = state_example.n_bodies
    if n_bodies % n_shards != 0:
        raise ValueError(f"N={n_bodies} must divide across {n_shards} shards "
                         f"(pad via make_state(pad_to=...))")
    local_step = _build_local_step(cfg, n_shards, n_bodies, use_mesh_solver)

    spec = _state_specs(state_example, axis)
    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=(spec,),
                            out_specs=spec,
                            check_vma=_check_vma(cfg, n_bodies, n_shards))
    return jax.jit(sharded)


def make_sharded_rollout(cfg: SimConfig, mesh: Mesh,
                         state_example: NBodyState, steps: int,
                         record_every: int = 0,
                         axis: Optional[str] = None):
    """Compiled multi-step sharded rollout: ``lax.scan`` of the sharded
    step INSIDE ``shard_map``, with strided on-device recording.

    The single-device analog is :func:`orbital_tpu.engine.rollout.rollout`;
    here the whole rollout — every step's ring/psum collectives included —
    is one XLA program per call, so multi-chip runs pay one dispatch per
    rollout instead of one per step. Returns a jitted
    ``roll(state) -> (final_state, Trajectory | None)`` where the body
    arrays of both the input state and the recorded ``Trajectory`` are
    sharded along ``axis`` (records assemble to global [R, N, ...] arrays
    across the mesh); energy / angular momentum records are global (psum)
    and replicated. With ``record_every=0`` no trajectory is recorded and
    the second return is None.
    """
    axis = axis or cfg.shard_axis or "body"
    cfg, use_mesh_solver = _normalize_sharded_cfg(cfg, axis)
    n_shards = mesh.shape[axis]
    n_bodies = state_example.n_bodies
    if n_bodies % n_shards != 0:
        raise ValueError(f"N={n_bodies} must divide across {n_shards} shards "
                         f"(pad via make_state(pad_to=...))")
    if record_every > 0 and steps % record_every != 0:
        raise ValueError(
            f"steps={steps} not divisible by record_every={record_every}")
    local_step = _build_local_step(cfg, n_shards, n_bodies, use_mesh_solver)

    from ..engine.rollout import Trajectory
    from ..ops import diagnostics as diag

    def snapshot(s: NBodyState) -> dict:
        vel = s.vel_full()
        pos = s.pos_full()
        # kinetic/angular sums span the mesh; potential is already
        # replicated (every force path psums it)
        K = lax.psum(diag.kinetic_energy(vel, s.mass), axis)
        L = lax.psum(diag.angular_momentum(pos, vel, s.mass), axis)
        return dict(pos=pos, vel=vel, time=s.time,
                    energy=K + s.potential, ang_mom=L, alive=s.alive)

    def local_roll(state: NBodyState):
        if record_every <= 0:
            return lax.fori_loop(0, steps, lambda _, s: local_step(s),
                                 state), None

        def block(s: NBodyState, _):
            s = lax.fori_loop(0, record_every, lambda _, x: local_step(x), s)
            return s, snapshot(s)

        final, ys = lax.scan(block, state, None,
                             length=steps // record_every)
        return final, Trajectory(**ys)

    spec = _state_specs(state_example, axis)
    if record_every > 0:
        traj_spec = Trajectory(
            pos=P(None, axis, None), vel=P(None, axis, None), time=P(),
            energy=P(), ang_mom=P(), alive=P(None, axis))
    else:
        traj_spec = None
    sharded = jax.shard_map(local_roll, mesh=mesh, in_specs=(spec,),
                            out_specs=(spec, traj_spec),
                            check_vma=_check_vma(cfg, n_bodies, n_shards))
    return jax.jit(sharded)


def _gather_state_full(s: NBodyState, axis: str) -> NBodyState:
    """all_gather every body-sharded array of a state to full N (scalars
    are already replicated). Used by the sharded multirate rollout, whose
    inner slot-space loop wants the whole system on every device."""
    def g(x):
        return (lax.all_gather(x, axis, axis=0, tiled=True)
                if x is not None else None)

    return s.replace(pos=g(s.pos), vel=g(s.vel), mass=g(s.mass),
                     radius=g(s.radius), alive=g(s.alive), acc=g(s.acc),
                     pos_lo=g(s.pos_lo), vel_lo=g(s.vel_lo),
                     jerk=g(s.jerk))


def _slice_state_local(s: NBodyState, axis: str, block: int) -> NBodyState:
    """Inverse of :func:`_gather_state_full`: slice this device's body
    shard back out of a replicated full state."""
    off = lax.axis_index(axis) * block

    def sl(x):
        return (lax.dynamic_slice_in_dim(x, off, block, axis=0)
                if x is not None else None)

    return s.replace(pos=sl(s.pos), vel=sl(s.vel), mass=sl(s.mass),
                     radius=sl(s.radius), alive=sl(s.alive), acc=sl(s.acc),
                     pos_lo=sl(s.pos_lo), vel_lo=sl(s.vel_lo),
                     jerk=sl(s.jerk))


def make_sharded_respa_rollout(cfg: SimConfig, mesh: Mesh,
                               state_example: NBodyState, steps: int,
                               record_every: int = 0,
                               axis: Optional[str] = None):
    """Compiled multi-chip multirate (RESPA) rollout: scan of the sharded
    macro window inside ``shard_map``.

    What shards (the two phases that carry essentially all the FLOPs):

    * the CLOSING exact O(N^2) evaluation, one per macro window — the
      ppermute ring (:func:`ring_force_fn`), each device sweeping its
      body shard through the exact-sweep block (1/D of the pair work);
    * the per-substep switched NEAR sweep — each device sweeps its
      ``1/D`` slice of the frozen i-chunk table against the global j side
      (``near_acc_slots*(..., i0=...)``) and one all_gather of the
      slot-ordered acc rows reassembles the table (~K_ch*C*16 bytes per
      substep).

    What replicates: the neighbor-geometry build (once per
    ``respa_refresh`` windows), pack/unpack, and the elementwise
    slot-space KDK updates — all O(N) with tiny constants at the 65k+
    scales where the multirate stepper matters. The state travels
    body-sharded at the API boundary (same specs as
    :func:`make_sharded_rollout`); inside, each macro runs on a
    replicated full copy (one all_gather per rollout — not per window).

    Collisions (macro-boundary contract, ``engine/multirate.py``): the
    detection-fused closing evaluation and the outcome pass run
    REPLICATED on the full state — correct, but the closing eval then
    doesn't shard; prefer ``collisions='none'`` + segment boundaries for
    production multi-chip runs.

    Returns a jitted ``roll(state) -> (final, Trajectory | None, diag)``
    with ``diag`` the window-max overflow/skin counters (replicated),
    exactly like :func:`orbital_tpu.engine.multirate.respa_rollout`.
    """
    from ..engine.multirate import make_respa_macro
    from ..engine.rollout import (Trajectory, _snapshot,
                                  resolve_force_detect_fn)

    axis = axis or cfg.shard_axis or "body"
    cfg = cfg.replace(shard_axis=axis)
    n_shards = mesh.shape[axis]
    n_bodies = state_example.n_bodies
    K = int(cfg.respa_k)
    if n_bodies % n_shards:
        raise ValueError(f"N={n_bodies} must divide across {n_shards} "
                         f"shards (pad via make_state(pad_to=...))")
    if steps % K:
        raise ValueError(f"steps={steps} must divide by respa_k={K}")
    if record_every > 0 and (record_every % K or steps % record_every):
        raise ValueError(
            f"record_every={record_every} must be a multiple of "
            f"respa_k={K} and divide steps={steps}")
    block = n_bodies // n_shards

    ring = ring_force_fn(cfg.replace(force_impl="ring"), n_shards)

    def force_full(pos, mass, alive):
        """Closing exact evaluation for the macro's full (replicated)
        positions: slice the local shard, ring it, gather the acc rows
        back. U comes out psum'd (replicated) from the ring."""
        off = lax.axis_index(axis) * block

        def sl(x):
            return lax.dynamic_slice_in_dim(x, off, block, axis=0)

        acc_l, U = ring(sl(pos), sl(mass), sl(alive))
        return lax.all_gather(acc_l, axis, axis=0, tiled=True), U

    fd = (resolve_force_detect_fn(cfg, n_bodies)
          if cfg.collisions != "none" else None)
    macro = make_respa_macro(cfg, force_full, force_detect_fn=fd,
                             shard=(axis, n_shards))
    M = int(cfg.respa_refresh)
    n_macros = steps // K

    def step_d(carry, i):
        s, geom, diag = carry
        geom = lax.cond((i % M == 0) & (i > 0),
                        lambda: macro.build_geom(s), lambda: geom)
        s, d = macro(s, geom)
        return (s, geom, {k: jnp.maximum(diag[k], d[k]) for k in diag}), None

    def local_roll(s_local):
        s = _gather_state_full(s_local, axis)
        zero = jnp.zeros((), jnp.int32)
        diag0 = dict(overflow=zero, cap_overflow=zero, w_overflow=zero,
                     skin_violation=zero)
        geom0 = macro.build_geom(s)
        if record_every <= 0:
            (final, _, diag), _ = lax.scan(
                step_d, (s, geom0, diag0), jnp.arange(n_macros))
            return _slice_state_local(final, axis, block), None, diag

        per_block = record_every // K
        n_records = steps // record_every

        def rec_block(carry, b):
            carry, _ = lax.scan(step_d, carry,
                                b * per_block + jnp.arange(per_block))
            snap = _snapshot(carry[0])
            off = lax.axis_index(axis) * block
            for k in ("pos", "vel", "alive"):
                snap[k] = lax.dynamic_slice_in_dim(snap[k], off, block,
                                                   axis=0)
            return carry, snap

        (final, _, diag), ys = lax.scan(
            rec_block, (s, geom0, diag0), jnp.arange(n_records))
        return _slice_state_local(final, axis, block), Trajectory(**ys), diag

    spec = _state_specs(state_example, axis)
    if record_every > 0:
        traj_spec = Trajectory(
            pos=P(None, axis, None), vel=P(None, axis, None), time=P(),
            energy=P(), ang_mom=P(), alive=P(None, axis))
    else:
        traj_spec = None
    diag_spec = dict(overflow=P(), cap_overflow=P(), w_overflow=P(),
                     skin_violation=P())
    # check_vma=False: the replicated-inner-state pattern (axis_index
    # slices re-gathered every sweep) plus the Pallas block kernel
    # (see _check_vma) both sit outside what the varying-manual-axes
    # checker can currently express
    sharded = jax.shard_map(local_roll, mesh=mesh, in_specs=(spec,),
                            out_specs=(spec, traj_spec, diag_spec),
                            check_vma=False)
    return jax.jit(sharded)


def make_sharded_ensemble_step(cfg: SimConfig, mesh: Mesh,
                               state_example: NBodyState,
                               ensemble_axis: str = "ensemble",
                               body_axis: str = "body"):
    """Compiled step over a 2D (ensemble x body) mesh.

    Data parallelism over independent ensemble members (vmapped locally, no
    collectives) composed with the ppermute ring over the body axis.
    ``state_example`` must carry a leading ensemble axis on every array;
    returns ``(step, shardings)`` where ``shardings`` places a batched
    state onto the mesh.
    """
    cfg, use_mesh_solver = _normalize_sharded_cfg(cfg, body_axis)
    n_body_shards = mesh.shape[body_axis]
    n_bodies = state_example.pos.shape[-2]
    if n_bodies % n_body_shards != 0:
        raise ValueError(f"N={n_bodies} must divide across {n_body_shards} shards")

    if use_mesh_solver:
        force = _mesh_force_fn(cfg, body_axis, n_body_shards)
    else:
        force = ring_force_fn(cfg, n_body_shards)
    kdk = make_step_fn(cfg.replace(collisions="none"), force)
    if cfg.collisions == "bounce":
        from ..engine.integrators import _accumulate

        bounce = ring_bounce_fn(cfg, n_body_shards)

        def one(state: NBodyState) -> NBodyState:
            state = kdk(state)
            dpos, dvel = bounce(state.pos, state.vel, state.mass,
                                state.radius, state.alive)
            pos, pos_lo = _accumulate(state.pos, state.pos_lo, dpos)
            vel, vel_lo = _accumulate(state.vel, state.vel_lo, dvel)
            return state.replace(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo)
    elif cfg.collisions == "merge":
        # merge under the vmapped ensemble: vmap turns lax.cond into
        # select (both branches execute), so the contact gate of
        # _build_local_step buys nothing here — the gather + global merge
        # run UNCONDITIONALLY every step instead, which is correct and
        # exactly as expensive as the gated version would be under vmap.
        # Per-member independence is preserved: the all_gather is over the
        # BODY axis only; vmap batches it across members.
        from ..ops import collisions as _coll

        merge_chunk = 1024 if n_bodies > 4096 else None

        def one(state: NBodyState) -> NBodyState:
            state = kdk(state)

            def g(x):
                return lax.all_gather(x, body_axis, tiled=True)

            p, v, m, r, a = _coll.merge_groups(
                g(state.pos_full()), g(state.vel_full()), g(state.mass),
                g(state.radius), g(state.alive), chunk=merge_chunk)
            block = state.pos.shape[0]
            off = lax.axis_index(body_axis) * block

            def sl(x):
                return lax.dynamic_slice_in_dim(x, off, block, axis=0)

            kw = dict(pos=sl(p), vel=sl(v), mass=sl(m), radius=sl(r),
                      alive=sl(a))
            if state.pos_lo is not None:
                # like the unsharded merge: compensation terms reset
                kw["pos_lo"] = jnp.zeros_like(state.pos_lo)
                kw["vel_lo"] = jnp.zeros_like(state.vel_lo)
            return state.replace(**kw)
    elif cfg.collisions == "resolve":
        # same unconditional-under-vmap rationale as merge above; each
        # member's step counter is its own, so per-member fragmentation
        # rolls stay independent and reproducible
        do_resolve = _resolve_gathered_fn(cfg, n_bodies, body_axis)

        def one(state: NBodyState) -> NBodyState:
            return do_resolve(kdk(state))
    else:
        one = kdk

    mat = P(ensemble_axis, body_axis, None)
    vec = P(ensemble_axis, body_axis)
    rep = P(ensemble_axis)
    spec = NBodyState(
        pos=mat, vel=mat, mass=vec, radius=vec, alive=vec, acc=mat,
        potential=rep, time=rep, step=rep,
        pos_lo=mat if state_example.pos_lo is not None else None,
        vel_lo=mat if state_example.vel_lo is not None else None,
        jerk=mat if state_example.jerk is not None else None,
    )
    step = jax.jit(jax.shard_map(jax.vmap(one), mesh=mesh, in_specs=(spec,),
                                 out_specs=spec,
                                 check_vma=_check_vma(cfg, n_bodies,
                                                      n_body_shards)))
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda x: isinstance(x, P),
    )
    return step, shardings
