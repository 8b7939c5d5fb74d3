"""Multirate (RESPA / Ahmad-Cohen-style) leapfrog: held far force, exact
switched near force every substep.

The exact sweep's per-step cost is dominated by the O(N^2) far field,
which at the benchmark's time step changes ~100x more slowly than the
close-encounter dynamics the step size actually resolves. The classic collisional-N-body
answer (Ahmad & Cohen 1973 neighbor scheme; NBODY6) recast as the
symplectic impulse-MTS / r-RESPA splitting (Tuckerman, Berne & Martyna
1992) is to integrate the two on different clocks:

    V_far(K dt / 2) . [ V_near(dt/2) D(dt) V_near(dt/2) ]^K . V_far(K dt/2)

``V_near`` is the smooth switched short-range force of ``ops/neighbor.py``
(S(r) = 1 below r1, 0 above rc); ``V_far = V_total - V_near`` needs ONE
exact O(N^2) evaluation (the resolved exact sweep, which stays the single
source of truth for total forces) per K substeps — the far force is applied
as boundary impulses and HELD (not extrapolated) in between, which keeps
the composition symplectic: both split Hamiltonians are fixed and smooth,
so long-horizon energy error stays bounded exactly as for plain KDK,
governed by (K dt) on the smooth far part and dt on the near part.

Per macro window (K substeps):
  1. freeze the neighbor geometry at the sync positions (skin margin
     covers all motion inside the window — violations are counted);
  2. pack state into chunk-slot space ONCE; the whole inner loop is
     elementwise f32/ds32 arithmetic plus the near sweep — no
     per-substep gathers, scatters, sorts, or host round-trips;
  3. close with one exact force evaluation at the end positions;
     ``a_far = a_total - a_near`` at identical positions, so the split
     is exact by construction and ``state.acc`` keeps its plain-KDK
     meaning (total acceleration at the state's positions).

Bodies dropped by the (probed, counted) geometry budgets fall back to
ballistic motion on the held TOTAL acceleration for that window — counted,
never silent, and impossible when budgets come from ``neighbor_budgets``.

Collisions (when enabled) are detected/resolved at MACRO boundaries riding
the closing exact evaluation — the same macro-boundary contract as the
block-timestep Hermite (engine/integrators.py). Reference semantics
unchanged: core/physics.py:125-159 (forces), 510-535 (collision sweep).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.neighbor import (SENTINEL_POS, near_acc_slots, neighbor_geometry,
                            pack_rows, pack_slots, unpack_rows,
                            unpack_slots)
from ..utils.config import SimConfig
from .dsfloat import ds_add
from .rollout import Trajectory, _snapshot
from .state import NBodyState

__all__ = ["make_respa_macro", "respa_rollout", "respa_rollout_jit",
           "respa_rollout_dyn"]

f32 = jnp.float32


def _fills_pos(dtype):
    """Fill row for packed (x, y, z, m) tables: sentinel positions, zero
    mass — padding slots are force-inert by value."""
    return jnp.asarray([SENTINEL_POS] * 3 + [0.0], dtype)


def _resolve_sweep(cfg: SimConfig):
    """Returns ``sweep(xs, ys, zs, ms, geom, i0=None) -> (acc, pe)`` over
    the slot channels: the XLA near sweep ``near_acc_slots``. ``i0``
    (dynamic chunk offset, paired with a row-sliced ``geom["jbl"]``)
    restricts the sweep to one mesh shard's i-chunks."""
    f = partial(near_acc_slots,
                r1=cfg.respa_r1 if cfg.respa_r1 > 0 else 0.5 * cfg.respa_rc,
                rc=cfg.respa_rc, G=cfg.G, eps2=cfg.eps2,
                chunk=cfg.respa_chunk, rj=cfg.respa_rj)
    return lambda xs, ys, zs, ms, geom, i0=None: f(
        xs, ys, zs, ms, geom["jbl"], i0=i0)


def make_respa_macro(
    cfg: SimConfig,
    force_fn: Callable,
    force_detect_fn: Optional[Callable] = None,
    shard: Optional[tuple[str, int]] = None,
) -> Callable[[NBodyState], tuple[NBodyState, dict]]:
    """Build the jittable macro-step: ``state -> (state', diag)`` advancing
    ``cfg.respa_k`` substeps of ``cfg.dt``. ``diag`` carries the window's
    ``overflow`` (dropped-body count) and ``skin_violation`` (1 if any
    body moved further than the skin margin guarantees coverage for —
    near pairs may then have been missed; enlarge ``respa_cell`` or lower
    ``respa_k``). ``state.step`` advances by K (each substep is a real
    KDK step at dt), ``state.acc``/``potential`` stay the exact total
    force caches, so diagnostics and downstream consumers see plain-KDK
    semantics at macro boundaries.

    ``shard=(axis_name, n_shards)`` builds the MESH variant, for use
    inside ``shard_map`` with the state REPLICATED (full N on every
    device): each device sweeps its ``K_ch / n_shards`` slice of the
    i-chunk table per substep (the per-substep acc rows are then
    all_gathered — slot-ordered, so the gather is the assembly) and
    ``force_fn`` is expected to shard the closing exact evaluation
    itself (the ring adapter in ``parallel.sharded``). Everything else —
    pack, inner elementwise updates, unpack — is replicated; at the 65k+
    scales where the multirate stepper matters, those are noise against
    the two sweeps that do shard. See
    ``parallel.sharded.make_sharded_respa_rollout``."""
    K = int(cfg.respa_k)
    dt = cfg.dt
    delta = K * dt
    C, RJ = cfg.respa_chunk, cfg.respa_rj
    K_ch, W_blk = cfg.respa_max_chunks, cfg.respa_w_blk
    n_slots = (K_ch + RJ) * C
    valid_below = K_ch * C
    skin_half = 0.5 * (cfg.respa_cell - cfg.respa_rc)
    if skin_half <= 0:
        raise ValueError("respa_cell must exceed respa_rc (skin > 0)")
    if cfg.eps2 <= 0:
        raise ValueError("integrator='respa' requires softening > 0 "
                         "(self-pairs vanish through the softened rsqrt)")
    if shard is not None:
        shard_ax, n_shards = shard
        if K_ch % n_shards:
            raise ValueError(
                f"respa_max_chunks={K_ch} must divide across {n_shards} "
                "shards (neighbor_budgets rounds up when simulate() "
                "passes a mesh)")
        kd = K_ch // n_shards
    fuse_detect = force_detect_fn is not None and cfg.collisions != "none"

    def _pad(a):
        return jnp.pad(a, ((0, n_slots - valid_below),) + ((0, 0),) * (a.ndim - 1))

    def build_geom(state: NBodyState) -> dict:
        """Neighbor geometry + packed BUILD positions. The skin margin
        covers motion from these positions, so the same geometry may
        serve ``cfg.respa_refresh`` consecutive macro windows (the skin
        check below measures against them)."""
        with jax.named_scope("respa.geometry"):
            geom = neighbor_geometry(
                state.pos, state.alive, cell=cfg.respa_cell,
                m_grid=cfg.respa_m, chunk=C, max_chunks=K_ch, w_blk=W_blk,
                rj=RJ)
            zcol = jnp.zeros((state.n_bodies, 1), state.pos.dtype)
            geom["pos0_build"] = pack_rows(
                geom["slot"], jnp.concatenate([state.pos, zcol], axis=1),
                n_slots, _fills_pos(state.pos.dtype))
        return geom

    def macro(state: NBodyState,
              geom: Optional[dict] = None) -> tuple[NBodyState, dict]:
        ds = state.pos_lo is not None
        sweep = _resolve_sweep(cfg)
        if geom is None:
            geom = build_geom(state)
        slot = geom["slot"]
        dtype = state.pos.dtype
        zcol = jnp.zeros((state.n_bodies, 1), dtype)
        pkr = lambda v, fills: pack_rows(slot, v, n_slots, fills)

        if shard is None:
            def run_sweep(P):
                acc, _ = sweep(P[:, 0], P[:, 1], P[:, 2], P[:, 3], geom)
                # rows (ax, ay, az, 0): the zero column keeps every
                # whole-row kick mass-neutral (column 3 of P is the mass)
                return _pad(jnp.concatenate(
                    [acc, jnp.zeros((acc.shape[0], 1), acc.dtype)],
                    axis=1))
        else:
            def run_sweep(P):
                # each device sweeps its i-chunk slice against the global
                # j side; the all_gather IS the slot-order assembly (acc
                # rows are chunk-major, shards are contiguous runs)
                i0 = lax.axis_index(shard_ax) * kd
                jbl_l = lax.dynamic_slice_in_dim(geom["jbl"], i0, kd, 0)
                acc_l, _ = sweep(P[:, 0], P[:, 1], P[:, 2], P[:, 3],
                                 {**geom, "jbl": jbl_l}, i0=i0)
                acc = lax.all_gather(acc_l, shard_ax, axis=0, tiled=True)
                return _pad(jnp.concatenate(
                    [acc, jnp.zeros((acc.shape[0], 1), acc.dtype)],
                    axis=1))

        # row tables [n_slots, 4]: pack/unpack cost ~per ROW on this
        # platform, so channel groups replace 16 scalar scatters with 5
        with jax.named_scope("respa.pack"):
            mass_eff = jnp.where(state.alive, state.mass, 0.0)[:, None]
            P = pkr(jnp.concatenate([state.pos, mass_eff], axis=1),
                    _fills_pos(dtype))
            V = pkr(jnp.concatenate([state.vel, zcol], axis=1), 0.0)
            A = pkr(jnp.concatenate([state.acc, zcol], axis=1), 0.0)
            PL = (pkr(jnp.concatenate([state.pos_lo, zcol], axis=1), 0.0)
                  if ds else jnp.zeros_like(P))
            VL = (pkr(jnp.concatenate([state.vel_lo, zcol], axis=1), 0.0)
                  if ds else jnp.zeros_like(P))
        pos0 = geom["pos0_build"]

        with jax.named_scope("respa.near0"):
            a_n0 = run_sweep(P)

        # opening far half-impulse: a_far = a_total - a_near at the SAME
        # (sync) positions; state.acc is the previous window's closing
        # exact evaluation at exactly these positions. Column 3 of both
        # A and a_n0 is zero, so the mass column never moves.
        with jax.named_scope("respa.far_kick"):
            inc = (0.5 * delta) * (A - a_n0)
            if ds:
                V, VL = ds_add(V, VL, inc)
            else:
                V = V + inc

        def inner(carry, _):
            P, PL, V, VL, an = carry
            inc = (0.5 * dt) * an
            if ds:
                V, VL = ds_add(V, VL, inc)
                P, PL = ds_add(P, PL, dt * V)
                P, PL = ds_add(P, PL, dt * VL)
            else:
                V = V + inc
                P = P + dt * V
            a_n = run_sweep(P)
            inc = (0.5 * dt) * a_n
            if ds:
                V, VL = ds_add(V, VL, inc)
            else:
                V = V + inc
            return (P, PL, V, VL, a_n), None

        carry0 = (P, PL, V, VL, a_n0)
        with jax.named_scope("respa.inner"):
            (P, PL, V, VL, a_n_end), _ = lax.scan(
                inner, carry0, None, length=K)

        with jax.named_scope("respa.skin_check"):
            # against the geometry BUILD positions: with respa_refresh > 1
            # the frozen tables must cover all motion since the build, not
            # just this window's (sentinel rows subtract to exactly 0;
            # the mass column is invariant so it adds exactly 0)
            d2 = jnp.sum((P - pos0) ** 2, axis=1)
            skin_violation = (jnp.max(d2) > skin_half * skin_half).astype(
                jnp.int32)

        # unpack; dropped bodies ride the held TOTAL force ballistically
        with jax.named_scope("respa.unpack"):
            pos_fb = (state.pos_full() + delta * state.vel_full()
                      + (0.5 * delta * delta) * state.acc)
            vel_fb = state.vel_full() + delta * state.acc
            dropped = slot >= valid_below
            upkr = lambda t, fb: unpack_rows(slot, t, fb, valid_below)
            fb4 = lambda fb: jnp.concatenate([fb, zcol], axis=1)
            zeros4 = jnp.zeros((state.n_bodies, 4), dtype)
            pos_hi = upkr(P, fb4(pos_fb))[:, :3]
            vel_hi = upkr(V, fb4(vel_fb))[:, :3]
            if ds:
                pos_lo = upkr(PL, zeros4)[:, :3]
                vel_lo = upkr(VL, zeros4)[:, :3]
            else:
                pos_lo = vel_lo = None
            a_near_end = upkr(a_n_end, zeros4)[:, :3]

        contacts = None
        with jax.named_scope("respa.full_force"):
            if fuse_detect:
                acc_tot, potential, contacts = force_detect_fn(
                    pos_hi, state.mass, state.radius, state.alive)
            else:
                acc_tot, potential = force_fn(pos_hi, state.mass,
                                              state.alive)

        # closing far half-impulse (dropped rows already absorbed their
        # whole window's total impulse in the ballistic fallback)
        with jax.named_scope("respa.far_kick2"):
            kick = jnp.where(dropped[:, None], 0.0,
                             (0.5 * delta) * (acc_tot - a_near_end))
            if ds:
                vel_hi, vel_lo = ds_add(vel_hi, vel_lo, kick)
            else:
                vel_hi = vel_hi + kick

        new = state.replace(
            pos=pos_hi, pos_lo=pos_lo, vel=vel_hi, vel_lo=vel_lo,
            acc=acc_tot, potential=potential,
            time=state.time + delta, step=state.step + K,
        )
        if cfg.collisions != "none":
            from .integrators import _apply_collisions

            with jax.named_scope("collisions"):
                new = _apply_collisions(cfg, new, contacts)
        diag = dict(
            overflow=(geom["cap_overflow"]
                      + jnp.sum(dropped, dtype=jnp.int32)
                      + geom["w_overflow"]),
            # split counters: which budget blew (cap = chunk table,
            # w = per-chunk blocks)
            cap_overflow=geom["cap_overflow"],
            w_overflow=geom["w_overflow"],
            skin_violation=skin_violation,
        )
        return new, diag

    macro.build_geom = build_geom
    return macro


def respa_rollout(
    state: NBodyState,
    cfg: SimConfig,
    steps: int,
    record_every: int = 0,
    force_fn: Optional[Callable] = None,
) -> tuple[NBodyState, Optional[Trajectory], dict]:
    """Advance ``steps`` SUBSTEPS (must divide by ``cfg.respa_k``) under
    the multirate stepper; optionally record every ``record_every``-th
    substep (must be a multiple of K — snapshots exist at macro
    boundaries, where the state carries exact total-force caches).
    Returns ``(final, trajectory | None, diag)`` with ``diag`` the
    window-max of each counter — nonzero ``overflow`` /
    ``skin_violation`` means near pairs were missed (resize budgets /
    skin); the contract is counted-never-silent, as everywhere else in
    this tree."""
    from .rollout import resolve_force_detect_fn, resolve_force_fn

    K = int(cfg.respa_k)
    if steps % K:
        raise ValueError(f"steps={steps} must divide by respa_k={K}")
    fn = force_fn or resolve_force_fn(cfg, state.n_bodies)
    fd = (resolve_force_detect_fn(cfg, state.n_bodies)
          if cfg.collisions != "none" else None)
    macro = make_respa_macro(cfg, fn, force_detect_fn=fd)
    n_macros = steps // K

    M = int(cfg.respa_refresh)

    def step_d(carry, i):
        s, geom, diag = carry
        # i == 0 reuses the carry-seeded geom0 (no wasted rebuild)
        geom = lax.cond((i % M == 0) & (i > 0),
                        lambda: macro.build_geom(s), lambda: geom)
        s, d = macro(s, geom)
        return (s, geom, {k: jnp.maximum(diag[k], d[k]) for k in diag}), None

    zero = jnp.zeros((), jnp.int32)
    diag0 = dict(overflow=zero, cap_overflow=zero, w_overflow=zero,
                 skin_violation=zero)
    geom0 = macro.build_geom(state)
    if record_every <= 0:
        (final, _, diag), _ = lax.scan(
            step_d, (state, geom0, diag0), jnp.arange(n_macros))
        return final, None, diag

    if record_every % K or steps % record_every:
        raise ValueError(
            f"record_every={record_every} must be a multiple of "
            f"respa_k={K} and divide steps={steps}")
    per_block = record_every // K
    n_records = steps // record_every

    def block(carry, b):
        carry, _ = lax.scan(step_d, carry,
                            b * per_block + jnp.arange(per_block))
        return carry, _snapshot(carry[0])

    (final, _, diag), ys = lax.scan(
        block, (state, geom0, diag0), jnp.arange(n_records))
    return final, Trajectory(**ys), diag


@partial(jax.jit, static_argnames=("cfg", "steps", "record_every"))
def respa_rollout_jit(
    state: NBodyState, cfg: SimConfig, steps: int, record_every: int = 0
) -> tuple[NBodyState, Optional[Trajectory], dict]:
    """jit-wrapped :func:`respa_rollout` (cfg/steps/record_every static)."""
    return respa_rollout(state, cfg, steps, record_every)


@partial(jax.jit, static_argnames=("cfg",))
def respa_rollout_dyn(
    state: NBodyState, cfg: SimConfig, n_macros: jax.Array
) -> tuple[NBodyState, dict]:
    """Advance ``n_macros`` macro windows with the trip count as a DEVICE
    value: one compiled program serves every chunk size. Long-horizon
    drivers (bench drift loops, host-chunked rollouts) would otherwise pay
    a fresh compile per distinct chunk length. No recording — use
    :func:`respa_rollout` when snapshots are needed."""
    from .rollout import resolve_force_detect_fn, resolve_force_fn

    fn = resolve_force_fn(cfg, state.n_bodies)
    fd = (resolve_force_detect_fn(cfg, state.n_bodies)
          if cfg.collisions != "none" else None)
    macro = make_respa_macro(cfg, fn, force_detect_fn=fd)
    M = int(cfg.respa_refresh)

    def body(i, carry):
        s, geom, diag = carry
        geom = lax.cond((i % M == 0) & (i > 0),
                        lambda: macro.build_geom(s), lambda: geom)
        s, d = macro(s, geom)
        return (s, geom, {k: jnp.maximum(diag[k], d[k]) for k in diag})

    zero = jnp.zeros((), jnp.int32)
    diag0 = dict(overflow=zero, cap_overflow=zero, w_overflow=zero,
                 skin_violation=zero)
    final, _, diag = lax.fori_loop(
        0, n_macros, body, (state, macro.build_geom(state), diag0))
    return final, diag
