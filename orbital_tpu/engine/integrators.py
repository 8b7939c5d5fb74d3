"""Jittable integrators: leapfrog KDK and semi-implicit Euler.

The reference's step (core/engine.py:65-97) — half-kick, drift, force
re-evaluation, half-kick, collision sweep, history append — becomes a pure
function ``NBodyState -> NBodyState`` built once per :class:`SimConfig`.
History recording and I/O live outside (``rollout``), so the whole step
fuses into a single XLA program.

Under the ds32 precision policy, position/velocity accumulation uses
compensated double-single arithmetic (see ``dsfloat``): the *increments*
(a*dt, v*dt) are plain f32, the *accumulators* carry a correction term.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops import collisions as coll
from ..utils.config import SimConfig
from .dsfloat import ds_add
from .state import NBodyState

__all__ = ["make_step_fn", "ForceFn"]

# (pos, mass, alive) -> (acc, potential)
ForceFn = Callable[[jax.Array, jax.Array, jax.Array], tuple[jax.Array, jax.Array]]


def _accumulate(hi, lo: Optional[jax.Array], *increments):
    """hi(+lo) += sum(increments), compensated when lo is present."""
    if lo is None:
        for inc in increments:
            hi = hi + inc
        return hi, None
    for inc in increments:
        hi, lo = ds_add(hi, lo, inc)
    return hi, lo


# above this body count the dense [N, N] bounce sweep gives way to the
# row-chunked one (ops.collisions.bounce_deltas_chunked)
_DENSE_BOUNCE_MAX_N = 4096


def _apply_collisions(
    cfg: SimConfig, state: NBodyState,
    contacts: Optional[jax.Array] = None,
) -> NBodyState:
    if cfg.collisions == "none":
        return state
    if contacts is not None:
        # fused detection already ran inside the force sweep: when nothing
        # touches (the overwhelmingly common step), skip the O(N^2)
        # resolution sweep entirely. lax.cond executes one branch — the
        # no-contact step costs ~4 detection ops/pair instead of a second
        # full pair scan (the reference always pays that second scan,
        # core/physics.py:510-518). Resolution, when it runs, is the exact
        # same sweep, so semantics are unchanged.
        return jax.lax.cond(contacts > 0,
                            lambda s: _apply_collisions(cfg, s),
                            lambda s: s, state)
    if cfg.collisions == "resolve":
        # absorb / fragment / bounce outcome model (reference
        # resolve_collision, core/physics.py:361-388). The fragmentation
        # roll folds the step counter into frag_seed, so rollouts are
        # reproducible and each step draws a fresh pair matrix. Above the
        # dense [N, N] ceiling the contact-subset wrapper gathers the
        # touching bodies (plus debris slots) into a small dense scene —
        # contacts beyond cfg.resolve_subset defer to the next step's
        # re-detection (ops.collisions.resolve_outcomes_subset).
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.frag_seed),
                                 state.step)
        kw = dict(restitution=cfg.restitution, debris_k=cfg.debris_k,
                  debris_max_pairs=cfg.debris_max_pairs,
                  debris_energy_frac=cfg.debris_energy_frac,
                  debris_sep=cfg.debris_sep)
        if state.n_bodies > _DENSE_BOUNCE_MAX_N:
            pos, vel, mass, radius, alive, _ = coll.resolve_outcomes_subset(
                state.pos_full(), state.vel_full(), state.mass,
                state.radius, state.alive, key,
                subset=cfg.resolve_subset, **kw)
        else:
            pos, vel, mass, radius, alive = coll.resolve_outcomes(
                state.pos_full(), state.vel_full(), state.mass,
                state.radius, state.alive, key, **kw)
        zeros = None if state.pos_lo is None else jnp.zeros_like(state.pos_lo)
        return state.replace(
            pos=pos, vel=vel, mass=mass, radius=radius, alive=alive,
            pos_lo=zeros, vel_lo=zeros,
        )
    if cfg.collisions == "bounce":
        if state.n_bodies > _DENSE_BOUNCE_MAX_N:
            dpos, dvel = coll.bounce_deltas_chunked(
                state.pos, state.vel, state.mass, state.radius, state.alive,
                restitution=cfg.restitution,
                chunk=min(cfg.chunk, state.n_bodies),
            )
        else:
            dpos, dvel = coll.bounce_deltas(
                state.pos, state.vel, state.mass, state.radius, state.alive,
                restitution=cfg.restitution,
            )
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dpos)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dvel)
        return state.replace(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo)
    # merge: rewrites pos/vel/mass/radius/alive wholesale; compensation terms
    # of merged bodies are dropped (a one-time sub-ulp loss on merge events).
    # Above the dense [N, N] ceiling the contact-chain roots are found
    # column-blocked.
    chunk = 1024 if state.n_bodies > _DENSE_BOUNCE_MAX_N else None
    pos, vel, mass, radius, alive = coll.merge_groups(
        state.pos_full(), state.vel_full(), state.mass, state.radius,
        state.alive, chunk=chunk,
    )
    zeros = None if state.pos_lo is None else jnp.zeros_like(state.pos_lo)
    return state.replace(
        pos=pos, vel=vel, mass=mass, radius=radius, alive=alive,
        pos_lo=zeros, vel_lo=zeros,
    )


def make_step_fn(
    cfg: SimConfig,
    force_fn: ForceFn,
    accel_jerk_fn: Optional[Callable] = None,
    force_detect_fn: Optional[Callable] = None,
    accel_jerk_detect_fn: Optional[Callable] = None,
) -> Callable[[NBodyState], NBodyState]:
    """Build the jittable single-step function for a config.

    ``accel_jerk_fn(pos, vel, mass, alive) -> (acc, jerk, U)`` is the
    Hermite force path (``rollout.resolve_accel_jerk_fn`` picks
    dense/chunked/Pallas by N); defaults to the dense evaluator.

    ``force_detect_fn(pos, mass, radius, alive) -> (acc, U, contacts)``
    fuses contact detection into the step's closing force evaluation
    (``rollout.resolve_force_detect_fn``); with it, the collision
    resolution sweep is lax.cond-skipped on contact-free steps. Applies
    to kdk, euler, and rk4 — each evaluates forces at exactly the
    collision-time (post-drift/final) positions.

    ``accel_jerk_detect_fn(pos, vel, mass, radius, alive) -> (acc, jerk,
    U, contacts)`` is the Hermite analog
    (``rollout.resolve_accel_jerk_detect_fn``). Hermite's force eval is at
    *predicted* positions, so its gate tests predicted separations: a
    contact forming only in the predictor->corrector gap resolves one
    step late (once penetration deepens) — the resolution sweep itself
    always runs on true post-correction positions.

    KDK (velocity-Verlet) order matches the reference exactly
    (core/engine.py:65-97): the cached ``state.acc`` is a(t); collisions run
    after the second kick and the acceleration cache is *not* refreshed
    afterwards (the next step's first kick uses pre-collision forces, as in
    the reference).
    """
    dt = cfg.dt

    fuse_detect = force_detect_fn is not None and cfg.collisions != "none"

    def kdk(state: NBodyState) -> NBodyState:
        with jax.named_scope("kdk.kick1"):
            vel, vel_lo = _accumulate(state.vel, state.vel_lo, 0.5 * dt * state.acc)
        with jax.named_scope("kdk.drift"):
            if vel_lo is None:
                pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel)
            else:
                pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel, dt * vel_lo)
        contacts = None
        with jax.named_scope("kdk.forces"):
            if fuse_detect:
                acc, potential, contacts = force_detect_fn(
                    pos, state.mass, state.radius, state.alive)
            else:
                acc, potential = force_fn(pos, state.mass, state.alive)
        with jax.named_scope("kdk.kick2"):
            vel, vel_lo = _accumulate(vel, vel_lo, 0.5 * dt * acc)

        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        with jax.named_scope("collisions"):
            return _apply_collisions(cfg, state, contacts)

    def yoshida4(state: NBodyState) -> NBodyState:
        """4th-order symplectic integrator (Yoshida 1990): the KDK kernel
        composed three times with weights (w1, w0, w1), w1 = 1/(2-2^(1/3)),
        w0 = 1 - 2 w1. Three force evaluations per step; symplectic like
        KDK (bounded long-horizon energy error) but two orders more
        accurate per step — the cheap upgrade when dt, not force cost,
        limits accuracy. The middle sub-step runs *backwards* (w0 < 0);
        that is intrinsic to 4th-order splitting (Suzuki), not a bug.

        Contact detection rides the closing force evaluation (true
        end-of-step positions), exactly as in kdk; the cached ``state.acc``
        seeds the first sub-step's kick and the closing acceleration is
        cached for the next step.
        """
        s = state
        contacts = None
        w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
        for i, w in enumerate((w1, 1.0 - 2.0 * w1, w1)):
            h = w * dt
            last = i == 2
            vel, vel_lo = _accumulate(s.vel, s.vel_lo, 0.5 * h * s.acc)
            if vel_lo is None:
                pos, pos_lo = _accumulate(s.pos, s.pos_lo, h * vel)
            else:
                pos, pos_lo = _accumulate(s.pos, s.pos_lo, h * vel,
                                          h * vel_lo)
            if last and fuse_detect:
                acc, potential, contacts = force_detect_fn(
                    pos, s.mass, s.radius, s.alive)
            else:
                acc, potential = force_fn(pos, s.mass, s.alive)
            vel, vel_lo = _accumulate(vel, vel_lo, 0.5 * h * acc)
            s = s.replace(pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
                          acc=acc, potential=potential)
        s = s.replace(time=state.time + dt, step=state.step + 1)
        with jax.named_scope("collisions"):
            return _apply_collisions(cfg, s, contacts)

    def rk4(state: NBodyState) -> NBodyState:
        """Classical RK4 (BASELINE north star names it alongside leapfrog).

        Non-symplectic but 4th-order accurate; 4 force evaluations per step
        (the cached ``state.acc`` serves as k1's acceleration, and the
        closing evaluation at r(t+dt) is cached for the next step and for
        energy diagnostics).
        """
        r0 = state.pos_full()
        v0 = state.vel_full()
        a1 = state.acc
        half = 0.5 * dt

        r2 = r0 + half * v0
        v2 = v0 + half * a1
        a2, _ = force_fn(r2, state.mass, state.alive)

        r3 = r0 + half * v2
        v3 = v0 + half * a2
        a3, _ = force_fn(r3, state.mass, state.alive)

        r4 = r0 + dt * v3
        v4 = v0 + dt * a3
        a4, _ = force_fn(r4, state.mass, state.alive)

        dr = (dt / 6.0) * (v0 + 2.0 * v2 + 2.0 * v3 + v4)
        dv = (dt / 6.0) * (a1 + 2.0 * a2 + 2.0 * a3 + a4)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)

        contacts = None
        if fuse_detect:
            acc, potential, contacts = force_detect_fn(
                pos, state.mass, state.radius, state.alive)
        else:
            acc, potential = force_fn(pos, state.mass, state.alive)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    if accel_jerk_fn is None:
        from ..ops.forces import accel_jerk_dense

        def accel_jerk_fn(pos, vel, mass, alive):
            return accel_jerk_dense(pos, vel, mass, alive,
                                    G=cfg.G, eps2=cfg.eps2)

    def hermite(state: NBodyState) -> NBodyState:
        """4th-order Hermite predictor-corrector (Makino & Aarseth 1992):
        one combined acceleration+jerk evaluation per step — the standard
        collisional N-body integrator. Uses the cached (acc, jerk) pair as
        the step's initial derivatives.

        With ``cfg.adaptive_eta`` the step size follows the Aarseth
        criterion dt = clip(eta * min sqrt(|a|/|jerk|), dt_min, cfg.dt) —
        shrinking through close encounters, with cfg.dt as the ceiling
        (dt_min > 0 is enforced by SimConfig, so a collapsed ratio can
        never freeze simulation time; an all-dead state yields ratio=inf
        and steps at the cfg.dt ceiling).
        """
        r0 = state.pos_full()
        v0 = state.vel_full()
        a0 = state.acc
        j0 = state.jerk
        if cfg.adaptive_eta is not None:
            a_mag = jnp.linalg.norm(a0, axis=-1)
            j_mag = jnp.linalg.norm(j0, axis=-1) + 1e-30
            alive_f = state.alive
            ratio = jnp.where(alive_f, a_mag / j_mag, jnp.inf)
            dt_a = cfg.adaptive_eta * jnp.sqrt(jnp.min(ratio))
            dt = jnp.clip(dt_a, cfg.dt_min, cfg.dt)  # shadows the static dt
        else:
            dt = cfg.dt
        dt2 = dt * dt

        # predict
        rp = r0 + dt * v0 + (0.5 * dt2) * a0 + (dt2 * dt / 6.0) * j0
        vp = v0 + dt * a0 + (0.5 * dt2) * j0
        contacts = None
        if accel_jerk_detect_fn is not None and cfg.collisions != "none":
            a1, j1, potential, contacts = accel_jerk_detect_fn(
                rp, vp, state.mass, state.radius, state.alive)
        else:
            a1, j1, potential = accel_jerk_fn(rp, vp, state.mass, state.alive)
        # correct
        dv = (0.5 * dt) * (a0 + a1) + (dt2 / 12.0) * (j0 - j1)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)
        v1 = vel if vel_lo is None else vel + vel_lo
        dr = (0.5 * dt) * (v0 + v1) + (dt2 / 12.0) * (a0 - a1)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)

        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=a1, jerk=j1, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    def hermite_block(state: NBodyState) -> NBodyState:
        """Block-timestep Hermite (Makino-Aarseth individual timesteps,
        reshaped for static shapes): each macro step classifies bodies by
        the Aarseth criterion; the F fastest (dt_i < dt, F =
        cfg.hermite_fast_cap) substep at dt/m against source predictions,
        then ONE full-system Hermite step closes the macro step with the
        fast bodies' final positions as sources. Cost per macro step:
        N^2 + m F N instead of the m N^2 a globally-shrunk dt would pay —
        one close binary no longer stalls the whole system.

        Accuracy notes (standard for block schemes): fast<->slow pair
        forces are evaluated against *predicted* source trajectories, so
        exact momentum antisymmetry holds only to prediction accuracy;
        bodies beyond the cap run at the macro dt (degrades accuracy,
        never correctness — size the cap generously). Under ds32, fast
        rows lose their compensation term each macro step (their motion
        is substep-dominated; slow rows keep full compensation).
        Collision detection runs at MACRO boundaries only (the closing
        full-system sweep): a contact that forms and resolves entirely
        inside one macro step's substep window is missed — keep dt below
        the shortest contact timescale when pairing block timesteps with
        collisions.
        """
        from ..ops.forces import accel_jerk_subset

        n = state.n_bodies
        F = min(cfg.hermite_fast_cap, n)
        sub_chunk = (cfg.chunk if n > 4096 and n % cfg.chunk == 0 else 0)
        r0 = state.pos_full()
        v0 = state.vel_full()
        a0 = state.acc
        j0 = state.jerk
        eta = cfg.adaptive_eta

        a_mag = jnp.linalg.norm(a0, axis=-1)
        j_mag = jnp.linalg.norm(j0, axis=-1) + 1e-30
        dt_i = jnp.where(state.alive, eta * jnp.sqrt(a_mag / j_mag),
                         jnp.inf)
        idx_f = jnp.argsort(dt_i)[:F]
        fast_sel = dt_i[idx_f] < dt                       # [F]
        any_fast = jnp.any(fast_sel)
        dt_f_min = jnp.min(jnp.where(fast_sel, dt_i[idx_f], jnp.inf))
        # clip in FLOAT before the int32 cast: a tiny dt_min "no floor"
        # sentinel can push ceil(dt/dt_min) past 2^31, and float->int32
        # overflow is XLA-undefined (could wrap negative -> m=1, silently
        # disabling substepping for the encounter)
        m_f = jnp.where(
            any_fast,
            jnp.ceil(dt / jnp.clip(dt_f_min, cfg.dt_min, dt)),
            1.0)
        m = jnp.clip(m_f, 1.0,
                     float(cfg.hermite_max_substeps)).astype(jnp.int32)
        h = dt / m.astype(r0.dtype)

        rf0, vf0 = r0[idx_f], v0[idx_f]
        af0, jf0 = a0[idx_f].astype(r0.dtype), j0[idx_f].astype(r0.dtype)
        upd = fast_sel[:, None]

        def substep(k, carry):
            rf, vf, af, jf = carry
            tau1 = (k + 1).astype(r0.dtype) * h
            # predict fast by h, all sources by their macro polynomials
            rp = rf + h * vf + (0.5 * h * h) * af + (h * h * h / 6.0) * jf
            vp = vf + h * af + (0.5 * h * h) * jf
            rs = r0 + tau1 * v0 + (0.5 * tau1 * tau1) * a0 \
                 + (tau1 * tau1 * tau1 / 6.0) * j0
            vs = v0 + tau1 * a0 + (0.5 * tau1 * tau1) * j0
            # fast rows ride their own substepped trajectory (exact
            # fast-fast pairs); slow-selected padding rows keep the
            # macro prediction
            rs = rs.at[idx_f].set(jnp.where(upd, rp, rs[idx_f]))
            vs = vs.at[idx_f].set(jnp.where(upd, vp, vs[idx_f]))
            a1, j1 = accel_jerk_subset(idx_f, rs, vs, state.mass,
                                       state.alive, G=cfg.G, eps2=cfg.eps2,
                                       chunk=sub_chunk)
            a1 = a1.astype(r0.dtype)
            j1 = j1.astype(r0.dtype)
            dv = (0.5 * h) * (af + a1) + (h * h / 12.0) * (jf - j1)
            v1 = vf + dv
            dr = (0.5 * h) * (vf + v1) + (h * h / 12.0) * (af - a1)
            return (jnp.where(upd, rf + dr, rf),
                    jnp.where(upd, v1, vf),
                    jnp.where(upd, a1, af),
                    jnp.where(upd, j1, jf))

        rf, vf, af, jf = lax.cond(
            any_fast,
            lambda c: lax.fori_loop(0, m, substep, c),
            lambda c: c,
            (rf0, vf0, af0, jf0))

        # macro step: one full-system evaluation at t+dt with the fast
        # bodies' FINAL positions as sources
        rp = r0 + dt * v0 + (0.5 * dt * dt) * a0 + (dt ** 3 / 6.0) * j0
        vp = v0 + dt * a0 + (0.5 * dt * dt) * j0
        rp = rp.at[idx_f].set(jnp.where(upd, rf, rp[idx_f]))
        vp = vp.at[idx_f].set(jnp.where(upd, vf, vp[idx_f]))
        contacts = None
        if accel_jerk_detect_fn is not None and cfg.collisions != "none":
            a1, j1, potential, contacts = accel_jerk_detect_fn(
                rp, vp, state.mass, state.radius, state.alive)
        else:
            a1, j1, potential = accel_jerk_fn(rp, vp, state.mass,
                                              state.alive)
        dv = (0.5 * dt) * (a0 + a1) + (dt * dt / 12.0) * (j0 - j1)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)
        v1 = vel if vel_lo is None else vel + vel_lo
        dr = (0.5 * dt) * (v0 + v1) + (dt * dt / 12.0) * (a0 - a1)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)

        # overwrite fast rows with their substepped endpoints
        pos = pos.at[idx_f].set(jnp.where(upd, rf.astype(pos.dtype),
                                          pos[idx_f]))
        vel = vel.at[idx_f].set(jnp.where(upd, vf.astype(vel.dtype),
                                          vel[idx_f]))
        if pos_lo is not None:
            z = jnp.zeros_like(pos_lo[idx_f])
            pos_lo = pos_lo.at[idx_f].set(jnp.where(upd, z, pos_lo[idx_f]))
            vel_lo = vel_lo.at[idx_f].set(jnp.where(upd, z, vel_lo[idx_f]))

        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=a1, jerk=j1, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    def hermite_block_rungs(state: NBodyState) -> NBodyState:
        """Multi-rung block-timestep Hermite (``cfg.hermite_rungs`` = R
        levels): each fast body is granted a POWER-OF-TWO substep rung by
        sorted-dt position quota — the fastest ``F >> (R-1)`` bodies step
        every fine step, the next quota every 2nd, ..., the last quota
        every ``2^(R-1)``-th — so the substep force bill is the SUM of
        rung-prefix evaluations instead of m x F: a lone hard binary no
        longer drags every merely-fast body to ITS rate.

        Static-shape mechanics: fast bodies are dt-sorted, so the active
        set at fine step s is always a PREFIX (every rung finer than the
        coarsest active one is active too); ``lax.switch`` over the
        active level runs one statically-shaped
        :func:`~orbital_tpu.ops.forces.accel_jerk_subset` per fine step.
        The fine count m is rounded UP to a power of two (rung periods
        must divide it); bodies whose granted period exceeds m fall back
        to the closing macro step for this macro step. Quota grants are
        by position, not need: a body can be granted a coarser rung than
        its Aarseth dt wants, which (like overflowing ``fast_cap``)
        degrades accuracy, never correctness — the dt-sorted order
        guarantees any under-granted body is slower than every body
        granted a finer rung. Same macro-boundary collision caveat as
        the single-rung scheme.

        Mid-macro re-selection (``cfg.hermite_reselect``): at every
        coarsest-rung boundary every riding row was just corrected at
        the same time (all periods divide ``2^(R-1)``), so the carry can
        be permuted exactly — the riding prefix is re-sorted by the
        Aarseth dt recomputed from the carried (a, jerk), and the
        position-keyed rung grants re-apply to the new order. The body
        index map rides in the scan carry for this reason. Non-riding
        rows sort to the tail (stable, inf key), exactly where they
        started — the riding set itself never changes inside a window
        (membership needs the full-system force the macro boundary
        provides)."""
        from ..ops.forces import accel_jerk_subset

        n = state.n_bodies
        F = min(cfg.hermite_fast_cap, n)
        L = cfg.hermite_rungs
        sub_chunk = (cfg.chunk if n > 4096 and n % cfg.chunk == 0 else 0)
        r0 = state.pos_full()
        v0 = state.vel_full()
        a0 = state.acc
        j0 = state.jerk
        eta = cfg.adaptive_eta

        a_mag = jnp.linalg.norm(a0, axis=-1)
        j_mag = jnp.linalg.norm(j0, axis=-1) + 1e-30
        dt_i = jnp.where(state.alive, eta * jnp.sqrt(a_mag / j_mag),
                         jnp.inf)
        idx_f = jnp.argsort(dt_i)[:F]
        fast_sel = dt_i[idx_f] < dt                       # [F]
        any_fast = jnp.any(fast_sel)
        dt_f_min = jnp.min(jnp.where(fast_sel, dt_i[idx_f], jnp.inf))
        # fine count: the needed substeps rounded UP to a power of two
        need = jnp.where(any_fast,
                         jnp.ceil(dt / jnp.clip(dt_f_min, cfg.dt_min, dt)),
                         1.0)
        log2_ms = int(np.log2(cfg.hermite_max_substeps))
        e = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(need, 1.0))),
                     0.0, float(log2_ms)).astype(jnp.int32)
        m = jnp.left_shift(jnp.int32(1), e)
        h = dt / m.astype(r0.dtype)

        # static rung per sorted-fast position (quota halving): position
        # p < F >> (L-1) is rung 0 (every fine step), then doubling
        pos_p = np.arange(F)
        rung_np = np.zeros(F, np.int32)
        for r in range(1, L):
            rung_np += (pos_p >= (F >> (L - r))).astype(np.int32)
        period = jnp.asarray(1 << rung_np)                # [F] static
        T = [max(1, F >> (L - 1 - r)) for r in range(L)]  # prefix sizes
        T[-1] = F

        ride = fast_sel & (period <= m)                   # [F]
        rf0, vf0 = r0[idx_f], v0[idx_f]
        af0 = a0[idx_f].astype(r0.dtype)
        jf0 = j0[idx_f].astype(r0.dtype)
        per_f = period.astype(r0.dtype)

        def substep(s, carry):
            tau = s.astype(r0.dtype) * h
            # coarsest active rung at fine step s (finer ones included)
            level = jnp.zeros((), jnp.int32)
            for r in range(1, L):
                level = level + ((s % (1 << r)) == 0).astype(jnp.int32)

            def branch(Tr, resel):
                def go(carry):
                    idx, rl, vl, al, jl, tl = carry
                    # sources at tau: macro polynomials, with substepping
                    # fast rows riding their own carry polynomials
                    rs = (r0 + tau * v0 + (0.5 * tau * tau) * a0
                          + (tau ** 3 / 6.0) * j0)
                    vs = v0 + tau * a0 + (0.5 * tau * tau) * j0
                    dlt = (tau - tl)[:, None]
                    rpf = (rl + dlt * vl + (0.5 * dlt * dlt) * al
                           + (dlt ** 3 / 6.0) * jl)
                    vpf = vl + dlt * al + (0.5 * dlt * dlt) * jl
                    rd = ride[:, None]
                    rs = rs.at[idx].set(jnp.where(rd, rpf, rs[idx]))
                    vs = vs.at[idx].set(jnp.where(rd, vpf, vs[idx]))
                    a1, j1 = accel_jerk_subset(
                        idx[:Tr], rs, vs, state.mass, state.alive,
                        G=cfg.G, eps2=cfg.eps2, chunk=sub_chunk)
                    a1 = a1.astype(r0.dtype)
                    j1 = j1.astype(r0.dtype)
                    act = ride[:Tr] & ((s % period[:Tr]) == 0)
                    he = (per_f[:Tr] * h)[:, None]
                    dv = (0.5 * he) * (al[:Tr] + a1) \
                        + (he * he / 12.0) * (jl[:Tr] - j1)
                    v1 = vl[:Tr] + dv
                    dr = (0.5 * he) * (vl[:Tr] + v1) \
                        + (he * he / 12.0) * (al[:Tr] - a1)
                    am = act[:, None]
                    rl = rl.at[:Tr].set(jnp.where(am, rl[:Tr] + dr,
                                                  rl[:Tr]))
                    vl = vl.at[:Tr].set(jnp.where(am, v1, vl[:Tr]))
                    al = al.at[:Tr].set(jnp.where(am, a1, al[:Tr]))
                    jl = jl.at[:Tr].set(jnp.where(am, j1, jl[:Tr]))
                    tl = tl.at[:Tr].set(jnp.where(act, tau, tl[:Tr]))
                    if resel:
                        # every riding row was just corrected at tau
                        # (all periods divide the coarsest), so the
                        # carry permutes exactly: re-sort the riding
                        # prefix by the fresh Aarseth dt; inf keys park
                        # non-riding rows at the tail in original order
                        dt_new = eta * jnp.sqrt(
                            jnp.linalg.norm(al, axis=-1)
                            / (jnp.linalg.norm(jl, axis=-1) + 1e-30))
                        perm = jnp.argsort(
                            jnp.where(ride, dt_new, jnp.inf),
                            stable=True)
                        idx, rl, vl, al, jl, tl = (
                            x[perm] for x in (idx, rl, vl, al, jl, tl))
                    return (idx, rl, vl, al, jl, tl)
                return go

            return lax.switch(
                level,
                [branch(t, cfg.hermite_reselect and r == L - 1)
                 for r, t in enumerate(T)],
                carry)

        tl0 = jnp.zeros((F,), r0.dtype)
        carry0 = (idx_f, rf0, vf0, af0, jf0, tl0)
        idx_f, rl, vl, al, jl, _ = lax.cond(
            any_fast,
            lambda c: lax.fori_loop(1, m + 1, substep, c),
            lambda c: c,
            carry0)
        upd = ride[:, None]

        # macro step: one full-system evaluation at t+dt with the
        # substepped bodies' FINAL positions as sources
        rp = r0 + dt * v0 + (0.5 * dt * dt) * a0 + (dt ** 3 / 6.0) * j0
        vp = v0 + dt * a0 + (0.5 * dt * dt) * j0
        rp = rp.at[idx_f].set(jnp.where(upd, rl, rp[idx_f]))
        vp = vp.at[idx_f].set(jnp.where(upd, vl, vp[idx_f]))
        contacts = None
        if accel_jerk_detect_fn is not None and cfg.collisions != "none":
            a1, j1, potential, contacts = accel_jerk_detect_fn(
                rp, vp, state.mass, state.radius, state.alive)
        else:
            a1, j1, potential = accel_jerk_fn(rp, vp, state.mass,
                                              state.alive)
        dv = (0.5 * dt) * (a0 + a1) + (dt * dt / 12.0) * (j0 - j1)
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dv)
        v1 = vel if vel_lo is None else vel + vel_lo
        dr = (0.5 * dt) * (v0 + v1) + (dt * dt / 12.0) * (a0 - a1)
        pos, pos_lo = _accumulate(state.pos, state.pos_lo, dr)

        pos = pos.at[idx_f].set(jnp.where(upd, rl.astype(pos.dtype),
                                          pos[idx_f]))
        vel = vel.at[idx_f].set(jnp.where(upd, vl.astype(vel.dtype),
                                          vel[idx_f]))
        if pos_lo is not None:
            z = jnp.zeros_like(pos_lo[idx_f])
            pos_lo = pos_lo.at[idx_f].set(jnp.where(upd, z, pos_lo[idx_f]))
            vel_lo = vel_lo.at[idx_f].set(jnp.where(upd, z, vel_lo[idx_f]))

        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=a1, jerk=j1, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    def euler(state: NBodyState) -> NBodyState:
        # v(t+dt) = v(t) + a(t) dt; r(t+dt) = r(t) + v(t+dt) dt
        # (reference Object.update, core/physics.py:315-332), then refresh
        # forces for the next step.
        vel, vel_lo = _accumulate(state.vel, state.vel_lo, dt * state.acc)
        if vel_lo is None:
            pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel)
        else:
            pos, pos_lo = _accumulate(state.pos, state.pos_lo, dt * vel, dt * vel_lo)
        contacts = None
        if fuse_detect:
            acc, potential, contacts = force_detect_fn(
                pos, state.mass, state.radius, state.alive)
        else:
            acc, potential = force_fn(pos, state.mass, state.alive)
        state = state.replace(
            pos=pos, pos_lo=pos_lo, vel=vel, vel_lo=vel_lo,
            acc=acc, potential=potential,
            time=state.time + dt, step=state.step + 1,
        )
        return _apply_collisions(cfg, state, contacts)

    if cfg.integrator == "hermite" and cfg.hermite_fast_cap > 0:
        if cfg.hermite_rungs > 1:
            return hermite_block_rungs
        return hermite_block
    return {"kdk": kdk, "euler": euler, "rk4": rk4, "hermite": hermite,
            "yoshida4": yoshida4}[cfg.integrator]
