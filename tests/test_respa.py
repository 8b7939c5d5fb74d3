"""Multirate (RESPA) integrator + switched neighbor force.

Layers tested bottom-up:
  * switch algebra (limits, smoothness, conservative shell term)
  * the geometry-based XLA table sweep vs the dense O(N^2) switched
    oracle, including budget-overflow accounting
  * the macro stepper: K=1 equivalence with plain KDK, symplectic
    long-horizon energy behavior, momentum conservation, ballistic
    fallback under deliberately starved budgets, skin-violation counter
  * simulate(integrator="respa") end to end

Semantic target: the reference's softened pair force + leapfrog
(core/physics.py:125-159, core/engine.py:65-97) under the smooth
near/far split of ops/neighbor.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.engine.multirate import respa_rollout
from orbital_tpu.engine.rollout import init_forces, rollout
from orbital_tpu.engine.state import make_state
from orbital_tpu.ops.neighbor import (SENTINEL_POS, near_acc_dense,
                                      near_acc_slots, neighbor_budgets,
                                      neighbor_geometry, pack_slots,
                                      switch_terms, unpack_slots)
from orbital_tpu.utils.config import SimConfig

F32 = jnp.float32


def _cluster(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * scale
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


def test_switch_limits_and_smoothness():
    r1, rc = 0.5, 1.0
    r2 = jnp.asarray([0.0, r1 * r1 * 0.999, rc * rc, 4.0], F32)
    S, spd = switch_terms(r2, r1, rc)
    np.testing.assert_allclose(S[:2], 1.0, atol=1e-6)
    np.testing.assert_allclose(S[2:], 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(spd), 0.0, atol=1e-5)
    # monotone decrease across the shell
    rr = jnp.linspace(r1 * r1, rc * rc, 64)
    Ss, _ = switch_terms(rr, r1, rc)
    assert bool(jnp.all(jnp.diff(Ss) <= 1e-7))


def test_switched_force_is_gradient_of_switched_potential():
    """a_near must equal -grad of V(r) S(r) — checked by finite
    differences of the dense oracle's potential sum."""
    rng = np.random.default_rng(3)
    pos = jnp.asarray(rng.normal(size=(6, 3)), jnp.float64)
    mass = jnp.asarray(rng.uniform(0.5, 1.0, 6), jnp.float64)
    alive = jnp.ones(6, bool)
    r1, rc, G, eps2 = 0.8, 1.6, 1.3, 1e-4

    def pot(p):
        d = p[None, :, :] - p[:, None, :]
        r2 = jnp.sum(d * d, -1)
        S, _ = switch_terms(r2, r1, rc)
        inv = 1.0 / jnp.sqrt(r2 + eps2)
        off = 1.0 - jnp.eye(6)
        return -0.5 * G * jnp.sum(mass[:, None] * mass[None, :]
                                  * inv * S * off)

    acc, _ = near_acc_dense(pos, mass, alive, r1=r1, rc=rc, G=G, eps2=eps2)
    grad = jax.grad(pot)(pos)
    want = -np.asarray(grad) / np.asarray(mass)[:, None]
    np.testing.assert_allclose(np.asarray(acc), want, rtol=2e-4, atol=1e-6)


def _geometry_setup(pos, mass, alive, rc, cell, chunk=8, rj=16):
    m_grid, k_ch, w_blk = neighbor_budgets(
        np.asarray(pos), np.asarray(alive), cell=cell, chunk=chunk, rj=rj)
    geom = neighbor_geometry(jnp.asarray(pos, F32), jnp.asarray(alive),
                             cell=cell, m_grid=m_grid, chunk=chunk,
                             max_chunks=k_ch, w_blk=w_blk, rj=rj)
    n_slots = (k_ch + rj) * chunk
    pk = lambda v, fill: pack_slots(geom["slot"], jnp.asarray(v, F32),
                                    n_slots, fill)
    xs, ys, zs = (pk(pos[:, k], SENTINEL_POS) for k in range(3))
    ms = pk(np.where(alive, mass, 0.0), 0.0)
    return geom, (xs, ys, zs, ms), (m_grid, k_ch, w_blk, n_slots)


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 64), (2, 700)])
def test_sweep_matches_dense_oracle(seed, n):
    pos, _, mass = _cluster(n, seed)
    alive = np.ones(n, bool)
    alive[n // 3] = False  # one dead body must drop out
    r1, rc, G, eps2 = 0.15, 0.3, 2.0, 1e-4
    geom, ch, (m_grid, k_ch, w_blk, n_slots) = _geometry_setup(
        pos, mass, alive, rc, cell=0.45)
    assert int(geom["cap_overflow"]) == 0
    assert int(geom["w_overflow"]) == 0
    acc_s, pe_s = near_acc_slots(*ch, geom["jbl"], r1=r1, rc=rc, G=G,
                                 eps2=eps2, chunk=8, rj=16)
    want_acc, want_pe = near_acc_dense(
        jnp.asarray(pos, F32), jnp.asarray(mass, F32), jnp.asarray(alive),
        r1=r1, rc=rc, G=G, eps2=eps2)
    acc = unpack_slots(geom["slot"], acc_s, jnp.zeros((n, 3), F32),
                       k_ch * 8)
    pe = unpack_slots(geom["slot"], pe_s, jnp.zeros((n,), F32), k_ch * 8)
    scale = float(jnp.max(jnp.abs(want_acc))) + 1e-12
    np.testing.assert_allclose(np.asarray(acc), np.asarray(want_acc),
                               atol=3e-5 * scale)
    dead = ~alive
    assert np.all(np.asarray(acc)[dead] == 0.0)
    np.testing.assert_allclose(np.asarray(pe)[alive],
                               np.asarray(want_pe)[alive], rtol=5e-4,
                               atol=1e-7)


def test_dynamic_rollout_matches_static():
    """respa_rollout_dyn (device trip count, one compile for every chunk
    size) == respa_rollout_jit chunked to the same macro total."""
    from orbital_tpu.engine.multirate import (respa_rollout_dyn,
                                              respa_rollout_jit)

    n = 256
    pos, vel, mass = _cluster(n, 0)
    rc, cell = 0.3, 0.6
    m_grid, k_ch, w_blk = neighbor_budgets(pos, cell=cell, chunk=8, rj=16)
    cfg = SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa",
                    respa_k=4, respa_rc=rc, respa_cell=cell,
                    respa_m=m_grid, respa_max_chunks=k_ch,
                    respa_w_blk=w_blk, respa_chunk=8, respa_rj=16)
    st = init_forces(make_state(pos, vel, mass, precision="f32"), cfg)
    f1, _, _ = respa_rollout_jit(st, cfg, 16)
    f2, _ = respa_rollout_dyn(st, cfg, 2)
    f2, _ = respa_rollout_dyn(f2, cfg, 2)
    # scan vs fori programs: same math, but XLA may reassociate — the
    # contract is physical equality, not bit equality
    np.testing.assert_allclose(np.asarray(f1.pos), np.asarray(f2.pos),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(f1.vel), np.asarray(f2.vel),
                               rtol=1e-7, atol=1e-8)


def test_near_dense_oracle_highest_matches_slot_sweep():
    """The dense oracle's contraction asks for HIGHEST precision (on a
    GPU a default float32 einsum may run in TF32, about three decimal
    digits), and at that precision it agrees with the slot sweep to
    float32 rounding: 1e-5 of the largest acceleration."""
    n = 300
    pos, _, mass = _cluster(n, 9)
    alive = np.ones(n, bool)
    r1, rc, G, eps2 = 0.15, 0.3, 1.0, 1e-4
    args = (jnp.asarray(pos, F32), jnp.asarray(mass, F32),
            jnp.asarray(alive))
    kw = dict(r1=r1, rc=rc, G=G, eps2=eps2)
    jaxpr = str(jax.make_jaxpr(lambda p, m, a: near_acc_dense(
        p, m, a, **kw))(*args))
    assert "dot_general" in jaxpr and "HIGHEST" in jaxpr
    geom, ch, (m_grid, k_ch, w_blk, n_slots) = _geometry_setup(
        pos, mass, alive, rc, cell=0.45)
    acc_s, _ = near_acc_slots(*ch, geom["jbl"], chunk=8, rj=16, **kw)
    acc = unpack_slots(geom["slot"], acc_s, jnp.zeros((n, 3), F32),
                       k_ch * 8)
    want, _ = near_acc_dense(*args, **kw)
    scale = float(jnp.max(jnp.abs(want)))
    np.testing.assert_allclose(np.asarray(acc), np.asarray(want),
                               atol=1e-5 * scale)


def test_budget_overflow_counted():
    n = 256
    pos, _, mass = _cluster(n, 7)
    alive = np.ones(n, bool)
    geom = neighbor_geometry(jnp.asarray(pos, F32), jnp.asarray(alive),
                             cell=0.5, m_grid=12, chunk=8,
                             max_chunks=16, w_blk=2, rj=16)
    assert int(geom["cap_overflow"]) > 0
    dropped = int(jnp.sum(geom["slot"] >= 16 * 8))
    assert dropped >= int(geom["cap_overflow"])


def _make_cfg(n_pos, vel, mass, *, k, rc=None, dt=1e-3,
              precision="ds32", **kw):
    pos = n_pos
    eps2 = 1e-4
    rc = rc if rc is not None else 0.3
    cell = kw.pop("cell", 2.0 * rc)
    m_grid, k_ch, w_blk = neighbor_budgets(pos, cell=cell, chunk=8, rj=16)
    cfg = SimConfig(dt=dt, G=1.0, eps2=eps2, integrator="respa",
                    respa_k=k, respa_rc=rc, respa_cell=cell,
                    respa_m=m_grid, respa_max_chunks=k_ch,
                    respa_w_blk=w_blk, respa_chunk=8, respa_rj=16, **kw)
    state = make_state(pos, vel, mass, precision=precision)
    return cfg, init_forces(state, cfg)


def test_k1_matches_plain_kdk():
    """With K = 1 the composition V_far(dt/2) V_n(dt/2) D V_n(dt/2)
    V_far(dt/2) collapses to exact KDK on the total force (kicks
    commute); trajectories agree to f32 summation noise."""
    n = 128
    pos, vel, mass = _cluster(n, 11)
    cfg, state = _make_cfg(pos, vel, mass, k=1)
    final_r, _, diag = respa_rollout(state, cfg, 10)
    assert int(diag["overflow"]) == 0 and int(diag["skin_violation"]) == 0
    cfg_kdk = SimConfig(dt=cfg.dt, G=1.0, eps2=cfg.eps2, integrator="kdk",
                        force_impl="dense")
    state2 = init_forces(make_state(pos, vel, mass, precision="ds32"),
                         cfg_kdk)
    final_k, _ = rollout(state2, cfg_kdk, 10)
    scale = float(jnp.max(jnp.abs(final_k.pos)))
    np.testing.assert_allclose(np.asarray(final_r.pos_full()),
                               np.asarray(final_k.pos_full()),
                               atol=5e-6 * scale)
    np.testing.assert_allclose(np.asarray(final_r.vel_full()),
                               np.asarray(final_k.vel_full()), atol=5e-5)


def _energy(state, eps2):
    pos = np.asarray(state.pos_full(), np.float64)
    vel = np.asarray(state.vel_full(), np.float64)
    mass = np.asarray(state.mass, np.float64)
    alive = np.asarray(state.alive)
    m = np.where(alive, mass, 0.0)
    K = 0.5 * np.sum(m * np.sum(vel * vel, -1))
    d = pos[None] - pos[:, None]
    r = np.sqrt(np.sum(d * d, -1) + eps2)
    off = 1.0 - np.eye(len(m))
    U = -0.5 * np.sum(m[:, None] * m[None] * off / r)
    return K + U


def test_energy_and_momentum_conservation():
    n = 256
    pos, vel, mass = _cluster(n, 13)
    cfg, state = _make_cfg(pos, vel, mass, k=4)
    e0 = _energy(state, cfg.eps2)
    p0 = np.sum(np.asarray(state.mass)[:, None]
                * np.asarray(state.vel_full(), np.float64), axis=0)
    final, _, diag = respa_rollout(state, cfg, 400)
    assert int(diag["overflow"]) == 0 and int(diag["skin_violation"]) == 0
    e1 = _energy(final, cfg.eps2)
    assert abs((e1 - e0) / e0) < 2e-4
    p1 = np.sum(np.asarray(final.mass)[:, None]
                * np.asarray(final.vel_full(), np.float64), axis=0)
    np.testing.assert_allclose(p1, p0, atol=2e-5)


def test_respa_tracks_kdk_trajectory():
    """Over a short horizon the multirate trajectory must track plain
    KDK at the same dt (the split changes the integrator's error terms,
    not the dynamics)."""
    n = 192
    pos, vel, mass = _cluster(n, 17)
    cfg, state = _make_cfg(pos, vel, mass, k=4)
    final_r, _, _ = respa_rollout(state, cfg, 40)
    cfg_kdk = SimConfig(dt=cfg.dt, G=1.0, eps2=cfg.eps2, force_impl="dense")
    state2 = init_forces(make_state(pos, vel, mass, precision="ds32"),
                         cfg_kdk)
    final_k, _ = rollout(state2, cfg_kdk, 40)
    err = np.max(np.abs(np.asarray(final_r.pos_full())
                        - np.asarray(final_k.pos_full())))
    scale = float(np.max(np.abs(np.asarray(final_k.pos_full()))))
    assert err < 1e-3 * scale


def test_ballistic_fallback_under_starved_budgets():
    """Deliberately starved chunk budget: dropped bodies must follow the
    held-total-force ballistic path (not freeze, not corrupt), and the
    overflow must be counted."""
    n = 96
    pos, vel, mass = _cluster(n, 19)
    eps2 = 1e-4
    cfg = SimConfig(dt=1e-3, G=1.0, eps2=eps2, integrator="respa",
                    respa_k=4, respa_rc=0.3, respa_cell=0.6, respa_m=10,
                    respa_max_chunks=16, respa_w_blk=4, respa_chunk=8,
                    respa_rj=16)
    state = init_forces(make_state(pos, vel, mass, precision="ds32"), cfg)
    final, _, diag = respa_rollout(state, cfg, 4)
    assert int(diag["overflow"]) > 0
    delta = 4 * cfg.dt
    fb_pos = (np.asarray(state.pos_full(), np.float64)
              + delta * np.asarray(state.vel_full(), np.float64)
              + 0.5 * delta ** 2 * np.asarray(state.acc, np.float64))
    got = np.asarray(final.pos_full(), np.float64)
    # every body is either near the ballistic path (dropped) or near the
    # integrated path; none may be frozen at the start
    moved = np.linalg.norm(got - np.asarray(state.pos_full()), axis=1)
    assert np.all(moved > 0)
    err_fb = np.linalg.norm(got - fb_pos, axis=1)
    assert np.max(err_fb) < 1e-4  # one tiny window: both paths agree


def test_skin_violation_counter():
    n = 64
    pos, _, mass = _cluster(n, 23)
    vel = np.full((n, 3), 50.0)  # absurd speed: moves >> skin in one window
    cfg, state = _make_cfg(pos, vel, mass, k=8)
    _, _, diag = respa_rollout(state, cfg, 8)
    assert int(diag["skin_violation"]) == 1


def test_recording_and_simulate_end_to_end():
    n = 128
    pos, vel, mass = _cluster(n, 29)
    cfg, state = _make_cfg(pos, vel, mass, k=4)
    final, traj, diag = respa_rollout(state, cfg, 40, record_every=8)
    assert traj.pos.shape == (5, n, 3)
    assert np.all(np.isfinite(np.asarray(traj.energy)))
    # simulate() front door (SI-ish scene, auto-probed respa budgets)
    from orbital_tpu.models.scene import SceneArrays

    m = 32
    arrays = SceneArrays(pos=pos[:m] * 1e9, vel=vel[:m] * 1e2,
                         mass=mass[:m] * 1e20, radius=np.zeros(m),
                         names=[f"b{i}" for i in range(m)],
                         uuids=[f"u{i}" for i in range(m)])
    res = ot.simulate(arrays, steps=16, dt=50.0, softening=1e7,
                      integrator="respa", respa_k=4, record_every=8)
    assert res.pos.shape[0] == 2
    assert np.isfinite(res.energy_drift)


def test_geometry_refresh_equivalence_and_skin_guard():
    """respa_refresh=4 (frozen geometry) matches per-macro rebuild while
    motion stays inside the skin; a too-thin skin trips the violation
    counter instead of silently missing pairs."""
    from orbital_tpu.engine.multirate import respa_rollout_dyn

    n = 256
    pos, vel, mass = _cluster(n, 2)
    vel *= 0.1  # slow: 16 substeps stay inside the generous skin below
    rc = 0.3
    m_grid, k_ch, w_blk = neighbor_budgets(pos, cell=2.5 * rc, chunk=8,
                                           rj=16)
    common = dict(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa",
                  respa_k=4, respa_rc=rc, respa_cell=2.5 * rc,
                  respa_m=m_grid, respa_max_chunks=k_ch,
                  respa_w_blk=w_blk, respa_chunk=8, respa_rj=16)
    outs = []
    for refresh, roll in ((1, "dyn"), (4, "dyn"), (4, "jit")):
        cfg = SimConfig(respa_refresh=refresh, **common)
        st = init_forces(make_state(pos, vel, mass, precision="f32"), cfg)
        if roll == "dyn":
            fin, d = respa_rollout_dyn(st, cfg, 4)
        else:
            from orbital_tpu.engine.multirate import respa_rollout_jit
            fin, _, d = respa_rollout_jit(st, cfg, 16)
        assert int(d["skin_violation"]) == 0
        outs.append(fin)
    # frozen geometry merely keeps a superset of the rc-pairs (S(r)=0
    # outside), so the physics must agree across refresh and rollout
    for other in outs[1:]:
        np.testing.assert_allclose(np.asarray(outs[0].pos),
                                   np.asarray(other.pos), rtol=1e-6,
                                   atol=1e-7)
    # thin skin + fast bodies -> counted violation
    vel_fast = vel * 60.0
    cfgv = SimConfig(respa_refresh=8, **{**common,
                                         "respa_cell": 1.05 * rc})
    stv = init_forces(make_state(pos, vel_fast, mass, precision="f32"),
                      cfgv)
    _, dv = respa_rollout_dyn(stv, cfgv, 8)
    assert int(dv["skin_violation"]) == 1


def test_sweep_tail_block_no_clamp_at_tight_budgets():
    """The i-side B-block slice of near_acc_slots must never clamp: with
    budgets at the occupancy ceiling (headroom=1.0) and K_ch % block
    leaving padding > rj, an out-of-range dynamic_slice start silently
    SHIFTS the tail chunks' i positions — wrong forces with every
    overflow counter zero (round-4 review finding; fixed by padding the
    i-side channels to the worst-case block read). Checks both the
    unsharded tail (block=64 vs block=8) and every i0 shard slice
    against the full sweep, bit-exactly."""
    n = 2048
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    rc, cell = 0.3, 0.6
    m, kch, w = neighbor_budgets(pos, cell=cell, chunk=8, rj=4,
                                 headroom=1.0)
    while kch % 64 == 0:                     # force a partial last block
        kch += 8
    geom = neighbor_geometry(jnp.asarray(pos), jnp.asarray(alive),
                             cell=cell, m_grid=m, chunk=8, max_chunks=kch,
                             w_blk=w, rj=4)
    n_slots = (kch + 4) * 8
    ch = [pack_slots(geom["slot"], jnp.asarray(pos[:, k]), n_slots,
                     SENTINEL_POS) for k in range(3)]
    ms = pack_slots(geom["slot"], jnp.full(n, 1.0 / n, np.float32),
                    n_slots, 0.0)
    kw = dict(r1=0.15, rc=rc, G=1.0, eps2=1e-4, chunk=8, rj=4)
    a_full = np.asarray(near_acc_slots(*ch, ms, geom["jbl"], **kw)[0])
    a_b8 = np.asarray(near_acc_slots(*ch, ms, geom["jbl"], block=8,
                                     **kw)[0])
    np.testing.assert_array_equal(a_full, a_b8)
    kd = kch // 2
    for d in range(2):
        a_l = np.asarray(near_acc_slots(
            *ch, ms, geom["jbl"][d * kd:(d + 1) * kd],
            i0=jnp.asarray(d * kd), **kw)[0])
        np.testing.assert_array_equal(a_l,
                                      a_full[d * kd * 8:(d + 1) * kd * 8])
