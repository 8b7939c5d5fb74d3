"""Integrators, rollout, collisions-as-array-ops, precision policies."""
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.engine.dsfloat import ds_add, ds_from_f64, two_sum
from orbital_tpu.engine.state import Rescale, make_state
from orbital_tpu.ops import collisions as coll
from orbital_tpu.ops.diagnostics import angular_momentum, momentum, total_energy

G_SI = ot.STANDARD.G


def _em_state(precision="f64", rescale=None, pad_to=1):
    """Earth-Moon circular pair."""
    from orbital_tpu.models.objects import Coordinates, Object, set_circular_orbit

    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3), coordinates=Coordinates(0, 0, 0))
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3), coordinates=Coordinates(3.844e8, 0, 0))
    set_circular_orbit(a, b)
    pos = np.stack([a.position(), b.position()])
    vel = np.stack([a.velocity, b.velocity])
    mass = np.array([a.mass, b.mass])
    radius = np.array([a.radius, b.radius])
    return make_state(pos, vel, mass, radius, precision=precision,
                      rescale=rescale, pad_to=pad_to)


def test_dsfloat_identities(rng):
    a = rng.normal(size=128).astype(np.float32)
    b = (rng.normal(size=128) * 1e-6).astype(np.float32)
    s, e = two_sum(a, b)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64),
    )
    x64 = rng.normal(size=64)
    hi, lo = ds_from_f64(x64)
    np.testing.assert_allclose(np.asarray(hi, np.float64) + np.asarray(lo, np.float64),
                               x64, rtol=0, atol=1e-14)


def test_kdk_energy_conservation_f64():
    st = _em_state("f64")
    cfg = ot.SimConfig(dt=3600.0, G=G_SI, eps2=1e6)
    st = ot.init_forces(st, cfg)
    E0 = float(total_energy(st.vel, st.mass, st.potential))
    fin, _ = ot.rollout_jit(st, cfg, 2000)
    E1 = float(total_energy(fin.vel, fin.mass, fin.potential))
    # leapfrog: energy error is a bounded oscillation with relative
    # amplitude O((omega dt)^2) ~ 9e-5 here, with no secular growth.
    envelope = (3600.0 * 2 * np.pi / 2.36e6) ** 2
    assert abs((E1 - E0) / E0) < envelope
    fin2, _ = ot.rollout_jit(st, cfg, 4000)
    E2 = float(total_energy(fin2.vel, fin2.mass, fin2.potential))
    assert abs((E2 - E0) / E0) < envelope
    L0 = np.asarray(angular_momentum(st.pos, st.vel, st.mass))
    L1 = np.asarray(angular_momentum(fin.pos, fin.vel, fin.mass))
    assert np.linalg.norm(L1 - L0) / np.linalg.norm(L0) < 1e-12


def test_orbit_returns_after_period():
    # set_circular_orbit puts the full relative circular speed on the
    # secondary (reference: core/physics.py:443-449), so the relative orbit
    # is slightly super-circular/elliptical; compute its true period via
    # vis-viva and check the system returns to the initial configuration.
    st = _em_state("f64")
    R = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v_rel = (1.0 + m2 / m1) * np.sqrt(mu / R)
    a_orb = 1.0 / (2.0 / R - v_rel**2 / mu)
    T = 2 * np.pi * np.sqrt(a_orb**3 / mu)
    dt = T / 2000.0
    cfg = ot.SimConfig(dt=float(dt), G=G_SI, eps2=0.0)
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 2000)
    # returns to start up to leapfrog phase error, O((omega dt)^2) per orbit
    np.testing.assert_allclose(np.asarray(fin.pos), np.asarray(st.pos), atol=3e-4 * R)


def test_ds32_beats_f32():
    rs = Rescale.natural(np.array([[0, 0, 0], [3.844e8, 0, 0]]),
                         np.array([5.972e24, 7.348e22]), G_SI)
    drifts = {}
    for prec in ("f32", "ds32"):
        st = _em_state(prec, rescale=rs)
        cfg = ot.SimConfig(dt=3600.0 / rs.time, G=rs.g_internal(G_SI), eps2=0.0)
        st = ot.init_forces(st, cfg)

        def energy64(s):
            p = np.asarray(s.pos, np.float64) + (np.asarray(s.pos_lo, np.float64) if s.pos_lo is not None else 0.0)
            v = np.asarray(s.vel, np.float64) + (np.asarray(s.vel_lo, np.float64) if s.vel_lo is not None else 0.0)
            m = np.asarray(s.mass, np.float64)
            K = 0.5 * np.sum(m * np.sum(v * v, -1))
            r = np.linalg.norm(p[0] - p[1])
            return K - cfg.G * m[0] * m[1] / r

        E0 = energy64(st)
        fin, _ = ot.rollout_jit(st, cfg, 5000)
        drifts[prec] = abs((energy64(fin) - E0) / E0)
    assert drifts["ds32"] < drifts["f32"] / 3
    assert drifts["ds32"] < 2e-6


def test_euler_integrator_runs():
    st = _em_state("f64")
    cfg = ot.SimConfig(dt=60.0, G=G_SI, integrator="euler")
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 100)
    assert float(fin.time) == pytest.approx(6000.0)
    assert np.all(np.isfinite(np.asarray(fin.pos)))


def test_rollout_recording():
    st = _em_state("f64")
    cfg = ot.SimConfig(dt=3600.0, G=G_SI)
    st = ot.init_forces(st, cfg)
    fin, traj = ot.rollout_jit(st, cfg, 100, record_every=10)
    assert traj.pos.shape == (10, 2, 3)
    assert traj.time.shape == (10,)
    np.testing.assert_allclose(np.asarray(traj.time), 3600.0 * np.arange(10, 101, 10))
    np.testing.assert_allclose(np.asarray(traj.pos[-1]), np.asarray(fin.pos))
    # recording does not perturb dynamics
    fin2, _ = ot.rollout_jit(st, cfg, 100)
    np.testing.assert_allclose(np.asarray(fin2.pos), np.asarray(fin.pos))
    with pytest.raises(ValueError):
        ot.rollout(st, cfg, 105, record_every=10)


def test_padding_is_inert():
    st = _em_state("f64")
    stp = _em_state("f64", pad_to=8)
    assert stp.n_bodies == 8 and bool(np.sum(np.asarray(stp.alive))) and np.asarray(stp.alive)[2:].sum() == 0
    cfg = ot.SimConfig(dt=3600.0, G=G_SI, eps2=1e6)
    fin, _ = ot.rollout_jit(ot.init_forces(st, cfg), cfg, 50)
    finp, _ = ot.rollout_jit(ot.init_forces(stp, cfg), cfg, 50)
    np.testing.assert_allclose(np.asarray(finp.pos)[:2], np.asarray(fin.pos), rtol=1e-14)
    assert float(finp.potential) == pytest.approx(float(fin.potential), rel=1e-14)


def test_bounce_deltas_headon():
    pos = np.array([[0.0, 0, 0], [1.5, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([5.0, 5.0])
    radius = np.array([1.0, 1.0])
    alive = np.ones(2, bool)
    dpos, dvel = coll.bounce_deltas(pos, vel, mass, radius, alive, restitution=1.0)
    np.testing.assert_allclose(np.asarray(dvel), [[-2.0, 0, 0], [2.0, 0, 0]], atol=1e-12)
    # de-overlap: total separation grows by the overlap (0.5)
    sep = (pos[1] + np.asarray(dpos)[1]) - (pos[0] + np.asarray(dpos)[0])
    assert sep[0] == pytest.approx(2.0)


def test_bounce_separating_and_nonoverlapping_noop(rng):
    pos = rng.uniform(-10, 10, (6, 3))
    vel = rng.normal(size=(6, 3))
    mass = rng.uniform(1, 2, 6)
    radius = np.full(6, 1e-3)
    alive = np.ones(6, bool)
    dpos, dvel = coll.bounce_deltas(pos, vel, mass, radius, alive, restitution=1.0)
    np.testing.assert_array_equal(np.asarray(dvel), 0.0)
    np.testing.assert_array_equal(np.asarray(dpos), 0.0)


def test_merge_groups_conservation():
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0], [10.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-2.0, 0, 0], [3.0, 0, 0]])
    mass = np.array([6.0, 3.0, 7.0])
    radius = np.array([1.0, 1.0, 1.0])
    alive = np.ones(3, bool)
    p, v, m, r, a = (np.asarray(x) for x in coll.merge_groups(pos, vel, mass, radius, alive))
    assert list(a) == [True, False, True]
    assert m[0] == 9.0 and m[2] == 7.0
    np.testing.assert_allclose(v[0], [(6 - 6) / 9.0, 0, 0])
    np.testing.assert_allclose(p[0], [3.0 / 9.0, 0, 0])
    assert r[0] == pytest.approx(2 ** (1 / 3))
    # untouched body is bit-identical
    np.testing.assert_array_equal(p[2], pos[2])
    np.testing.assert_array_equal(v[2], vel[2])


def test_merge_chain_transitive():
    # a-b overlap, b-c overlap, a-c don't: all three merge into index 0
    pos = np.array([[0.0, 0, 0], [1.5, 0, 0], [3.0, 0, 0], [99.0, 0, 0]])
    vel = np.zeros((4, 3))
    mass = np.array([1.0, 1.0, 1.0, 1.0])
    radius = np.array([1.0, 1.0, 1.0, 1.0])
    alive = np.ones(4, bool)
    p, v, m, r, a = (np.asarray(x) for x in coll.merge_groups(pos, vel, mass, radius, alive))
    assert list(a) == [True, False, False, True]
    assert m[0] == 3.0
    np.testing.assert_allclose(p[0], [1.5, 0, 0])


def test_resolve_absorb():
    """Mass ratio > 10: the smaller body is absorbed — larger gains mass
    and volume-additive radius but keeps its velocity/position (reference
    resolve_collision semantics, core/physics.py:361-388)."""
    import jax

    pos = np.array([[0.0, 0, 0], [1.5, 0, 0], [50.0, 0, 0]])
    vel = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0.0, 0, 0]])
    mass = np.array([100.0, 1.0, 4.0])
    radius = np.array([1.0, 1.0, 1.0])
    alive = np.ones(3, bool)
    p, v, m, r, a = (np.asarray(x) for x in coll.resolve_outcomes(
        pos, vel, mass, radius, alive, jax.random.PRNGKey(0)))
    assert list(a) == [True, False, True]
    assert m[0] == pytest.approx(101.0)
    assert r[0] == pytest.approx(2 ** (1 / 3))
    # absorber state untouched (mass transfer only, as in the reference)
    np.testing.assert_array_equal(p[0], pos[0])
    np.testing.assert_array_equal(v[0], vel[0])
    assert m[1] == 0.0 and r[1] == 0.0
    # bystander bit-identical
    np.testing.assert_array_equal(p[2], pos[2])


def test_resolve_fragment_high_energy():
    """Comparable masses at huge relative speed: fragmentation probability
    saturates at 1 — both bodies are removed for any key."""
    import jax

    pos = np.array([[0.0, 0, 0], [1.5, 0, 0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    alive = np.ones(2, bool)
    for seed in (0, 1, 123):
        _, _, m, _, a = (np.asarray(x) for x in coll.resolve_outcomes(
            pos, vel, mass, radius, alive, jax.random.PRNGKey(seed)))
        assert list(a) == [False, False]
        assert m.sum() == 0.0


def test_resolve_bounce_low_energy():
    """Comparable masses at low speed: falls through to the elastic
    bounce, matching bounce_deltas exactly."""
    import jax

    pos = np.array([[0.0, 0, 0], [1.5, 0, 0]])
    vel = np.array([[0.1, 0, 0], [-0.1, 0, 0]])
    mass = np.array([5.0, 5.0])
    radius = np.array([1.0, 1.0])
    alive = np.ones(2, bool)
    # p_frag = sigmoid(-5) ~ 0.0067; PRNGKey(0)'s draws exceed it (checked)
    p, v, m, r, a = (np.asarray(x) for x in coll.resolve_outcomes(
        pos, vel, mass, radius, alive, jax.random.PRNGKey(0)))
    assert list(a) == [True, True]
    dpos, dvel = coll.bounce_deltas(pos, vel, mass, radius, alive,
                                    restitution=1.0)
    np.testing.assert_allclose(p, pos + np.asarray(dpos), atol=1e-12)
    np.testing.assert_allclose(v, vel + np.asarray(dvel), atol=1e-12)
    np.testing.assert_array_equal(m, mass)


def test_resolve_fragmentation_statistics():
    """At E_coll == E_thresh the fragmentation probability is exactly 1/2:
    the per-key outcome frequency must match."""
    import math

    import jax
    import jax.numpy as jnp

    # equal unit masses: mu = 1/2, E_thresh = 1e3; v_rel^2 = 4e3 gives
    # E_coll = 1e3 exactly
    v_half = math.sqrt(4e3) / 2.0
    pos = jnp.asarray([[0.0, 0, 0], [1.5, 0, 0]])
    vel = jnp.asarray([[v_half, 0, 0], [-v_half, 0, 0]])
    mass = jnp.ones(2)
    radius = jnp.ones(2)
    alive = jnp.ones(2, bool)

    keys = jax.random.split(jax.random.PRNGKey(42), 512)
    frag = jax.vmap(
        lambda k: ~coll.resolve_outcomes(pos, vel, mass, radius, alive, k)[4][0]
    )(keys)
    frac = float(np.asarray(frag).mean())
    assert 0.40 < frac < 0.60


def test_resolve_collisions_in_rollout():
    """collisions='resolve' under the scanned rollout: a 15x mass ratio
    contact resolves as absorption, reproducibly."""
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([30.0, 2.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="resolve", frag_seed=3)
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 200)
    alive = np.asarray(fin.alive)
    assert alive.tolist() == [True, False]
    assert float(np.asarray(fin.mass)[0]) == pytest.approx(32.0)
    # absorber keeps its pre-contact velocity (reference absorb semantics)
    np.testing.assert_allclose(np.asarray(fin.vel)[0], [1.0, 0, 0],
                               atol=1e-9)


def test_resolve_debris_spawn_conserves():
    """debris_k > 0: a fragmenting pair spawns K fragments into entry-dead
    slots conserving mass, momentum, and total volume exactly, with spread
    KE = debris_energy_frac * E_coll about the pair's center of mass."""
    import jax

    # two certain-fragmentation bodies (as in the high-energy test) plus
    # four parked dead slots for the debris
    pos = np.array([[0.0, 0, 0], [1.5, 0, 0],
                    [1e6, 0, 0], [1e6, 1, 0], [1e6, 2, 0], [1e6, 3, 0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0],
                    [0.0, 0, 0], [0.0, 0, 0], [0.0, 0, 0], [0.0, 0, 0]])
    mass = np.array([2.0, 3.0, 0.0, 0.0, 0.0, 0.0])
    radius = np.array([1.0, 1.0, 0.0, 0.0, 0.0, 0.0])
    alive = np.array([True, True, False, False, False, False])
    eta = 0.3
    p, v, m, r, a = (np.asarray(x) for x in coll.resolve_outcomes(
        pos, vel, mass, radius, alive, jax.random.PRNGKey(7),
        debris_k=4, debris_energy_frac=eta))
    # originals dead; all four spare slots now carry fragments
    assert list(a) == [False, False, True, True, True, True]
    np.testing.assert_allclose(m[2:], 5.0 / 4)
    np.testing.assert_allclose(m.sum(), 5.0)
    # momentum: p_tot = 2*500 - 3*500 = -500 along x, exactly conserved
    np.testing.assert_allclose((m[:, None] * v).sum(axis=0), [-500.0, 0, 0],
                               rtol=1e-12, atol=1e-11)
    # volume-additive radii split K ways
    np.testing.assert_allclose(r[2:] ** 3 * 4, 2.0, rtol=1e-12)
    # spread KE about the COM velocity = eta * E_coll (mu v_rel^2 / 2)
    v_com = np.array([-100.0, 0, 0])
    ke = 0.5 * (m[2:, None] * (v[2:] - v_com) ** 2).sum()
    e_coll = 0.5 * (2.0 * 3.0 / 5.0) * 1000.0 ** 2
    np.testing.assert_allclose(ke, eta * e_coll, rtol=1e-10)


def test_resolve_debris_without_free_slots_matches_reference():
    """No entry-dead slots: debris_k falls back to plain removal — output
    identical to the debris_k=0 (reference) semantics."""
    import jax

    pos = np.array([[0.0, 0, 0], [1.5, 0, 0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    alive = np.ones(2, bool)
    key = jax.random.PRNGKey(0)
    base = coll.resolve_outcomes(pos, vel, mass, radius, alive, key)
    deb = coll.resolve_outcomes(pos, vel, mass, radius, alive, key,
                                debris_k=3)
    for x, y in zip(base, deb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resolve_debris_in_rollout():
    """Debris under the scanned rollout: a certain-fragmentation impact
    with spare=4 capacity and debris_k=2 leaves two co-moving fragments
    carrying the pair's exact mass and momentum."""
    pos = np.array([[-2.5, 0, 0], [2.5, 0, 0]])
    vel = np.array([[500.0, 0, 0], [-500.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64", spare=4)
    assert st.n_bodies == 6
    cfg = ot.SimConfig(dt=1e-3, G=1e-20, collisions="resolve", frag_seed=5,
                       debris_k=2, debris_energy_frac=0.0)
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 10)
    a = np.asarray(fin.alive)
    m = np.asarray(fin.mass)
    v = np.asarray(fin.vel)
    assert not a[0] and not a[1] and a.sum() == 2
    np.testing.assert_allclose(m.sum(), 5.0)
    # zero spread KE: both fragments move at exactly the COM velocity
    np.testing.assert_allclose(v[a], [[-100.0, 0, 0]] * 2, atol=1e-9)


def test_resolve_subset_matches_dense():
    """The contact-subset wrapper must reproduce the dense outcome model
    exactly in the roll-free regimes (absorb and saturated fragmentation
    with debris) — untouched bodies bit-identical, same global debris
    slots. Dead bodies'
    park positions are scheme-dependent (far = f(scene extent, local
    index)) and only owe the "far from every live body" contract."""
    import jax

    rng = np.random.default_rng(7)
    n = 256
    pos = rng.normal(size=(n, 3)) * 50.0
    vel = np.zeros((n, 3))
    mass = rng.uniform(1.0, 2.0, n)
    radius = np.full(n, 0.01)
    alive = np.ones(n, bool)
    alive[40:52] = False  # entry-dead slots for debris
    # one absorb pair and one certain-frag pair, far apart
    pos[0], pos[1] = [0.0, 0, 0], [0.015, 0, 0]
    mass[0], mass[1] = 100.0, 1.0
    pos[2], pos[3] = [200.0, 0, 0], [200.015, 0, 0]
    vel[2], vel[3] = [500.0, 0, 0], [-500.0, 0, 0]
    key = jax.random.PRNGKey(3)
    kw = dict(debris_k=3, debris_max_pairs=2)
    dense = coll.resolve_outcomes(pos, vel, mass, radius, alive, key, **kw)
    sub = coll.resolve_outcomes_subset(pos, vel, mass, radius, alive, key,
                                       subset=16, chunk=64, **kw)
    assert int(sub[5]) == 0  # 4 touching bodies fit the budget of 16
    d_alive = np.asarray(dense[4])
    parked = alive & ~d_alive  # newly dead this round -> parked far away
    for name, d, s in zip(("pos", "vel", "mass", "radius", "alive"),
                          dense, sub[:5]):
        d, s = np.asarray(d), np.asarray(s)
        if name == "pos":
            # parked rows: scheme-dependent coordinates, but far
            np.testing.assert_array_equal(d[~parked], s[~parked])
            assert (np.abs(s[parked]).max(axis=1) > 1e7).all()
        else:
            np.testing.assert_array_equal(d, s)


def test_resolve_subset_deferral_drains():
    """Contacts beyond the subset budget are counted as deferred and
    resolved by repeated application (deferral is not loss)."""
    import jax

    # 8 disjoint absorb pairs, budget of 4 bodies -> 2 pairs per round
    n = 16
    pos = np.zeros((n, 3))
    for p in range(8):
        pos[2 * p] = [10.0 * p, 0, 0]
        pos[2 * p + 1] = [10.0 * p + 0.015, 0, 0]
    vel = np.zeros((n, 3))
    mass = np.array([100.0, 1.0] * 8)
    radius = np.full(n, 0.01)
    alive = np.ones(n, bool)
    key = jax.random.PRNGKey(0)
    deferred0 = None
    for round_i in range(5):
        out = coll.resolve_outcomes_subset(pos, vel, mass, radius, alive,
                                           key, subset=4, chunk=8)
        pos, vel, mass, radius, alive = (np.asarray(x) for x in out[:5])
        if deferred0 is None:
            deferred0 = int(out[5])
        if not int(out[5]):
            break
    assert deferred0 == 16 - 4  # first round saw 16 touching, kept 4
    assert alive.sum() == 8  # every small body eventually absorbed
    np.testing.assert_allclose(mass[alive], 101.0)


def test_resolve_in_rollout_above_dense_ceiling():
    """collisions='resolve' now composes with the scanned rollout above
    the dense [N, N] ceiling: an absorb pair resolves at N = 8192 via the
    contact-subset path inside jit."""
    n = 8192
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(n, 3)) * 1e4
    vel = np.zeros((n, 3))
    mass = np.ones(n)
    radius = np.full(n, 1e-3)
    pos[17], pos[31] = [0.0, 0, 0], [1e-3, 0, 0]
    mass[17] = 100.0
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-6, G=1e-30, collisions="resolve",
                       resolve_subset=64)
    fin, _ = ot.rollout_jit(ot.init_forces(st, cfg), cfg, 2)
    a = np.asarray(fin.alive)
    m = np.asarray(fin.mass)
    assert not a[31] and a[17]
    assert m[17] == pytest.approx(101.0)
    assert a.sum() == n - 1


def test_bounce_collisions_in_rollout_conserve_momentum():
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="bounce", restitution=1.0)
    st = ot.init_forces(st, cfg)
    p0 = np.asarray(momentum(st.vel, st.mass))
    fin, _ = ot.rollout_jit(st, cfg, 200)
    p1 = np.asarray(momentum(fin.vel, fin.mass))
    np.testing.assert_allclose(p1, p0, atol=1e-12)
    # they bounced: both moving apart now
    v = np.asarray(fin.vel)
    assert v[0, 0] < 0 < v[1, 0]


def test_merge_collisions_in_rollout():
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="merge")
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 200)
    alive = np.asarray(fin.alive)
    assert alive.tolist() == [True, False]
    assert float(np.asarray(fin.mass)[0]) == 5.0
    np.testing.assert_allclose(np.asarray(fin.vel)[0], [(2 - 3) / 5.0, 0, 0], atol=1e-12)


def test_hermite_bounce_collisions_in_rollout():
    """Hermite + bounce: the fused predicted-position contact gate
    (rollout.resolve_accel_jerk_detect_fn) must not change collision
    semantics — momentum conserved, bodies separate after the bounce."""
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="bounce",
                       restitution=1.0, integrator="hermite")
    st = ot.init_forces(st, cfg)
    p0 = np.asarray(momentum(st.vel, st.mass))
    fin, _ = ot.rollout_jit(st, cfg, 200)
    p1 = np.asarray(momentum(fin.vel, fin.mass))
    np.testing.assert_allclose(p1, p0, atol=1e-12)
    v = np.asarray(fin.vel)
    assert v[0, 0] < 0 < v[1, 0]


def test_hermite_merge_collisions_in_rollout():
    pos = np.array([[0.0, 0, 0], [5.0, 0, 0]])
    vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    mass = np.array([2.0, 3.0])
    radius = np.array([1.0, 1.0])
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="merge",
                       integrator="hermite")
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 200)
    assert np.asarray(fin.alive).tolist() == [True, False]
    assert float(np.asarray(fin.mass)[0]) == 5.0


def test_rk4_more_accurate_than_kdk():
    # one full orbit: RK4's position error is orders of magnitude below
    # leapfrog's at the same dt
    R = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v_rel = (1.0 + m2 / m1) * np.sqrt(mu / R)
    a_orb = 1.0 / (2.0 / R - v_rel**2 / mu)
    T = 2 * np.pi * np.sqrt(a_orb**3 / mu)
    errs = {}
    for integ in ("kdk", "rk4"):
        st = _em_state("f64")
        cfg = ot.SimConfig(dt=float(T / 500.0), G=G_SI, integrator=integ)
        st = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(st, cfg, 500)
        errs[integ] = np.abs(np.asarray(fin.pos) - np.asarray(st.pos)).max()
    assert errs["rk4"] < errs["kdk"] / 100.0


def test_rk4_converges_4th_order():
    st = _em_state("f64")
    base_dt = 4000.0
    horizon = 16  # steps at base dt
    finals = {}
    for k in (1, 2):
        cfg = ot.SimConfig(dt=base_dt / k, G=G_SI, integrator="rk4")
        s = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(s, cfg, horizon * k)
        finals[k] = np.asarray(fin.pos)
    # error(dt) ~ C dt^4: halving dt shrinks the Richardson difference ~16x
    cfg = ot.SimConfig(dt=base_dt / 4, G=G_SI, integrator="rk4")
    fin, _ = ot.rollout_jit(ot.init_forces(st, cfg), cfg, horizon * 4)
    ref = np.asarray(fin.pos)
    e1 = np.abs(finals[1] - ref).max()
    e2 = np.abs(finals[2] - ref).max()
    assert e1 / e2 > 10.0  # ~16 for clean 4th order


def test_rollout_is_differentiable():
    """Gradients flow through the compiled stepper (optimization/fitting
    use cases the reference cannot express): finite-difference check of
    d(final kinetic energy)/d(initial velocity scale)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 16
    pos = rng.normal(size=(n, 3))
    vel0 = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-2, force_impl="dense")

    def loss(scale):
        st = make_state(pos, vel0, mass, precision="f64")
        st = st.replace(vel=st.vel * scale)
        st = ot.init_forces(st, cfg)
        fin, _ = ot.rollout(st, cfg, 20)
        return 0.5 * jnp.sum(fin.mass * jnp.sum(fin.vel**2, -1))

    g = jax.grad(loss)(1.0)
    eps = 1e-6
    fd = (loss(1.0 + eps) - loss(1.0 - eps)) / (2 * eps)
    assert float(g) == pytest.approx(float(fd), rel=1e-6)
    # remat keeps long-rollout memory bounded without changing values
    import functools

    def loss_remat(scale):
        st = make_state(pos, vel0, mass, precision="f64")
        st = st.replace(vel=st.vel * scale)
        st = ot.init_forces(st, cfg)
        from orbital_tpu.engine.integrators import make_step_fn
        from orbital_tpu.engine.rollout import resolve_force_fn

        step = jax.checkpoint(make_step_fn(cfg, resolve_force_fn(cfg, n)))
        fin = jax.lax.fori_loop(0, 20, lambda _, s: step(s), st)
        return 0.5 * jnp.sum(fin.mass * jnp.sum(fin.vel**2, -1))

    g2 = jax.grad(loss_remat)(1.0)
    assert float(g2) == pytest.approx(float(g), rel=1e-9)


def test_hermite_matches_kdk_accuracy_per_eval():
    # Hermite: 4th order at ONE combined acc+jerk eval per step; over one
    # orbit its position error should crush leapfrog's at the same dt
    R = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v_rel = (1.0 + m2 / m1) * np.sqrt(mu / R)
    a_orb = 1.0 / (2.0 / R - v_rel**2 / mu)
    T = 2 * np.pi * np.sqrt(a_orb**3 / mu)
    errs = {}
    for integ in ("kdk", "hermite"):
        st = _em_state("f64")
        cfg = ot.SimConfig(dt=float(T / 500.0), G=G_SI, integrator=integ)
        st = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(st, cfg, 500)
        errs[integ] = np.abs(np.asarray(fin.pos) - np.asarray(st.pos)).max()
    assert errs["hermite"] < errs["kdk"] / 100.0


def test_hermite_energy_conservation():
    st = _em_state("f64")
    cfg = ot.SimConfig(dt=3600.0, G=G_SI, integrator="hermite")
    st = ot.init_forces(st, cfg)
    assert st.jerk is not None
    E0 = float(total_energy(st.vel, st.mass, st.potential))
    fin, _ = ot.rollout_jit(st, cfg, 2000)
    E1 = float(total_energy(fin.vel, fin.mass, fin.potential))
    assert abs((E1 - E0) / E0) < 1e-8


def test_hermite_checkpoint_roundtrip(tmp_path):
    from orbital_tpu.engine import checkpoint as ckpt

    st = _em_state("f64")
    cfg = ot.SimConfig(dt=3600.0, G=G_SI, integrator="hermite")
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 10)
    ckpt.save_state(fin, tmp_path / "h.npz", meta={"x": 1})
    restored, meta = ckpt.load_state(tmp_path / "h.npz")
    assert meta == {"x": 1}
    assert restored.jerk is not None
    # resumed hermite continues identically
    a, _ = ot.rollout_jit(fin, cfg, 5)
    b, _ = ot.rollout_jit(restored, cfg, 5)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))


def test_leapfrog_time_reversibility():
    """KDK is time-reversible: integrate forward, flip velocities,
    integrate back — the system returns to its initial state to round-off."""
    rng = np.random.default_rng(11)
    n = 16
    st0 = make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.2,
                     rng.uniform(0.5, 1.5, n) / n, precision="f64")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-2)
    st = ot.init_forces(st0, cfg)
    fwd, _ = ot.rollout_jit(st, cfg, 500)
    back = ot.init_forces(fwd.replace(vel=-fwd.vel), cfg)
    rev, _ = ot.rollout_jit(back, cfg, 500)
    np.testing.assert_allclose(np.asarray(rev.pos), np.asarray(st0.pos),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(-rev.vel), np.asarray(st0.vel),
                               atol=1e-10)


def test_solar_system_decade_conservation():
    """15-body solar system, 10 years at dt = 1 day (f64): energy and
    angular momentum conserved to machine-noise levels."""
    from orbital_tpu.models.datasets import solar_system_v2
    from orbital_tpu.models.scene import compile_system

    scene = compile_system(solar_system_v2(moons=False))
    st = make_state(scene.pos, scene.vel, scene.mass, scene.radius,
                    precision="f64")
    cfg = ot.SimConfig(dt=86400.0, G=G_SI, eps2=1e12)
    st = ot.init_forces(st, cfg)
    E0 = float(total_energy(st.vel, st.mass, st.potential))
    L0 = np.asarray(angular_momentum(st.pos, st.vel, st.mass))
    fin, _ = ot.rollout_jit(st, cfg, 3650)
    E1 = float(total_energy(fin.vel, fin.mass, fin.potential))
    L1 = np.asarray(angular_momentum(fin.pos, fin.vel, fin.mass))
    # Mercury (T = 88 d) at dt = 1 d has a bounded (w dt)^2 energy
    # oscillation of ~2.5e-6 relative; that is physics, not drift
    assert abs((E1 - E0) / E0) < 1e-5
    assert np.linalg.norm(L1 - L0) / np.linalg.norm(L0) < 1e-12
    # nobody was ejected: all bodies within 100 AU
    r = np.linalg.norm(np.asarray(fin.pos), axis=1)
    assert r.max() < 100 * 1.495978707e11


def test_merge_fuzz_invariants(rng):
    """Random overlap configurations: merging always conserves total mass
    and momentum, never resurrects dead bodies, and alive bodies keep
    positive mass."""
    for trial in range(5):
        n = 24
        pos = rng.uniform(-2, 2, (n, 3))
        vel = rng.normal(size=(n, 3))
        mass = rng.uniform(0.1, 2.0, n)
        radius = rng.uniform(0.05, 0.9, n)
        alive = rng.random(n) > 0.2
        mass_eff = mass * alive
        p0 = (mass_eff[:, None] * vel).sum(0)
        m0 = mass_eff.sum()
        p, v, m, r, a = (np.asarray(x) for x in coll.merge_groups(
            pos, vel, mass * alive, radius, alive))
        assert m.sum() == pytest.approx(m0, rel=1e-12)
        np.testing.assert_allclose((m[:, None] * v).sum(0), p0, atol=1e-12)
        assert not np.any(a & ~alive)          # no resurrections
        assert np.all(m[a] > 0)                # alive implies massive
        assert np.all(m[~a] == 0)              # dead implies massless


def test_hermite_adaptive_dt_close_encounter():
    """Highly eccentric two-body orbit: adaptive Hermite shrinks dt through
    periapsis and conserves energy orders of magnitude better than the same
    ceiling dt fixed."""
    m1, m2 = 1.0, 1e-3
    a_orb, e = 1.0, 0.95
    # start at apoapsis
    r_apo = a_orb * (1 + e)
    v_apo = np.sqrt((m1 + m2) * (2 / r_apo - 1 / a_orb))
    pos = np.array([[0.0, 0, 0], [r_apo, 0, 0]])
    vel = np.array([[0.0, 0, 0], [0.0, v_apo, 0]])
    T = 2 * np.pi * np.sqrt(a_orb**3 / (m1 + m2))
    dt_max = T / 500.0
    drifts = {}
    times = {}
    for eta in (None, 0.02):
        st = make_state(pos, vel, np.array([m1, m2]), precision="f64")
        cfg = ot.SimConfig(dt=float(dt_max), G=1.0, eps2=1e-12,
                           integrator="hermite", adaptive_eta=eta,
                           dt_min=float(dt_max) * 1e-4)
        st = ot.init_forces(st, cfg)
        E0 = float(total_energy(st.vel, st.mass, st.potential))
        fin, _ = ot.rollout_jit(st, cfg, 1500)
        E1 = float(total_energy(fin.vel, fin.mass, fin.potential))
        key = "adaptive" if eta else "fixed"
        drifts[key] = abs((E1 - E0) / E0)
        times[key] = float(fin.time)
    # adaptive took smaller steps near periapsis (less simulated time)...
    assert times["adaptive"] < times["fixed"]
    # ...and conserved energy far better
    assert drifts["adaptive"] < drifts["fixed"] / 100.0


def test_collision_roots_chunked_matches_dense(rng):
    n = 256
    pos = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    radius = np.full(n, 0.1, np.float32)
    alive = rng.uniform(size=n) > 0.1
    r_dense = np.asarray(coll.collision_roots(pos, radius, alive))
    for chunk in (32, 64, 100, 256):
        r_chunk = np.asarray(coll.collision_roots_chunked(
            pos, radius, alive, chunk=chunk))
        np.testing.assert_array_equal(r_chunk, r_dense)


def test_merge_groups_chunked_matches_dense(rng):
    n = 128
    pos = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    radius = np.full(n, 0.1, np.float32)
    alive = np.ones(n, bool)
    outs_d = coll.merge_groups(pos, vel, mass, radius, alive)
    outs_c = coll.merge_groups(pos, vel, mass, radius, alive, chunk=32)
    for a, b in zip(outs_c, outs_d):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_in_rollout_above_dense_ceiling(rng):
    """merge mode above _DENSE_BOUNCE_MAX_N routes chunked root finding."""
    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    n = 8192
    pos = rng.normal(size=(n, 3)) * 50.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = np.full(n, 1.0 / n)
    radius = np.full(n, 1e-4)
    # plant one definitely-overlapping pair
    pos[1] = pos[0] + 1e-5
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1e-6, eps2=1e-4, collisions="merge",
                       force_impl="chunked", chunk=1024)
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 1)
    alive = np.asarray(fin.alive)
    assert not alive[1] and alive[0]
    assert float(np.asarray(fin.mass)[0]) == pytest.approx(2.0 / n, rel=1e-5)


def test_yoshida4_more_accurate_than_kdk():
    # one full orbit at the same dt: the 4th-order symplectic composition
    # lands orders of magnitude closer to the start than plain leapfrog
    R = 3.844e8
    m1, m2 = 5.972e24, 7.348e22
    mu = G_SI * (m1 + m2)
    v_rel = (1.0 + m2 / m1) * np.sqrt(mu / R)
    a_orb = 1.0 / (2.0 / R - v_rel**2 / mu)
    T = 2 * np.pi * np.sqrt(a_orb**3 / mu)
    errs = {}
    for integ in ("kdk", "yoshida4"):
        st = _em_state("f64")
        cfg = ot.SimConfig(dt=float(T / 500.0), G=G_SI, integrator=integ)
        st = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(st, cfg, 500)
        errs[integ] = np.abs(np.asarray(fin.pos) - np.asarray(st.pos)).max()
    assert errs["yoshida4"] < errs["kdk"] / 100.0


def test_yoshida4_converges_4th_order():
    st = _em_state("f64")
    base_dt = 4000.0
    horizon = 16
    finals = {}
    for k in (1, 2):
        cfg = ot.SimConfig(dt=base_dt / k, G=G_SI, integrator="yoshida4")
        s = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(s, cfg, horizon * k)
        finals[k] = np.asarray(fin.pos)
    cfg = ot.SimConfig(dt=base_dt / 4, G=G_SI, integrator="yoshida4")
    fin, _ = ot.rollout_jit(ot.init_forces(st, cfg), cfg, horizon * 4)
    ref = np.asarray(fin.pos)
    e1 = np.abs(finals[1] - ref).max()
    e2 = np.abs(finals[2] - ref).max()
    assert e1 / e2 > 10.0  # ~16 for clean 4th order


def test_yoshida4_energy_error_far_below_kdk():
    # both are symplectic (bounded energy oscillation, no secular drift),
    # but the 4th-order composition's amplitude is ~(dt w)^2 smaller
    from orbital_tpu.ops import diagnostics as diag
    drift = {}
    for integ in ("kdk", "yoshida4"):
        st = _em_state("f64")
        cfg = ot.SimConfig(dt=43200.0, G=G_SI, integrator=integ)
        s = ot.init_forces(st, cfg)
        e0 = float(diag.total_energy(s.vel_full(), s.mass, s.potential))
        fin, _ = ot.rollout_jit(s, cfg, 2000)
        e1 = float(diag.total_energy(fin.vel_full(), fin.mass, fin.potential))
        drift[integ] = abs((e1 - e0) / e0)
    assert drift["yoshida4"] < drift["kdk"] / 30.0


def test_yoshida4_bounce_collisions_conserve_momentum():
    # fused detection + cond-skipped resolution works through the
    # composed stepper exactly as for kdk
    pos = np.array([[-2.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    vel = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    st = ot.make_state(pos, vel, mass=np.array([1.0, 1.0]),
                       radius=np.array([0.6, 0.6]), precision="f64")
    cfg = ot.SimConfig(dt=0.05, G=0.0, eps2=1e-12, collisions="bounce",
                       restitution=1.0, integrator="yoshida4")
    s = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(s, cfg, 100)
    p = np.asarray(fin.vel_full() * fin.mass[:, None]).sum(axis=0)
    np.testing.assert_allclose(p, 0.0, atol=1e-12)
    # they bounced: x-velocities flipped sign
    assert float(fin.vel_full()[0, 0]) < 0.0


@pytest.mark.slow
def test_resolve_debris_disk_65536_under_rollout():
    """Headline-scale debris disk: collisions='resolve' — the contact-
    subset outcome pass (absorb / fragment-with-debris) — under the
    scanned rollout at N=65536. PM far field keeps the CPU cost
    tractable; the outcome model is force-independent. Plants 40 absorb
    pairs (mass ratio 20 > 10) and 4 fragmentation pairs (comparable
    masses, E_coll ~ 60x threshold) plus 64 spare slots for debris;
    dt is tiny so contacts survive to the post-step detection."""
    import jax

    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import init_forces, rollout
    from orbital_tpu.engine.state import make_state

    n = 65536
    rng = np.random.default_rng(42)
    th = rng.uniform(0, 2 * np.pi, n)
    rr = rng.uniform(1.0, 3.0, n)
    pos = np.stack([rr * np.cos(th), rr * np.sin(th),
                    0.01 * rng.normal(size=n)], -1)
    vel = 0.05 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    radius = np.full(n, 1e-6)
    for k in range(40):                     # absorb pairs at 0..79
        i, j = 2 * k, 2 * k + 1
        pos[j] = pos[i] + np.array([1e-4, 0, 0])
        radius[i] = radius[j] = 1e-4
        mass[i] = 20.0 / n
        vel[j] = vel[i]
    for k in range(4):                      # fragment pairs at 2000..2007
        i, j = 2000 + 2 * k, 2001 + 2 * k
        pos[j] = pos[i] + np.array([1e-4, 0, 0])
        radius[i] = radius[j] = 1e-4
        vel[i] = np.array([250.0, 0, 0])
        vel[j] = np.array([-250.0, 0, 0])
    st = make_state(pos, vel, mass, radius, precision="f32", spare=64)
    cfg = ot.SimConfig(dt=1e-8, G=1.0, eps2=1e-4, force_impl="pm",
                       pm_grid=64, pm_box=(0.0, 0.0, 0.0, 8.0),
                       collisions="resolve", frag_seed=7, debris_k=2)
    st = init_forces(st, cfg)
    m0 = float(np.sum(np.asarray(st.mass) * np.asarray(st.alive)))
    final, _ = rollout(st, cfg, 2)
    a = np.asarray(final.alive)
    m = np.asarray(final.mass)
    # absorb pairs: every small partner gone, every absorber gained it
    assert not a[1:80:2].any()
    assert a[0:80:2].all()
    np.testing.assert_allclose(m[0:80:2], 21.0 / n, rtol=1e-5)
    # fragmentation removed both planted bodies of each pair...
    assert not a[2000:2008].any()
    # ...and spawned debris into the spare slots
    assert a[n:].sum() > 0
    # total live mass conserved (absorb transfers; fragments -> debris)
    m1 = float(np.sum(m * a))
    assert m1 == pytest.approx(m0, rel=1e-4)
