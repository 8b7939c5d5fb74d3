"""The exact-sweep GPU kernel (Triton route) vs the dense jnp oracle.

The kernel runs here in the Pallas interpreter (``interpret=True``); the
compiled kernel is checked on the card by ``gpu_tests/``. Tolerances:
both sides are float32 with different summation orders, so 1e-5 relative
on accelerations and potentials is rounding level at these N."""
import functools

import numpy as np
import pytest

from orbital_tpu.ops import pallas_forces as pf
from orbital_tpu.ops.forces import pairwise_acc_dense

pairwise_acc_pallas = functools.partial(pf.pairwise_acc_pallas,
                                        interpret=True)


@pytest.fixture
def cluster(rng):
    n = 256
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return pos, mass


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_matches_dense_softened(cluster):
    pos, mass = cluster
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
    a, U = pairwise_acc_pallas(pos, mass, G=1.0, eps2=1e-4)
    assert _relerr(a, a_ref) < 1e-5
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_matches_dense_unsoftened(cluster):
    # eps2 == 0 exercises the masked branch
    pos, mass = cluster
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=0.0)
    a, U = pairwise_acc_pallas(pos, mass, G=1.0, eps2=0.0)
    assert np.all(np.isfinite(np.asarray(a)))
    assert _relerr(a, a_ref) < 1e-5
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_alive_mask_and_padding(cluster):
    pos, mass = cluster
    alive = np.ones(len(mass), bool)
    alive[200:] = False
    pos[200:] = 0.0  # padding parked at the origin (coincident)
    a_ref, U_ref = pairwise_acc_dense(pos, mass, alive, G=1.0, eps2=1e-4)
    a, U = pairwise_acc_pallas(pos, mass, alive, G=1.0, eps2=1e-4)
    assert np.all(np.isfinite(np.asarray(a)))
    np.testing.assert_array_equal(np.asarray(a)[~alive], 0.0)
    assert _relerr(np.asarray(a)[alive], np.asarray(a_ref)[alive]) < 1e-5
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_no_potential_variant(cluster):
    pos, mass = cluster
    a_pe, _ = pairwise_acc_pallas(pos, mass, G=1.0, eps2=1e-4)
    a, U = pairwise_acc_pallas(pos, mass, G=1.0, eps2=1e-4,
                               with_potential=False)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a_pe))
    assert float(U) == 0.0


def test_tile_shrinking():
    """TI halves at small N (down to 16) so the grid still fills the
    card; TJ and the warp count stay the variant's tuned values; N pads
    up to a multiple of the larger tile."""
    ti, tj, warps = pf.DEFAULT_TILES["acc"]
    assert pf.pick_tiles(1 << 20) == (ti, tj, warps)
    assert pf.pick_tiles(512) == (16, tj, warps)
    assert pf.pick_tiles(100, "jerk")[0] == 16
    assert pf._padded(100, 16, 32) == 128
    assert pf._padded(128, 16, 32) == 128


# ---- the kernel against a float64 dense reference ----

def _f64_reference(pos, vel, mass, eps2):
    """Plain numpy float64 acc, jerk and potential (pairs once)."""
    p = pos.astype(np.float64)
    v = vel.astype(np.float64)
    m = mass.astype(np.float64)
    d = p[None, :, :] - p[:, None, :]                     # r_j - r_i
    dv = v[None, :, :] - v[:, None, :]
    r2 = (d * d).sum(-1)
    off = ~np.eye(len(m), dtype=bool)
    s2 = np.where(off, r2 + eps2, 1.0)
    inv = np.where(off, s2 ** -0.5, 0.0)
    w = m[None, :] * inv ** 3
    acc = (w[..., None] * d).sum(1)
    rv = (d * dv).sum(-1)
    jerk = (w[..., None] * (dv - 3.0 * (rv * inv * inv)[..., None] * d)).sum(1)
    U = -0.5 * float((m[:, None] * m[None, :] * inv).sum())
    return acc, jerk, U


def _bodies(rng, n):
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return pos, vel, mass


@pytest.mark.parametrize("eps2", [1e-3, 0.0])
@pytest.mark.parametrize("pe", [True, False])
@pytest.mark.parametrize("n", [96, 256, 300])
def test_kernel_matches_f64_reference(rng, n, pe, eps2):
    """Any N (96 and 300 need padding), with and without the potential,
    softened and not: float32 kernel vs float64 numpy. 1e-5 relative is
    float32 rounding over a few hundred terms."""
    pos, vel, mass = _bodies(rng, n)
    acc_ref, _, U_ref = _f64_reference(pos, vel, mass, eps2)
    a, U = pairwise_acc_pallas(pos, mass, G=1.0, eps2=eps2,
                               with_potential=pe)
    assert _relerr(a, acc_ref) < 1e-5
    if pe:
        assert float(U) == pytest.approx(U_ref, rel=1e-5)
    else:
        assert float(U) == 0.0


@pytest.mark.parametrize("eps2", [1e-3, 0.0])
@pytest.mark.parametrize("n", [96, 300])
def test_jerk_kernel_matches_f64_reference(rng, n, eps2):
    """The jerk variant of the same body: 1e-4 relative on the jerk,
    whose terms cancel more than the acceleration's."""
    pos, vel, mass = _bodies(rng, n)
    acc_ref, jerk_ref, U_ref = _f64_reference(pos, vel, mass, eps2)
    a, j, U = pf.accel_jerk_pallas(pos, vel, mass, G=1.0, eps2=eps2,
                                   interpret=True)
    assert _relerr(a, acc_ref) < 1e-5
    assert _relerr(j, jerk_ref) < 1e-4
    assert float(U) == pytest.approx(U_ref, rel=1e-5)


@pytest.mark.parametrize("n", [100, 300])
def test_detect_kernel_counts_padded_n(rng, n):
    """Padding bodies never register contacts, at N that is not a tile
    multiple; the count equals the dense oracle's exactly."""
    from orbital_tpu.ops.collisions import count_contacts_dense

    pos, _, mass = _bodies(rng, n)
    radius = rng.uniform(0.0, 0.15, n).astype(np.float32)
    alive = np.ones(n, bool)
    c_ref = int(count_contacts_dense(pos, radius, alive))
    _, _, c = pf.pairwise_acc_detect_pallas(pos, mass, radius, alive, G=1.0,
                                            eps2=1e-4, interpret=True)
    assert c_ref > 0
    assert int(c) == c_ref


@pytest.mark.parametrize("n_i,n_j", [(128, 256), (100, 300)])
def test_block_kernel_matches_f64_reference(rng, n_i, n_j):
    """The ring's rectangular block: forces and raw pe rows of block j on
    block i (i == j terms included, as the ring expects)."""
    eps2 = 1e-3
    pos_j, _, mass_j = _bodies(rng, n_j)
    pos_i = pos_j[:n_i]
    d = pos_j[None, :, :].astype(np.float64) - pos_i[:, None, :]
    inv = ((d * d).sum(-1) + eps2) ** -0.5
    acc_ref = ((mass_j[None, :] * inv ** 3)[..., None] * d).sum(1)
    pe_ref = (mass_j[None, :] * inv).sum(1)
    a, pe = pf.block_acc_pallas(pos_i, pos_j, mass_j, G=1.0, eps2=eps2,
                                interpret=True)
    assert a.shape == (n_i, 3) and pe.shape == (n_i,)
    assert _relerr(a, acc_ref) < 1e-5
    assert _relerr(pe, pe_ref) < 1e-5


def test_kernel_refuses_cpu_without_interpret(cluster):
    """A kernel never picks the interpreter for itself: compiled for the
    GPU, it raises on the CPU unless the caller asks to interpret."""
    pos, mass = cluster
    with pytest.raises(RuntimeError, match="GPU"):
        pf.pairwise_acc_pallas(pos, mass, G=1.0, eps2=1e-4)


def test_in_rollout(rng):
    # the kernel force path drives the KDK stepper identically to dense
    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    n = 128
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    outs = {}
    for impl in ("dense", "pallas"):
        st = make_state(pos, vel, mass, precision="f32")
        cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl=impl, chunk=64)
        st = ot.init_forces(st, cfg)
        fin, _ = ot.rollout_jit(st, cfg, 20)
        outs[impl] = np.asarray(fin.pos)
    np.testing.assert_allclose(outs["pallas"], outs["dense"], rtol=0, atol=1e-5)


def test_pallas_bounce_matches_dense(rng):
    """The row-chunked bounce sweep (the large-N path) equals the dense
    one."""
    from orbital_tpu.ops.collisions import bounce_deltas, bounce_deltas_chunked

    n = 256
    pos = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    radius = np.full(n, 0.12, np.float32)
    alive = np.ones(n, bool)
    alive[250:] = False
    dp1, dv1 = bounce_deltas(pos, vel, mass, radius, alive, restitution=0.8)
    dp2, dv2 = bounce_deltas_chunked(pos, vel, mass, radius, alive,
                                     restitution=0.8, chunk=64)
    assert float(np.abs(np.asarray(dv1)).max()) > 0  # collisions occurred
    np.testing.assert_allclose(np.asarray(dv2), np.asarray(dv1), atol=5e-5)
    np.testing.assert_allclose(np.asarray(dp2), np.asarray(dp1), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(dv2)[~alive], 0.0)


@pytest.mark.slow
def test_large_n_bounce_path_in_stepper(rng):
    # > _DENSE_BOUNCE_MAX_N routes through the chunked sweep inside the step
    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.engine.state import make_state

    n = 8192
    pos = rng.normal(size=(n, 3)) * 2.0
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.02)
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, collisions="bounce",
                       force_impl="chunked", chunk=1024)
    st = ot.init_forces(st, cfg)
    step = make_step_fn(cfg, resolve_force_fn(cfg, n))
    out = step(st)
    assert np.all(np.isfinite(np.asarray(out.pos)))


# ---- Hermite acc+jerk at scale (chunked + GPU kernel vs dense oracle) ----

def test_accel_jerk_chunked_matches_dense(rng):
    from orbital_tpu.ops.forces import accel_jerk_chunked, accel_jerk_dense

    n = 256
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    a_ref, j_ref, U_ref = accel_jerk_dense(pos, vel, mass, alive,
                                           G=1.0, eps2=1e-4)
    a, j, U = accel_jerk_chunked(pos, vel, mass, alive, G=1.0, eps2=1e-4,
                                 chunk=64)
    assert _relerr(a, a_ref) < 1e-6
    assert _relerr(j, j_ref) < 1e-6
    assert float(U) == pytest.approx(float(U_ref), rel=1e-6)


@pytest.mark.parametrize("eps2", [1e-4, 0.0])
def test_accel_jerk_pallas_matches_dense(rng, eps2):
    from orbital_tpu.ops.forces import accel_jerk_dense

    n = 256
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    a_ref, j_ref, U_ref = accel_jerk_dense(pos, vel, mass, alive,
                                           G=1.0, eps2=eps2)
    a, j, U = pf.accel_jerk_pallas(pos, vel, mass, alive, G=1.0, eps2=eps2,
                                   interpret=True)
    assert _relerr(a, a_ref) < 1e-5
    assert _relerr(j, j_ref) < 1e-5
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_hermite_routes_to_scalable_jerk(rng):
    """rollout() must resolve a non-dense acc+jerk path above the dense
    ceiling; equivalence checked against the dense stepper at a routable N."""
    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import resolve_accel_jerk_fn

    n = 512
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="hermite",
                       chunk=128)
    # force the non-dense route by lowering the dense ceiling via chunked
    fn = resolve_accel_jerk_fn(cfg.replace(force_impl="chunked"), n)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = np.ones(n, bool)
    from orbital_tpu.ops.forces import accel_jerk_dense
    a_ref, j_ref, _ = accel_jerk_dense(pos, vel, mass, alive, G=1.0, eps2=1e-4)
    a, j, _ = fn(pos, vel, mass, alive)
    assert _relerr(a, a_ref) < 1e-6
    assert _relerr(j, j_ref) < 1e-6


@pytest.mark.slow
def test_hermite_rollout_large_n_smoke(rng):
    """Hermite end-to-end above the dense-memory regime (chunked on CPU)."""
    import orbital_tpu as ot

    n = 8192
    pos = rng.normal(size=(n, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    from orbital_tpu.engine.state import make_state
    state = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-2, integrator="hermite",
                       chunk=1024)
    state = ot.init_forces(state, cfg)
    final, _ = ot.rollout_jit(state, cfg, 3)
    assert np.isfinite(np.asarray(final.pos)).all()
    assert int(final.step) == 3


def test_adaptive_eta_requires_dt_min():
    import orbital_tpu as ot

    with pytest.raises(ValueError, match="dt_min"):
        ot.SimConfig(dt=1e-3, integrator="hermite", adaptive_eta=0.02)


# ---- fused contact detection (force sweep + r^2-shared detection) ----

def test_fused_detect_counts_match_dense(rng):
    from orbital_tpu.engine.state import far_positions
    from orbital_tpu.ops.collisions import count_contacts_dense

    n = 256
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.0, 0.15, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.15
    # kernel contract: dead bodies sit at spread far positions (as padding
    # and merge parking guarantee in production)
    pos[~alive] = far_positions(int((~alive).sum()), 2.0,
                                np.float32)[:, :].astype(np.float32)
    a_ref, U_ref = pairwise_acc_dense(pos, mass, alive, G=1.0, eps2=1e-4)
    c_ref = int(count_contacts_dense(pos, radius * alive, alive))
    a, U, c = pf.pairwise_acc_detect_pallas(pos, mass, radius, alive,
                                            G=1.0, eps2=1e-4, interpret=True)
    assert c_ref > 0  # the random cluster must actually have contacts
    assert int(c) == c_ref
    assert _relerr(np.asarray(a)[alive], np.asarray(a_ref)[alive]) < 1e-5
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_jerk_fused_detect_matches_dense(rng):
    """The Hermite variant: acc+jerk+U match the plain jerk kernel and the
    contact count matches the dense oracle at the same positions."""
    from orbital_tpu.engine.state import far_positions
    from orbital_tpu.ops.collisions import count_contacts_dense
    from orbital_tpu.ops.forces import accel_jerk_dense

    n = 256
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.0, 0.15, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.15
    pos[~alive] = far_positions(int((~alive).sum()), 2.0,
                                np.float32).astype(np.float32)
    a_ref, j_ref, U_ref = accel_jerk_dense(pos, vel, mass, alive,
                                           G=1.0, eps2=1e-4)
    c_ref = int(count_contacts_dense(pos, radius * alive, alive))
    a, j, U, c = pf.accel_jerk_detect_pallas(pos, vel, mass, radius, alive,
                                            G=1.0, eps2=1e-4, interpret=True)
    assert c_ref > 0
    assert int(c) == c_ref
    assert _relerr(np.asarray(a)[alive], np.asarray(a_ref)[alive]) < 1e-5
    assert _relerr(np.asarray(j)[alive], np.asarray(j_ref)[alive]) < 1e-4
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_fused_detect_zero_when_separated(rng):

    n = 128
    pos = (10.0 * np.arange(n, dtype=np.float32))[:, None] * np.ones(3, np.float32)
    mass = np.ones(n, np.float32)
    radius = np.full(n, 0.1, np.float32)
    alive = np.ones(n, bool)
    _, _, c = pf.pairwise_acc_detect_pallas(pos, mass, radius, alive,
                                            G=1.0, eps2=1e-4, interpret=True)
    assert int(c) == 0


def test_fused_detect_ignores_far_parked_dead(rng):
    """Padding + merged-dead bodies park at spread far positions and must
    never register contacts, even with huge live radii."""
    from orbital_tpu.engine.state import make_state

    n = 100
    pos = 100.0 * rng.normal(size=(n, 3))
    vel = np.zeros((n, 3))
    mass = np.ones(n)
    radius = np.full(n, 1e-3)
    st = make_state(pos, vel, mass, radius, precision="f32", pad_to=128)
    assert st.n_bodies == 128
    _, _, c = pf.pairwise_acc_detect_pallas(st.pos, st.mass, st.radius,
                                            st.alive, G=1.0, eps2=1e-4,
                                            interpret=True)
    assert int(c) == 0


@pytest.mark.parametrize("integrator", ["kdk", "euler", "rk4"])
@pytest.mark.slow
def test_cond_gated_bounce_matches_unconditional(rng, integrator):
    """Stepping with the fused-detect cond gate must be bit-identical to the
    always-sweep stepper, through both contact-free and colliding steps,
    for every integrator whose closing force eval sees collision-time
    positions."""
    import orbital_tpu as ot
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import (resolve_force_detect_fn,
                                            resolve_force_fn)
    from orbital_tpu.engine.state import make_state

    # head-on pair that collides mid-rollout, plus bystanders
    pos = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, 5.0, 0], [0, -5.0, 0]])
    vel = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0, 0], [0, 0, 0]])
    mass = np.array([1.0, 1.0, 1e-3, 1e-3])
    radius = np.array([0.3, 0.3, 0.01, 0.01])
    cfg = ot.SimConfig(dt=0.05, G=1e-4, eps2=1e-6, collisions="bounce",
                       restitution=0.8, force_impl="dense",
                       integrator=integrator)
    s_a = ot.init_forces(make_state(pos, vel, mass, radius, precision="f32"), cfg)
    s_b = s_a
    step_plain = make_step_fn(cfg, resolve_force_fn(cfg, 4))
    step_fused = make_step_fn(cfg, resolve_force_fn(cfg, 4),
                              force_detect_fn=resolve_force_detect_fn(cfg, 4))
    collided = False
    for k in range(80):
        s_a = step_plain(s_a)
        s_b = step_fused(s_b)
        np.testing.assert_array_equal(np.asarray(s_a.pos), np.asarray(s_b.pos))
        np.testing.assert_array_equal(np.asarray(s_a.vel), np.asarray(s_b.vel))
    # the pair must actually have bounced (vx signs flipped)
    assert float(np.asarray(s_a.vel)[0, 0]) < 0


def test_cond_gated_merge_in_rollout(rng):
    """merge mode through the fused gate: merge fires, dead body parks far,
    and the sweep stays skipped afterwards (no re-trigger -> state stable)."""
    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0], [0, 8.0, 0]])
    vel = np.array([[0.2, 0, 0], [-0.2, 0, 0], [0, 0, 0]])
    mass = np.array([2.0, 1.0, 1e-3])
    radius = np.array([0.2, 0.2, 0.01])
    cfg = ot.SimConfig(dt=0.1, G=1e-6, eps2=1e-8, collisions="merge",
                       force_impl="dense")
    st = ot.init_forces(make_state(pos, vel, mass, radius, precision="f32"), cfg)
    fin, _ = ot.rollout_jit(st, cfg, 60)
    alive = np.asarray(fin.alive)
    assert list(alive) == [True, False, True]
    m = np.asarray(fin.mass)
    assert m[0] == pytest.approx(3.0)
    # absorbed body parked far out of the live scene
    assert np.linalg.norm(np.asarray(fin.pos)[1]) > 1e6
