"""Particle-mesh solver vs the exact dense oracle (smooth-regime contract)."""
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.ops.forces import pairwise_acc_dense
from orbital_tpu.ops.pm import pm_acc_potential


@pytest.fixture
def smooth_cluster(rng):
    n = 2048
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    eps2 = 0.09  # eps ~ 3-4 cells at grid=64 over the ~7-unit box
    return pos, mass, eps2


@pytest.mark.slow
def test_pm_matches_dense_in_smooth_regime(smooth_cluster):
    pos, mass, eps2 = smooth_cluster
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=eps2)
    a, U = pm_acc_potential(pos, mass, G_grav=1.0, eps2=eps2, grid=64)
    a, a_ref = np.asarray(a), np.asarray(a_ref)
    rms = (np.sqrt(np.mean(np.sum((a - a_ref) ** 2, -1)))
           / np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert rms < 0.01  # deconvolved CIC: ~0.4% measured at eps ~ 3 cells
    assert float(U) == pytest.approx(float(U_ref), rel=0.02)
    # deconvolution is a strict accuracy win over the raw CIC solve
    a_raw, _ = pm_acc_potential(pos, mass, G_grav=1.0, eps2=eps2, grid=64,
                                deconvolve=False)
    rms_raw = (np.sqrt(np.mean(np.sum((np.asarray(a_raw) - a_ref) ** 2, -1)))
               / np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert rms < rms_raw


def test_pm_conserves_momentum(smooth_cluster):
    """CIC deposit/gather symmetry makes the PM force momentum-conserving
    to rounding, independent of accuracy."""
    pos, mass, eps2 = smooth_cluster
    a, _ = pm_acc_potential(pos, mass, G_grav=1.0, eps2=eps2, grid=64)
    net = np.abs(np.sum(mass[:, None] * np.asarray(a), axis=0)).max()
    scale = float(np.abs(np.asarray(a)).max() * mass.max())
    assert net < 1e-4 * scale


def test_pm_dead_bodies_inert(smooth_cluster, rng):
    from orbital_tpu.engine.state import far_positions

    pos, mass, eps2 = smooth_cluster
    n = len(mass)
    alive = np.ones(n, bool)
    alive[1500:] = False
    # dead bodies parked far (production invariant) must not affect the box
    pos2 = pos.copy()
    pos2[~alive] = far_positions(int((~alive).sum()), 3.0, np.float32)
    a_all, _ = pm_acc_potential(pos[alive], mass[alive],
                                G_grav=1.0, eps2=eps2, grid=64)
    a_mask, _ = pm_acc_potential(pos2, mass, alive,
                                 G_grav=1.0, eps2=eps2, grid=64)
    a_mask = np.asarray(a_mask)
    np.testing.assert_array_equal(a_mask[~alive], 0.0)
    np.testing.assert_allclose(a_mask[alive], np.asarray(a_all),
                               rtol=1e-4, atol=1e-7)


def test_pm_in_rollout(smooth_cluster):
    """force_impl='pm' drives the KDK stepper; short-horizon energy drift
    stays small in the smooth regime."""
    from orbital_tpu.engine.state import make_state

    pos, mass, eps2 = smooth_cluster
    n = len(mass)
    vel = np.zeros((n, 3))
    st = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="pm",
                       pm_grid=64)
    st = ot.init_forces(st, cfg)
    fin, traj = ot.rollout_jit(st, cfg, 40, record_every=10)
    assert np.isfinite(np.asarray(fin.pos)).all()
    E = np.asarray(traj.energy, np.float64)
    assert abs((E[-1] - E[0]) / E[0]) < 1e-3


def test_pm_requires_softening(smooth_cluster):
    pos, mass, _ = smooth_cluster
    with pytest.raises(ValueError, match="eps2"):
        pm_acc_potential(pos, mass, G_grav=1.0, eps2=0.0)


def test_pm_sharded_matches_unsharded(smooth_cluster, rng):
    """Body-sharded PM (local deposit + one psum of the grid) must agree
    with the single-device solve; collective box agreement included."""
    import jax
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.parallel.mesh import make_mesh
    from orbital_tpu.parallel.sharded import make_sharded_step, shard_state

    pos, mass, eps2 = smooth_cluster
    n = len(mass)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    st = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="pm",
                       pm_grid=32, collisions="none")
    st = ot.init_forces(st, cfg)

    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    ref = make_step_fn(cfg, resolve_force_fn(cfg, n))(st)

    mesh = make_mesh()
    step = make_sharded_step(cfg, mesh, st)
    out = step(shard_state(mesh, st))
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=1e-5, atol=1e-7)
    assert float(out.potential) == pytest.approx(float(ref.potential),
                                                 rel=1e-5)


def test_pm_static_box(smooth_cluster):
    """A pinned mesh box gives ~the same forces as the refit box (when the
    box matches the data) and is wired through SimConfig.pm_box."""
    pos, mass, eps2 = smooth_cluster
    ext = float(np.abs(pos).max()) * (1.02 + 2.0 / 64)
    a_fit, _ = pm_acc_potential(pos, mass, G_grav=1.0, eps2=eps2, grid=64)
    a_box, _ = pm_acc_potential(pos, mass, G_grav=1.0, eps2=eps2, grid=64,
                                box=(np.zeros(3, np.float32), ext))
    rms = (np.sqrt(np.mean(np.sum((np.asarray(a_box) - np.asarray(a_fit)) ** 2, -1)))
           / np.sqrt(np.mean(np.sum(np.asarray(a_fit) ** 2, -1))))
    assert rms < 0.02  # same mesh scale, slightly different origin snap

    from orbital_tpu.engine.state import make_state
    st = make_state(pos, np.zeros_like(pos), mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="pm",
                       pm_grid=64, pm_box=(0.0, 0.0, 0.0, ext))
    st = ot.init_forces(st, cfg)
    fin, _ = ot.rollout_jit(st, cfg, 5)
    assert np.isfinite(np.asarray(fin.pos)).all()
    with pytest.raises(ValueError, match="pm_box"):
        ot.SimConfig(dt=1.0, pm_box=(1.0, 2.0))


def test_pm_2d_ensemble_mesh(smooth_cluster, rng):
    """PM under the (ensemble x body) 2D mesh: vmapped members, box via
    pmin/pmax per member, one grid psum per member."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from orbital_tpu.engine.state import make_state
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    pos, mass, eps2 = smooth_cluster
    n = 512
    pos, mass = pos[:n], mass[:n]
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    base = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2, force_impl="pm",
                       pm_grid=32, collisions="none")
    base = ot.init_forces(base, cfg)
    # member 1 gets perturbed state so cross-member mixing bugs (pmean,
    # member swaps) can't hide behind identical inputs
    base2 = base.replace(vel=base.vel * 0.5,
                         pos=base.pos * np.float32(1.05))
    base2 = ot.init_forces(base2, cfg)
    step_ref = make_step_fn(cfg, resolve_force_fn(cfg, n))
    refs = [step_ref(base), step_ref(base2)]

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, axis_names=("ensemble", "body"))
    batched = jax.tree_util.tree_map(
        lambda a, b: (jnp.stack([a, b]) if a is not None else None),
        base, base2)
    step, shardings = make_sharded_ensemble_step(cfg, mesh, batched)
    batched = jax.device_put(batched, shardings)
    out = step(batched)
    for e, ref in enumerate(refs):
        np.testing.assert_allclose(np.asarray(out.pos)[e], np.asarray(ref.pos),
                                   rtol=1e-5, atol=1e-7)


def test_simulate_converts_pm_box_to_internal_units(rng):
    """pm_box arrives in scene units like softening; simulate() must
    rescale it (a raw box under natural rescale would be ~L0x too large)."""
    from orbital_tpu.models.scene import SceneArrays

    n = 256
    pos = rng.uniform(-1e11, 1e11, size=(n, 3))  # SI-ish magnitudes
    mass = rng.uniform(1e20, 1e22, n)
    arrays = SceneArrays(pos=pos, vel=np.zeros((n, 3)), mass=mass,
                         radius=np.zeros(n),
                         names=[f"b{i}" for i in range(n)],
                         uuids=[f"u{i}" for i in range(n)])
    half_phys = 2e11
    res = ot.simulate(arrays, steps=2, dt=100.0, softening=1e9,
                      force_impl="pm", pm_grid=32, precision="f32",
                      pm_box=(0.0, 0.0, 0.0, half_phys), record_every=1)
    assert np.isfinite(res.pos).all()
    # the stored config box is in internal units: half / rescale.length
    assert res.config.pm_box[3] == pytest.approx(
        half_phys / res.rescale.length, rel=1e-6)
    assert res.config.pm_box[3] < 100  # natural units are O(1-10)


def _pm_scene(rng, n=256):
    from orbital_tpu.models.scene import SceneArrays

    pos = rng.uniform(-1e11, 1e11, size=(n, 3))
    mass = rng.uniform(1e20, 1e22, n)
    return SceneArrays(pos=pos, vel=np.zeros((n, 3)), mass=mass,
                       radius=np.zeros(n),
                       names=[f"b{i}" for i in range(n)],
                       uuids=[f"u{i}" for i in range(n)])


def test_simulate_warns_when_pm_softening_below_cell_spacing(rng):
    """PM's collisionless contract (DESIGN.md): eps well below the
    mesh cell spacing is the fluctuation-dominated drift regime — simulate()
    must warn at setup instead of silently delivering 1e-2-grade drift.
    reference has no mesh solver; this guards our extension's contract."""
    arrays = _pm_scene(rng)
    half_phys = 2e11
    # grid 32 over half 2e11 -> h = 1.25e10 phys; eps = 1e8 << h/2
    with pytest.warns(UserWarning, match="cell spacing"):
        ot.simulate(arrays, steps=1, dt=100.0, softening=1e8,
                    force_impl="pm", pm_grid=32, precision="f32",
                    pm_box=(0.0, 0.0, 0.0, half_phys), record_every=1)


def test_simulate_no_pm_contract_warning_in_smooth_regime(rng):
    """eps >= half the cell spacing is inside the contract: no warning."""
    import warnings as _w
    arrays = _pm_scene(rng)
    half_phys = 2e11
    # h = 1.25e10 phys; eps = 1e10 > h/2 = 6.25e9
    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        ot.simulate(arrays, steps=1, dt=100.0, softening=1e10,
                    force_impl="pm", pm_grid=32, precision="f32",
                    pm_box=(0.0, 0.0, 0.0, half_phys), record_every=1)
    assert not [w for w in caught if "cell spacing" in str(w.message)]
