"""Sharded ring forces on a virtual 8-device CPU mesh + vmapped ensembles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.engine.state import make_state
from orbital_tpu.engine.rollout import resolve_force_fn
from orbital_tpu.engine.integrators import make_step_fn
from orbital_tpu.parallel.ensemble import energy_drift, ensemble_rollout, make_ensemble
from orbital_tpu.parallel.mesh import make_mesh
from orbital_tpu.parallel.sharded import make_sharded_step, ring_force_fn, shard_state


@pytest.fixture
def cluster_state(rng):
    n = 64
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    return make_state(pos, vel, mass, precision="f32")


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh()
    assert mesh.shape["body"] == 8


def test_ring_force_matches_dense(cluster_state, rng):
    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body")
    st = cluster_state
    a_ref, U_ref = resolve_force_fn(cfg.replace(force_impl="dense"), st.n_bodies)(
        st.pos, st.mass, st.alive)

    from jax.sharding import PartitionSpec as P
    ring = ring_force_fn(cfg, 8)
    f = jax.jit(jax.shard_map(
        ring, mesh=mesh,
        in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()),
    ))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), rtol=2e-5, atol=1e-6)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_sharded_step_matches_unsharded(cluster_state):
    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    st = ot.init_forces(cluster_state, cfg)

    step_ref = make_step_fn(cfg, resolve_force_fn(cfg.replace(force_impl="dense"), st.n_bodies))
    ref = step_ref(step_ref(st))

    sharded_step = make_sharded_step(cfg, mesh, st, axis="body")
    st_sh = shard_state(mesh, st, "body")
    out = sharded_step(sharded_step(st_sh))
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=2e-5, atol=1e-6)
    assert float(out.time) == pytest.approx(float(ref.time))
    assert int(out.step) == 2


def test_sharded_merge_matches_unsharded(rng):
    """Cross-shard merge: contact-gated all_gather + exact global merge
    must reproduce the unsharded merge step (including the rare-event
    skip path when nothing touches)."""
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn

    n = 64
    pos = rng.normal(size=(n, 3)) * 5.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 1e-3)
    # plant overlapping pairs that cross shard boundaries (8 bodies/shard)
    pos[9] = pos[0] + 5e-4   # shards 1 and 0
    pos[63] = pos[17] - 5e-4  # shards 7 and 2
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1e-4, eps2=1e-4, collisions="merge")
    st = ot.init_forces(st, cfg.replace(force_impl="dense"))

    ref_step = make_step_fn(cfg.replace(force_impl="dense"),
                            resolve_force_fn(cfg.replace(force_impl="dense"), n))
    ref = ref_step(st)
    assert not np.asarray(ref.alive).all()  # merges actually happened

    mesh = make_mesh()
    step = make_sharded_step(cfg, mesh, st)
    out = step(shard_state(mesh, st))
    np.testing.assert_array_equal(np.asarray(out.alive), np.asarray(ref.alive))
    np.testing.assert_allclose(np.asarray(out.mass), np.asarray(ref.mass),
                               rtol=2e-6)
    alive = np.asarray(ref.alive)
    np.testing.assert_allclose(np.asarray(out.pos)[alive],
                               np.asarray(ref.pos)[alive], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel)[alive],
                               np.asarray(ref.vel)[alive], rtol=2e-5, atol=1e-6)

    # a second step with no remaining contacts exercises the skip path
    out2 = step(out)
    ref2 = ref_step(ref)
    np.testing.assert_array_equal(np.asarray(out2.alive), np.asarray(ref2.alive))
    np.testing.assert_allclose(np.asarray(out2.pos)[alive],
                               np.asarray(ref2.pos)[alive], rtol=2e-5, atol=1e-6)


def test_sharded_bounce_matches_unsharded(rng):
    # dense cluster with large radii so collisions actually happen
    n = 32
    pos = rng.normal(size=(n, 3)) * 0.8
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.15)
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce",
                       restitution=0.8)
    st = ot.init_forces(st, cfg)

    step_ref = make_step_fn(cfg, resolve_force_fn(cfg.replace(force_impl="dense"), n))
    ref = st
    for _ in range(3):
        ref = step_ref(ref)

    mesh = make_mesh()
    sharded_step = make_sharded_step(cfg, mesh, st, axis="body")
    out = shard_state(mesh, st, "body")
    for _ in range(3):
        out = sharded_step(out)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=3e-5, atol=3e-6)
    # collisions occurred (otherwise this test is vacuous)
    no_coll = make_step_fn(cfg.replace(collisions="none"),
                           resolve_force_fn(cfg.replace(force_impl="dense"), n))
    ref_nc = st
    for _ in range(3):
        ref_nc = no_coll(ref_nc)
    assert not np.allclose(np.asarray(ref.vel), np.asarray(ref_nc.vel))


def test_ensemble_rollout(rng):
    n, E = 8, 16
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    base = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3)

    states = make_ensemble(base, E, jax.random.key(0), pos_sigma=1e-4)
    assert states.pos.shape == (E, n, 3)
    # member 0 unperturbed
    np.testing.assert_array_equal(np.asarray(states.pos[0]), np.asarray(base.pos))
    assert not np.allclose(np.asarray(states.pos[1]), np.asarray(base.pos))

    finals, trajs = ensemble_rollout(states, cfg, 50, record_every=10)
    assert finals.pos.shape == (E, n, 3)
    assert trajs.pos.shape == (E, 5, n, 3)
    drift = energy_drift(trajs)
    assert drift.shape == (E,)
    assert np.all(np.isfinite(drift))

    # ensemble member 0 equals a plain unbatched rollout
    st0 = ot.init_forces(base, cfg)
    fin0, _ = ot.rollout_jit(st0, cfg, 50)
    np.testing.assert_allclose(np.asarray(finals.pos[0]), np.asarray(fin0.pos),
                               rtol=1e-6, atol=1e-7)


def test_ensemble_rollout_resolve_collisions(rng):
    """collisions='resolve' under the vmapped ensemble: the per-step
    fragmentation key (frag_seed folded with the member's step counter)
    must trace under vmap, and each member must resolve independently."""
    # two bodies per member on an absorption course (mass ratio 16 > 10)
    E = 4
    pos = np.tile(np.array([[0.0, 0, 0], [5.0, 0, 0]]), (E, 1, 1))
    vel = np.tile(np.array([[1.0, 0, 0], [-1.0, 0, 0]]), (E, 1, 1))
    # member 3's bodies start far apart: no contact within the run
    pos[3, 1, 0] = 500.0
    mass = np.tile(np.array([32.0, 2.0]), (E, 1))
    radius = np.ones((E, 2))
    base = make_state(pos[0], vel[0], mass[0], radius[0], precision="f64")
    states = jax.vmap(
        lambda p, v, m, r: base.replace(pos=p, vel=v, mass=m, radius=r)
    )(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
      jnp.asarray(radius))
    cfg = ot.SimConfig(dt=0.05, G=1e-20, collisions="resolve", frag_seed=1)
    finals, _ = ensemble_rollout(states, cfg, 200, record_every=50)
    alive = np.asarray(finals.alive)
    m_fin = np.asarray(finals.mass)
    assert alive[:3].tolist() == [[True, False]] * 3
    np.testing.assert_allclose(m_fin[:3, 0], 34.0)
    assert alive[3].tolist() == [True, True]
    np.testing.assert_allclose(m_fin[3], [32.0, 2.0])


def test_ring_force_various_shard_counts(cluster_state):
    """Force results are shard-count invariant (2, 4, 8 devices)."""
    from jax.sharding import PartitionSpec as P

    st = cluster_state
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body")
    a_ref, U_ref = resolve_force_fn(cfg.replace(force_impl="dense"), st.n_bodies)(
        st.pos, st.mass, st.alive)
    for d in (2, 4, 8):
        mesh = make_mesh(shape=(d,), devices=jax.devices()[:d])
        ring = ring_force_fn(cfg, d)
        f = jax.jit(jax.shard_map(
            ring, mesh=mesh,
            in_specs=(P("body", None), P("body"), P("body")),
            out_specs=(P("body", None), P()),
        ))
        a, U = f(st.pos, st.mass, st.alive)
        np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                                   rtol=2e-5, atol=1e-6)
        assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_ensemble_same_key_reproducible(rng):
    n, E = 8, 4
    base = make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1,
                      rng.uniform(0.5, 1.5, n) / n, precision="f32")
    s1 = make_ensemble(base, E, jax.random.key(5), pos_sigma=1e-3)
    s2 = make_ensemble(base, E, jax.random.key(5), pos_sigma=1e-3)
    np.testing.assert_array_equal(np.asarray(s1.pos), np.asarray(s2.pos))
    s3 = make_ensemble(base, E, jax.random.key(6), pos_sigma=1e-3)
    assert not np.array_equal(np.asarray(s1.pos[1]), np.asarray(s3.pos[1]))


@pytest.mark.slow
def test_ensemble_rollout_tree(rng):
    """force_impl='tree' under the plain vmapped ensemble_rollout: the
    tree's sorts/scatters/searchsorted batch correctly, and the
    unperturbed control member reproduces an unbatched tree rollout."""
    base = _plummer_state(rng, n=64)
    cfg = _tree_cfg(base)
    states = make_ensemble(base, 2, jax.random.key(0), pos_sigma=1e-4)
    finals, trajs = ensemble_rollout(states, cfg, 10, record_every=5)
    assert finals.pos.shape == (2, 64, 3)
    assert np.all(np.isfinite(energy_drift(trajs)))

    st0 = ot.init_forces(base, cfg)
    fin0, _ = ot.rollout_jit(st0, cfg, 10)
    np.testing.assert_allclose(np.asarray(finals.pos[0]),
                               np.asarray(fin0.pos),
                               rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.asarray(finals.pos[1]), np.asarray(fin0.pos))


def test_sharded_ensemble_step_2d_mesh(rng):
    """(ensemble x body) 2D mesh: matches per-member unsharded stepping."""
    import jax.numpy as jnp
    from orbital_tpu.parallel.ensemble import make_ensemble
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    n, E = 32, 4
    base = make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1,
                      rng.uniform(0.5, 1.5, n) / n, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    states = make_ensemble(base, E, jax.random.key(1), pos_sigma=1e-3)
    force = resolve_force_fn(cfg.replace(force_impl="dense"), n)
    acc, U = jax.vmap(force)(states.pos, states.mass, states.alive)
    states = states.replace(acc=acc, potential=U)

    mesh = make_mesh(shape=(2, 4), axis_names=("ensemble", "body"))
    step, shardings = make_sharded_ensemble_step(cfg, mesh, states)
    placed = jax.device_put(states, shardings)
    out = step(step(placed))

    ref_step = make_step_fn(cfg, force)
    ref = states
    for _ in range(2):
        ref = jax.vmap(ref_step)(ref)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out.potential),
                               np.asarray(ref.potential), rtol=1e-4)


def test_ring_force_pallas_blocks_match_dense(rng):
    """The ring with the GPU block kernel per round (interpret mode on the
    CPU mesh) must agree with the unsharded dense force."""
    from jax.sharding import PartitionSpec as P

    n = 1024  # 8 shards x 128-body blocks (tile-aligned)
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    st = make_state(pos, vel, mass, precision="f32")
    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body",
                       ring_block_impl="pallas")
    a_ref, U_ref = resolve_force_fn(cfg.replace(force_impl="dense"), n)(
        st.pos, st.mass, st.alive)
    ring = ring_force_fn(cfg, 8)
    f = jax.jit(jax.shard_map(
        ring, mesh=mesh,
        in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()),
        check_vma=False,  # pallas-in-shard_map vma workaround
    ))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=2e-5, atol=1e-6)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_ring_force_chunked_blocks_match_dense(rng):
    """The ring with row-chunked XLA blocks (the CPU's large-shard path)
    agrees with the unsharded dense force."""
    from jax.sharding import PartitionSpec as P

    n = 1024
    pos = rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    st = make_state(pos, np.zeros_like(pos), mass, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body",
                       ring_block_impl="chunked", chunk=32)
    a_ref, U_ref = resolve_force_fn(cfg.replace(force_impl="dense"), n)(
        st.pos, st.mass, st.alive)
    f = jax.jit(jax.shard_map(
        ring_force_fn(cfg, 8), mesh=make_mesh(),
        in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P())))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=2e-5, atol=1e-6)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-5)


def test_sharded_step_with_pallas_ring_blocks(rng):
    """Full sharded KDK step with the GPU ring-block kernel (interpret
    mode) compiles and matches the unsharded stepper."""
    n = 1024
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n) / n
    st = make_state(pos, vel, mass, precision="f32")
    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, shard_axis="body",
                       ring_block_impl="pallas", collisions="none")
    st = ot.init_forces(st, cfg.replace(force_impl="dense"))
    step_ref = make_step_fn(cfg.replace(force_impl="dense"),
                            resolve_force_fn(cfg.replace(force_impl="dense"), n))
    ref = step_ref(st)
    sharded = make_sharded_step(cfg, mesh, st)
    out = sharded(shard_state(mesh, st))
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=2e-5, atol=1e-6)


def test_ensemble_axis_is_dcn_safe(rng):
    """Multi-slice (DCN) readiness: with the mesh's OUTER axis mapped to
    slices (the jax.distributed multi-slice convention), every collective
    the compiled step emits must stay WITHIN a slice — the ensemble axis
    is pure data parallelism, only the body ring communicates. Verified
    by parsing the compiled HLO's collective-permute source-target pairs:
    each pair must connect devices of the same outer-axis row."""
    import re
    from orbital_tpu.parallel.ensemble import make_ensemble
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    n, n_slices, per_slice = 32, 2, 4
    base = make_state(rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1,
                      rng.uniform(0.5, 1.5, n) / n, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    states = make_ensemble(base, n_slices, jax.random.key(1), pos_sigma=1e-3)
    force = resolve_force_fn(cfg.replace(force_impl="dense"), n)
    acc, U = jax.vmap(force)(states.pos, states.mass, states.alive)
    states = states.replace(acc=acc, potential=U)

    mesh = make_mesh(shape=(n_slices, per_slice), axis_names=("dcn", "body"))
    step, shardings = make_sharded_ensemble_step(
        cfg, mesh, states, ensemble_axis="dcn")
    placed = jax.device_put(states, shardings)
    hlo = jax.jit(step).lower(placed).compile().as_text()

    pairs = []
    for m in re.finditer(r"source_target_pairs=\{([0-9,{} ]*)\}", hlo):
        pairs += re.findall(r"\{(\d+),(\d+)\}", m.group(1))
    assert pairs, "expected the body ring's collective-permute in the HLO"
    for s, t in pairs:
        assert int(s) // per_slice == int(t) // per_slice, (
            f"collective crosses the dcn axis: {s}->{t}")
    # and no cross-slice all-reduce either: replica_groups of any
    # all-reduce must sit within one slice
    for m in re.finditer(r"replica_groups=\{(\{[0-9, ]+\}(?:,\{[0-9, ]+\})*)\}",
                         hlo):
        for grp in re.findall(r"\{([0-9, ]+)\}", m.group(1)):
            devs = [int(x) for x in grp.replace(" ", "").split(",") if x]
            assert len({d // per_slice for d in devs}) == 1, (
                f"all-reduce group crosses slices: {devs}")

    # the step still computes the right physics on this mesh
    out = step(placed)
    ref = jax.vmap(make_step_fn(cfg, force))(states)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=3e-5, atol=3e-6)


def _plummer_state(rng, n=128):
    """Concentrated cluster (the tree's regime) in natural units."""
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = r[:, None] * v
    vel = 0.05 * rng.normal(size=(n, 3))
    mass = np.full(n, 1.0 / n)
    return make_state(pos, vel, mass, precision="f32")


def _tree_cfg(st, levels=3):
    from orbital_tpu.ops.tree import tree_occupancy_probe

    occ, ncells = tree_occupancy_probe(st.pos, st.alive, levels=levels)
    return ot.SimConfig(
        dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree", tree_levels=levels,
        tree_capacity=max(16, -(-int(occ) // 8) * 8),
        tree_max_cells=-(-int(ncells) // 64) * 64)


@pytest.mark.slow
def test_sharded_tree_force_matches_single_device(rng):
    """tree_sharded_force (all_gather + partitioned near-field sweeps +
    psum) must reproduce the single-device tree exactly: each body's near
    field is computed by exactly one device, so the psum adds zeros."""
    from jax.sharding import PartitionSpec as P
    from orbital_tpu.ops.tree import tree_acc_potential, tree_sharded_force

    st = _plummer_state(rng)
    cfg = _tree_cfg(st)
    a_ref, U_ref, ovf = tree_acc_potential(
        st.pos, st.mass, st.alive, G_grav=cfg.G, eps2=cfg.eps2,
        levels=cfg.tree_levels, capacity=cfg.tree_capacity, ws=cfg.tree_ws,
        max_cells=cfg.tree_max_cells, order=cfg.tree_order)
    assert int(ovf) == 0

    mesh = make_mesh()
    f = jax.jit(jax.shard_map(
        lambda p, m, a: tree_sharded_force(
            p, m, a, axis_name="body", n_shards=8, G_grav=cfg.G,
            eps2=cfg.eps2, levels=cfg.tree_levels,
            capacity=cfg.tree_capacity, ws=cfg.tree_ws,
            max_cells=cfg.tree_max_cells, order=cfg.tree_order),
        mesh=mesh, in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()),
    ))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=1e-6, atol=1e-7)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-6)


@pytest.mark.slow
def test_sharded_tree_step_matches_unsharded(rng):
    """A full sharded KDK step with force_impl='tree' equals the
    single-device tree step."""
    st = _plummer_state(rng)
    cfg = _tree_cfg(st)
    st = ot.init_forces(st, cfg)
    mesh = make_mesh()

    ref_step = make_step_fn(cfg, resolve_force_fn(cfg, st.n_bodies))
    ref = ref_step(ref_step(st))

    sharded = make_sharded_step(cfg, mesh, st, axis="body")
    out = sharded(sharded(shard_state(mesh, st)))
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_sharded_rollout_matches_unsharded(cluster_state):
    """Multi-step sharded rollout (scan of the sharded step inside
    shard_map, strided recording) vs the single-device rollout over 100
    steps."""
    from orbital_tpu.engine.rollout import rollout
    from orbital_tpu.parallel.sharded import make_sharded_rollout

    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    st = ot.init_forces(cluster_state, cfg)

    ref_final, ref_traj = rollout(
        st, cfg.replace(force_impl="dense"), 100, record_every=25)

    roll = make_sharded_rollout(cfg, mesh, st, steps=100, record_every=25,
                                axis="body")
    out, traj = roll(shard_state(mesh, st))

    assert traj.pos.shape == (4, st.n_bodies, 3)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref_final.pos),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(traj.pos), np.asarray(ref_traj.pos),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(traj.energy),
                               np.asarray(ref_traj.energy),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(traj.ang_mom),
                               np.asarray(ref_traj.ang_mom),
                               rtol=1e-4, atol=1e-6)
    assert int(out.step) == 100
    assert float(traj.time[-1]) == pytest.approx(float(out.time))


def test_sharded_rollout_unrecorded(cluster_state):
    from orbital_tpu.engine.rollout import rollout
    from orbital_tpu.parallel.sharded import make_sharded_rollout

    mesh = make_mesh()
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    st = ot.init_forces(cluster_state, cfg)
    ref_final, _ = rollout(st, cfg.replace(force_impl="dense"), 30)

    roll = make_sharded_rollout(cfg, mesh, st, steps=30, axis="body")
    out, traj = roll(shard_state(mesh, st))
    assert traj is None
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref_final.pos),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.slow
def test_sharded_ensemble_tree_step(rng):
    """force_impl='tree' composes with the 2D (ensemble x body) mesh:
    each vmapped member runs the sharded tree (all_gather + partitioned
    near field + psum) and matches the single-device tree step."""
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    st = _plummer_state(rng, n=64)
    cfg = _tree_cfg(st)
    st = ot.init_forces(st, cfg)
    E = 2
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape)
        if x is not None else None, st)

    mesh = make_mesh(shape=(2, 4), axis_names=("ensemble", "body"))
    step, shardings = make_sharded_ensemble_step(cfg, mesh, batched)
    placed = jax.device_put(batched, shardings)
    out = step(placed)

    ref_step = make_step_fn(cfg, resolve_force_fn(cfg, st.n_bodies))
    ref = ref_step(st)
    for e in range(E):
        np.testing.assert_allclose(np.asarray(out.pos)[e],
                                   np.asarray(ref.pos),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_sharded_tree_columns_force_matches_single_device(rng):
    """The column near field (near='columns') composes with the sharded
    tree exactly like the cell sweep: disjoint column-list slices per
    device + one psum reproduce the single-device result."""
    from jax.sharding import PartitionSpec as P
    from orbital_tpu.ops.tree import (tree_acc_potential,
                                      tree_column_probe,
                                      tree_sharded_force)

    st = _plummer_state(rng)
    levels = 3
    occ, ncols, _, _ = tree_column_probe(st.pos, st.alive, levels=levels)
    kw = dict(G_grav=1.0, eps2=1e-3, levels=levels,
              capacity=max(16, -(-int(occ) // 8) * 8),
              max_cells=-(-int(ncols) // 64) * 64, ws=1, near="columns")
    a_ref, U_ref, ovf = tree_acc_potential(st.pos, st.mass, st.alive, **kw)
    assert int(ovf) == 0

    mesh = make_mesh()
    f = jax.jit(jax.shard_map(
        lambda p, m, a: tree_sharded_force(
            p, m, a, axis_name="body", n_shards=8, **kw),
        mesh=mesh, in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()),
    ))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=1e-6, atol=1e-7)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-6)

@pytest.mark.slow
def test_sharded_tree_pairs_force_matches_single_device(rng):
    """The chunk-pair near field (near='pairs') composes with the sharded
    tree exactly like the cell/column sweeps: disjoint per-octave
    entry-list slices per device + one psum reproduce the single-device
    result."""
    from jax.sharding import PartitionSpec as P
    from orbital_tpu.ops.tree import (tree_acc_potential, tree_pairs_probe,
                                      tree_sharded_force)

    st = _plummer_state(rng)
    levels = 3
    total, per = tree_pairs_probe(st.pos, st.alive, levels=levels)
    entries = tuple(int(v) + 4 if v else 0 for v in np.asarray(per))
    while entries and entries[-1] == 0:
        entries = entries[:-1]
    kw = dict(G_grav=1.0, eps2=1e-3, levels=levels, ws=1, near="pairs",
              max_chunks=int(total) + 8, pair_entries=entries)
    a_ref, U_ref, ovf = tree_acc_potential(st.pos, st.mass, st.alive, **kw)
    assert int(ovf) == 0

    mesh = make_mesh()
    f = jax.jit(jax.shard_map(
        lambda p, m, a: tree_sharded_force(
            p, m, a, axis_name="body", n_shards=8, **kw),
        mesh=mesh, in_specs=(P("body", None), P("body"), P("body")),
        out_specs=(P("body", None), P()),
    ))
    a, U = f(st.pos, st.mass, st.alive)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=1e-6, atol=1e-7)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-6)

@pytest.mark.slow
def test_ensemble_rollout_tree_pairs(rng):
    """tree_near='pairs' under the plain vmapped ensemble_rollout: the
    chunk-pair machinery (cumsums, dense maps, take_along_axis) batches
    correctly, and the unperturbed control member reproduces an
    unbatched pairs rollout."""
    from orbital_tpu.ops.tree import tree_pairs_probe

    base = _plummer_state(rng, n=64)
    total, per = tree_pairs_probe(base.pos, base.alive, levels=3)
    entries = tuple(int(v) + 4 if v else 0 for v in np.asarray(per))
    while entries and entries[-1] == 0:
        entries = entries[:-1]
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree",
                       tree_levels=3, tree_near="pairs",
                       tree_max_chunks=int(total) + 8,
                       tree_pair_entries=entries)
    states = make_ensemble(base, 2, jax.random.key(0), pos_sigma=1e-4)
    finals, trajs = ensemble_rollout(states, cfg, 10, record_every=5)
    assert finals.pos.shape == (2, 64, 3)
    assert np.all(np.isfinite(energy_drift(trajs)))

    st0 = ot.init_forces(base, cfg)
    fin0, _ = ot.rollout_jit(st0, cfg, 10)
    np.testing.assert_allclose(np.asarray(finals.pos[0]),
                               np.asarray(fin0.pos),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_sharded_staged_rollout_matches_unsharded(rng):
    """rollout_staged(mesh=...): the multi-chip large-N tree path — every
    phase dispatch a shard_map program (replicated far conv, partitioned
    near sweeps + psum), kick/drift elementwise on local shards — must
    reproduce the host-driven unsharded staged rollout, overflow checks
    included."""
    from orbital_tpu.engine.rollout import init_forces_staged, rollout_staged
    from orbital_tpu.ops.tree import tree_pairs_budgets

    st = _plummer_state(rng, n=128)
    kch, entries = tree_pairs_budgets(st.pos, st.alive, levels=3)
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-3, force_impl="tree",
                       tree_levels=3, tree_near="pairs",
                       tree_max_chunks=kch, tree_pair_entries=entries,
                       collisions="none")

    st0 = init_forces_staged(st, cfg)
    fin_ref, traj_ref, ovf_ref = rollout_staged(st0, cfg, 8, record_every=4)

    mesh = make_mesh()
    st1 = init_forces_staged(st, cfg, mesh=mesh)
    fin_s, traj_s, ovf_s = rollout_staged(st1, cfg, 8, record_every=4,
                                          mesh=mesh)
    assert ovf_s == ovf_ref == 0
    np.testing.assert_allclose(np.asarray(fin_s.pos), np.asarray(fin_ref.pos),
                               rtol=0, atol=1e-6)
    assert float(fin_s.potential) == pytest.approx(
        float(fin_ref.potential), rel=1e-5)
    np.testing.assert_allclose(np.asarray(traj_s.pos),
                               np.asarray(traj_ref.pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(traj_s.energy),
                               np.asarray(traj_ref.energy), rtol=1e-5)


def test_simulate_mesh_matches_single_device(rng):
    """simulate(mesh=...): the one-call API's multi-chip route (compiled
    shard_map(scan(step)) rollout, ring forces) must reproduce the
    single-device rollout on the same scene."""
    n = 64
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n)

    from orbital_tpu.models.scene import SceneArrays

    scene = SceneArrays(pos=pos, vel=vel, mass=mass,
                        radius=np.full(n, 1e-3),
                        names=[f"b{i}" for i in range(n)])
    import dataclasses as _dc

    kw = dict(steps=20, dt=1e-3, softening=1e-2, record_every=10,
              precision="f64",
              unit_profile=_dc.replace(ot.STANDARD, G=1.0))
    ref = ot.simulate(scene, **kw)
    out = ot.simulate(scene, mesh=make_mesh(), **kw)
    np.testing.assert_allclose(out.pos, ref.pos, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out.energy, ref.energy, rtol=1e-10)
    np.testing.assert_allclose(out.ang_mom, ref.ang_mom, rtol=1e-9,
                               atol=1e-12)


def test_sharded_bounce_skip_parity(rng):
    """Contact-free steps must take the gated skip branch:
    the sharded bounce step is BIT-equal to the sharded collisions='none'
    step when nothing touches — the detection ring gates the impulse ring
    exactly like the single-chip fused-detect path cond-skips the
    resolution sweep (engine/integrators._apply_collisions)."""
    from orbital_tpu.parallel.sharded import make_sharded_step, shard_state

    n = 32
    # bodies on a wide lattice, tiny radii: no pair can ever touch
    pos = (np.stack(np.meshgrid(*[np.arange(4)] * 3), -1)
           .reshape(-1, 3)[:n] * 10.0)
    vel = rng.normal(size=(n, 3)) * 1e-3
    mass = np.ones(n) / n
    radius = np.full(n, 1e-3)
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="bounce",
                       restitution=0.5)
    st = ot.init_forces(st, cfg)

    mesh = make_mesh()
    step_b = make_sharded_step(cfg, mesh, st, axis="body")
    step_n = make_sharded_step(cfg.replace(collisions="none"), mesh, st,
                               axis="body")
    out_b = shard_state(mesh, st, "body")
    out_n = shard_state(mesh, st, "body")
    for _ in range(3):
        out_b = step_b(out_b)
        out_n = step_n(out_n)
    np.testing.assert_array_equal(np.asarray(out_b.pos),
                                  np.asarray(out_n.pos))
    np.testing.assert_array_equal(np.asarray(out_b.vel),
                                  np.asarray(out_n.vel))


def test_sharded_ensemble_merge(rng):
    """merge now composes with the vmapped (ensemble x body) mesh: the gather + global merge run unconditionally per
    step (vmap turns the contact gate into select anyway) and must match
    per-member unsharded merge stepping."""
    from orbital_tpu.parallel.ensemble import make_ensemble
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    n, E = 32, 4
    pos = rng.normal(size=(n, 3)) * 0.6
    vel = rng.normal(size=(n, 3)) * 0.2
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 0.12)  # dense enough that merges happen
    base = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="merge")
    states = make_ensemble(base, E, jax.random.key(3), pos_sigma=1e-3)
    force = resolve_force_fn(cfg.replace(force_impl="dense"), n)
    acc, U = jax.vmap(force)(states.pos, states.mass, states.alive)
    states = states.replace(acc=acc, potential=U)

    mesh = make_mesh(shape=(2, 4), axis_names=("ensemble", "body"))
    step, shardings = make_sharded_ensemble_step(cfg, mesh, states)
    out = jax.device_put(states, shardings)
    for _ in range(3):
        out = step(out)

    ref_step = make_step_fn(cfg, force)
    ref = states
    for _ in range(3):
        ref = jax.vmap(ref_step)(ref)
    np.testing.assert_array_equal(np.asarray(out.alive),
                                  np.asarray(ref.alive))
    # merges must actually have happened somewhere (not a vacuous test)
    assert int(np.sum(~np.asarray(out.alive))) > 0
    al = np.asarray(ref.alive)
    np.testing.assert_allclose(np.asarray(out.pos)[al],
                               np.asarray(ref.pos)[al],
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out.vel)[al],
                               np.asarray(ref.vel)[al],
                               rtol=3e-5, atol=3e-6)


def test_sharded_resolve_matches_unsharded(rng):
    """collisions='resolve' under body sharding: contact-gated all_gather + the UNCHANGED outcome model,
    replicated rolls (the step counter is replicated, so the PRNG fold
    is identical mesh-wide), sliced back per shard — must match the
    unsharded resolve step."""
    from orbital_tpu.engine.integrators import make_step_fn
    from orbital_tpu.engine.rollout import resolve_force_fn

    n = 64
    pos = rng.normal(size=(n, 3)) * 5.0
    vel = rng.normal(size=(n, 3)) * 0.01
    mass = rng.uniform(0.5, 1.5, n) / n
    radius = np.full(n, 1e-3)
    # cross-shard contact pairs (8 bodies/shard): one extreme mass ratio
    # (absorb branch), one comparable-mass pair (bounce/fragment roll)
    pos[9] = pos[0] + 5e-4
    mass[9] = mass[0] * 40.0
    pos[63] = pos[17] - 5e-4
    st = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-3, G=1e-4, eps2=1e-4, collisions="resolve",
                       frag_seed=7)
    st = ot.init_forces(st, cfg.replace(force_impl="dense"))

    ref_step = make_step_fn(cfg.replace(force_impl="dense"),
                            resolve_force_fn(cfg.replace(force_impl="dense"), n))
    ref = ref_step(st)
    assert not np.asarray(ref.alive).all()  # outcomes actually happened

    mesh = make_mesh()
    step = make_sharded_step(cfg, mesh, st)
    out = step(shard_state(mesh, st))
    np.testing.assert_array_equal(np.asarray(out.alive), np.asarray(ref.alive))
    np.testing.assert_allclose(np.asarray(out.mass), np.asarray(ref.mass),
                               rtol=2e-6)
    alive = np.asarray(ref.alive)
    np.testing.assert_allclose(np.asarray(out.pos)[alive],
                               np.asarray(ref.pos)[alive], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.vel)[alive],
                               np.asarray(ref.vel)[alive], rtol=2e-5, atol=1e-6)

    # second step exercises the contact-free skip path
    out2 = step(out)
    ref2 = ref_step(ref)
    np.testing.assert_array_equal(np.asarray(out2.alive),
                                  np.asarray(ref2.alive))


def test_sharded_ensemble_resolve(rng):
    """resolve composes with the vmapped (ensemble x body) mesh: the
    gather + outcome model run unconditionally per step and must match
    per-member unsharded resolve stepping."""
    from orbital_tpu.parallel.ensemble import make_ensemble
    from orbital_tpu.parallel.sharded import make_sharded_ensemble_step

    n, E = 32, 4
    pos = rng.normal(size=(n, 3)) * 0.6
    vel = rng.normal(size=(n, 3)) * 0.2
    mass = rng.uniform(0.5, 1.5, n) / n
    mass[0] *= 60.0  # guarantee an absorb-branch pair somewhere
    radius = np.full(n, 0.12)
    base = make_state(pos, vel, mass, radius, precision="f32")
    cfg = ot.SimConfig(dt=1e-2, G=1.0, eps2=1e-4, collisions="resolve",
                       frag_seed=11)
    states = make_ensemble(base, E, jax.random.key(3), pos_sigma=1e-3)
    force = resolve_force_fn(cfg.replace(force_impl="dense"), n)
    acc, U = jax.vmap(force)(states.pos, states.mass, states.alive)
    states = states.replace(acc=acc, potential=U)

    mesh = make_mesh(shape=(2, 4), axis_names=("ensemble", "body"))
    step, shardings = make_sharded_ensemble_step(cfg, mesh, states)
    out = jax.device_put(states, shardings)
    for _ in range(3):
        out = step(out)

    ref_step = make_step_fn(cfg, force)
    ref = states
    for _ in range(3):
        ref = jax.vmap(ref_step)(ref)
    np.testing.assert_array_equal(np.asarray(out.alive),
                                  np.asarray(ref.alive))
    assert int(np.sum(~np.asarray(out.alive))) > 0
    al = np.asarray(ref.alive)
    np.testing.assert_allclose(np.asarray(out.pos)[al],
                               np.asarray(ref.pos)[al],
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out.vel)[al],
                               np.asarray(ref.vel)[al],
                               rtol=3e-5, atol=3e-6)


def test_sharded_respa_rollout_matches_unsharded(rng):
    """Multi-chip multirate (RESPA) rollout: ring-sharded closing exact
    evaluation + chunk-sharded near sweeps inside shard_map must
    reproduce the single-device respa_rollout at f64.
    Only summation order differs (the ring accumulates the far force in
    shard blocks), so f64 trajectories agree to tight tolerances."""
    from orbital_tpu.engine.multirate import respa_rollout
    from orbital_tpu.engine.rollout import init_forces as _init
    from orbital_tpu.ops.neighbor import neighbor_budgets
    from orbital_tpu.parallel.sharded import make_sharded_respa_rollout
    from orbital_tpu.utils.config import SimConfig

    n = 128
    pos = rng.normal(size=(n, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    rc, cell = 0.3, 0.6
    m_grid, k_ch, w_blk = neighbor_budgets(pos, cell=cell, chunk=8, rj=16)
    cfg = SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="respa",
                    respa_k=4, respa_rc=rc, respa_cell=cell,
                    respa_m=m_grid, respa_max_chunks=k_ch,
                    respa_w_blk=w_blk, respa_chunk=8, respa_rj=16,
                    respa_refresh=2)
    st = _init(make_state(pos, vel, mass, precision="f64"), cfg)

    ref_final, ref_traj, ref_diag = respa_rollout(st, cfg, 32,
                                                  record_every=16)
    assert int(ref_diag["overflow"]) == 0

    mesh = make_mesh()
    roll = make_sharded_respa_rollout(cfg, mesh, st, steps=32,
                                      record_every=16, axis="body")
    out, traj, diag = roll(shard_state(mesh, st))

    assert int(diag["overflow"]) == 0
    assert int(diag["skin_violation"]) == int(ref_diag["skin_violation"])
    assert traj.pos.shape == (2, n, 3)
    scale = float(np.max(np.abs(np.asarray(ref_final.pos))))
    np.testing.assert_allclose(np.asarray(out.pos),
                               np.asarray(ref_final.pos),
                               atol=1e-11 * scale)
    np.testing.assert_allclose(np.asarray(out.vel),
                               np.asarray(ref_final.vel), atol=1e-11)
    np.testing.assert_allclose(np.asarray(traj.pos),
                               np.asarray(ref_traj.pos),
                               atol=1e-11 * scale)
    np.testing.assert_allclose(np.asarray(traj.energy),
                               np.asarray(ref_traj.energy), rtol=1e-12)
    assert int(out.step) == 32
    assert float(out.time) == pytest.approx(float(ref_final.time))


def test_simulate_mesh_respa_matches_single_device(rng):
    """simulate(integrator='respa', mesh=...): the one-call API's
    multi-chip multirate route (the gate deleted in round 4) reproduces
    the single-device respa run on the same scene."""
    n = 64
    pos = rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3)) * 0.1
    mass = rng.uniform(0.5, 1.5, n)

    from orbital_tpu.models.scene import SceneArrays

    scene = SceneArrays(pos=pos, vel=vel, mass=mass,
                        radius=np.full(n, 1e-3),
                        names=[f"b{i}" for i in range(n)])
    import dataclasses as _dc

    kw = dict(steps=24, dt=1e-3, softening=1e-2, record_every=12,
              precision="f64", integrator="respa", respa_k=4,
              unit_profile=_dc.replace(ot.STANDARD, G=1.0))
    ref = ot.simulate(scene, **kw)
    out = ot.simulate(scene, mesh=make_mesh(), **kw)
    np.testing.assert_allclose(out.pos, ref.pos, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(out.energy, ref.energy, rtol=1e-9)


@pytest.mark.slow
def test_multiprocess_sharded_step():
    """The DCN path across REAL process boundaries: two
    jax.distributed processes x 4 virtual CPU devices form one 8-device
    body mesh, so the sharded step's ppermute ring and psums cross the
    inter-process transport. Each worker checks its addressable shards
    bit-for-bit against a process-local unsharded step (dcn_worker.py)."""
    import os
    import socket
    import subprocess
    import sys as _sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = str(Path(__file__).resolve().parent / "dcn_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([_sys.executable, worker, str(port), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert "PARITY_OK" in out, f"worker {i} no parity:\n{out[-2000:]}"
    # both processes computed the same global system (same checksum line)
    lines = [next(ln for ln in o.splitlines() if "PARITY_OK" in ln)
             for o in outs]
    assert lines[0] == lines[1]
