"""Multilevel tree gravity (ops/tree.py) vs the exact dense oracle."""
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.ops.forces import pairwise_acc_dense
from orbital_tpu.ops.tree import (tree_acc_potential, tree_occupancy_probe,
                                  tree_stencil)


def _rms(a, ar):
    a, ar = np.asarray(a), np.asarray(ar)
    return (np.sqrt(np.mean(np.sum((a - ar) ** 2, -1)))
            / np.sqrt(np.mean(np.sum(ar ** 2, -1))))


@pytest.fixture
def gauss_blob(rng):
    """Centrally concentrated cluster (the tree's target regime)."""
    n = 2048
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    return pos, mass


def test_stencil_counts():
    """The claim stencils have the analytic sizes (2ws+1 cube minus the
    near-field cube)."""
    assert len(tree_stencil(1)) == 7 ** 3 - 3 ** 3
    assert len(tree_stencil(2)) == 11 ** 3 - 5 ** 3


def _window_center_bodies(rng, n_bodies, levels, half=8.0):
    """Bodies at EXACT finest-cell centers inside one random 4^3
    finest-cell window of a pinned box. Within a 4-cell window every pair
    has parent separation <= 1, so every far claim lands at the FINEST
    level — where center-anchored expansions of center-placed bodies are
    exact (dipole = 0). The tree must then match the dense oracle to f32
    rounding: a double-counted or missed claim shows up as an O(1) error."""
    M = 2 ** levels
    h = 2.0 * half / M
    # window-aligned so parent (level-1) cells span at most 2 = 1 parent sep
    base = (rng.integers(0, M // 4, 3) * 4).astype(np.int64)
    cells = rng.choice(64, size=n_bodies, replace=False)
    local = np.stack([cells // 16, (cells // 4) % 4, cells % 4], axis=1)
    cc = base[None, :] + local
    pos = (-half + (cc.astype(np.float64) + 0.5) * h).astype(np.float32)
    box = (np.zeros(3, np.float32), np.float32(half))
    return pos, box


@pytest.mark.slow
def test_pair_partition_exact(rng):
    """Finest-level claims + near field reproduce the dense oracle to f32
    rounding for center-placed bodies (see _window_center_bodies)."""
    for _ in range(30):
        pos, box = _window_center_bodies(rng, 12, levels=4)
        mass = rng.uniform(0.5, 1.5, 12).astype(np.float32)
        a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
        a, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                      levels=4, capacity=12, ws=1, box=box)
        assert int(ov) == 0
        assert _rms(a, a_ref) < 5e-6


@pytest.mark.slow
def test_pair_partition_exact_deep_levels(rng):
    """Same finest-level exactness when the finest level sits at the end
    of the deep conv chain (levels=7): per-level convs, the static-delta
    push-down, and the per-body channel gathers preserve the partition."""
    for _ in range(6):
        pos, box = _window_center_bodies(rng, 16, levels=7)
        mass = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
        a, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                      levels=7, capacity=16, ws=1, box=box)
        assert int(ov) == 0
        assert _rms(a, a_ref) < 5e-6


@pytest.mark.slow
def test_pair_partition_counts_every_pair_once(rng):
    """Potential flood: with eps2 far above the box scale every pair's
    potential is -G m_i m_j / sqrt(eps2) to ~4e-6 regardless of distance,
    so U literally counts claimed pairs (mass-product weighted) across
    ALL levels and the near field. A single missed or double-counted pair
    among n=24 bodies shifts U by ~1/276 — two orders above the
    tolerance. Random positions exercise every level's claim set."""
    eps2 = 1e8
    for levels in (3, 4, 7):
        n = 24
        pos = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
        mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
        mm = np.outer(mass, mass)
        S = (mm.sum() - np.trace(mm)) / 2.0
        U_expect = -S / np.sqrt(eps2)
        occ, _ = tree_occupancy_probe(pos, levels=levels)
        _, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=eps2,
                                      levels=levels, capacity=int(occ) + 4)
        assert int(ov) == 0
        assert abs(float(U) - U_expect) / abs(U_expect) < 1e-3


@pytest.mark.slow
def test_tree_deep_levels_match_shallow(gauss_blob):
    """levels=7 stays in the same accuracy class as levels=5 on the blob.
    Center-anchored expansions lose a little at depth (a 2048-body blob
    has ~1 body/cell at level 7, and a lone body sits up to h/2 from its
    cell center; the COM-anchored scheme this replaced was exact there but
    was gather-bound — 10-20x slower, see the module docstring), so the
    deep bound is 2x the shallow one, not equal."""
    pos, mass = gauss_blob
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    occ, nc = tree_occupancy_probe(pos, levels=7)
    a, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=7, capacity=int(occ) + 8, ws=1,
                                  max_cells=int(nc) + 32)
    assert int(ov) == 0
    assert _rms(a, a_ref) < 6e-2
    assert float(U) == pytest.approx(float(U_ref), rel=6e-2)


@pytest.mark.parametrize("ws,tol", [(1, 3e-2), (2, 8e-3)])
@pytest.mark.slow
def test_tree_accuracy(gauss_blob, ws, tol):
    pos, mass = gauss_blob
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    occ, nc = tree_occupancy_probe(pos, levels=5)
    a, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=5, capacity=int(occ) + 8, ws=ws,
                                  max_cells=int(nc) + 32)
    assert int(ov) == 0
    assert _rms(a, a_ref) < tol
    assert float(U) == pytest.approx(float(U_ref), rel=tol)


@pytest.mark.slow
def test_tree_momentum_conserved(gauss_blob):
    """COM-COM monopole pairs are antisymmetric and the Taylor corrections
    are mass-weighted about each COM, so total force is zero to rounding
    (the same Newton's-third-law property the reference asserts for its
    exact pairs, core/physics.py:302-305)."""
    pos, mass = gauss_blob
    occ, nc = tree_occupancy_probe(pos, levels=5)
    a, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=5, capacity=int(occ) + 8, ws=1,
                                  max_cells=int(nc) + 32)
    assert int(ov) == 0
    f_tot = np.abs((np.asarray(mass)[:, None] * np.asarray(a)).sum(0)).max()
    f_rms = np.sqrt(np.mean(np.sum(np.asarray(mass)[:, None]
                                   * np.asarray(a) ** 2, -1)))
    assert f_tot < 1e-5 * max(f_rms, 1e-30)


@pytest.mark.slow
def test_tree_capacity_overflow_counted(gauss_blob):
    pos, mass = gauss_blob
    _, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=4, capacity=2, ws=1)
    assert int(ov) > 0


@pytest.mark.slow
def test_tree_max_cells_overflow_counted(gauss_blob):
    pos, mass = gauss_blob
    occ, nc = tree_occupancy_probe(pos, levels=5)
    assert int(nc) > 8
    _, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=5, capacity=int(occ) + 8, ws=1,
                                  max_cells=8)
    assert int(ov) > 0


@pytest.mark.slow
def test_tree_dead_bodies_inert(gauss_blob):
    from orbital_tpu.engine.state import far_positions

    pos, mass = gauss_blob
    n = len(mass)
    alive = np.ones(n, bool)
    alive[1500:] = False
    pos2 = pos.copy()
    pos2[~alive] = far_positions(int((~alive).sum()), 3.0, np.float32)
    occ, nc = tree_occupancy_probe(pos[alive], levels=5)
    a_live, _, ov1 = tree_acc_potential(pos[alive], mass[alive],
                                        G_grav=1.0, eps2=1e-6, levels=5,
                                        capacity=int(occ) + 8, ws=1)
    a_mask, _, ov2 = tree_acc_potential(pos2, mass, alive, G_grav=1.0,
                                        eps2=1e-6, levels=5,
                                        capacity=int(occ) + 8, ws=1)
    assert int(ov1) == 0 and int(ov2) == 0
    a_mask = np.asarray(a_mask)
    np.testing.assert_array_equal(a_mask[~alive], 0.0)
    # the alive-subset run fits a tighter bounding cube (different grid),
    # so agreement is at the method's accuracy, not bitwise
    assert _rms(a_mask[alive], a_live) < 2e-2


@pytest.mark.slow
def test_tree_in_rollout(gauss_blob):
    """force_impl='tree' drives the KDK stepper with bounded energy noise."""
    from orbital_tpu.engine.state import make_state

    pos, mass = gauss_blob
    n = len(mass)
    vel = np.zeros((n, 3))
    st = make_state(pos, vel, mass, precision="f32")
    occ, nc = tree_occupancy_probe(st.pos, st.alive, levels=4)
    cfg = ot.SimConfig(dt=2e-3, G=1.0, eps2=1e-4, force_impl="tree",
                       tree_levels=4, tree_capacity=int(occ) + 16,
                       tree_max_cells=int(nc) + 32)
    st = ot.init_forces(st, cfg)
    fin, traj = ot.rollout_jit(st, cfg, 40, record_every=10)
    assert np.isfinite(np.asarray(fin.pos)).all()
    E = np.asarray(traj.energy, np.float64)
    assert abs((E[-1] - E[0]) / E[0]) < 3e-2


def test_tree_requires_softening(gauss_blob):
    pos, mass = gauss_blob
    with pytest.raises(ValueError, match="eps2"):
        tree_acc_potential(pos, mass, G_grav=1.0, eps2=0.0)


def test_tree_rejects_hermite(gauss_blob):
    from orbital_tpu.engine.rollout import resolve_accel_jerk_fn

    cfg = ot.SimConfig(dt=1.0, integrator="hermite", force_impl="tree",
                       eps2=1e-6)
    with pytest.raises(ValueError, match="hermite"):
        resolve_accel_jerk_fn(cfg, 64)


@pytest.mark.slow
def test_simulate_tree_auto_capacity(gauss_blob):
    """simulate(force_impl='tree') sizes capacity and the occupied-cell
    budget from the actual distribution and completes with finite output."""
    from orbital_tpu.models.scene import SceneArrays

    pos, mass = gauss_blob
    n = len(mass)
    arrays = SceneArrays(
        pos=np.asarray(pos, np.float64),
        vel=np.zeros((n, 3)),
        mass=np.asarray(mass, np.float64),
        radius=np.zeros(n),
        names=[f"b{i}" for i in range(n)],
        uuids=[f"u{i}" for i in range(n)],
    )
    res = ot.simulate(arrays, steps=10, dt=1e-3, softening=1e-2,
                      force_impl="tree", tree_levels=4, precision="f32",
                      rescale=None, record_every=5)
    assert np.isfinite(res.pos).all()
    assert res.config.tree_capacity >= 16
    assert res.config.tree_max_cells > 0


@pytest.mark.slow
def test_simulate_tree_accuracy_knob(gauss_blob):
    """tree_accuracy= maps ONE force-error target to the coupled
    (order, ws) budgets: a loose target takes the cheapest rung, an
    unreachable one raises with the measured ladder errors."""
    from orbital_tpu.models.scene import SceneArrays

    pos, mass = gauss_blob
    n = len(mass)
    arrays = SceneArrays(
        pos=np.asarray(pos, np.float64),
        vel=np.zeros((n, 3)),
        mass=np.asarray(mass, np.float64),
        radius=np.zeros(n),
        names=[f"b{i}" for i in range(n)],
        uuids=[f"u{i}" for i in range(n)],
    )
    res = ot.simulate(arrays, steps=4, dt=1e-3, softening=1e-2,
                      force_impl="tree", tree_levels=4, precision="f32",
                      rescale=None, record_every=2, tree_accuracy=0.08)
    assert (res.config.tree_order, res.config.tree_ws) == (1, 1)
    assert np.isfinite(res.pos).all()
    with pytest.raises(ValueError, match="measured relative RMS"):
        ot.simulate(arrays, steps=2, dt=1e-3, softening=1e-2,
                    force_impl="tree", tree_levels=4, precision="f32",
                    rescale=None, tree_accuracy=1e-9)


@pytest.mark.slow
def test_tree_pinned_box_matches(gauss_blob):
    """A pinned box covering the live extent agrees with the refit path."""
    pos, mass = gauss_blob
    occ, nc = tree_occupancy_probe(pos, levels=5)
    a_fit, _, _ = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                     levels=5, capacity=int(occ) + 8, ws=1)
    half = float(np.abs(pos).max()) * 1.1
    occ2, _ = tree_occupancy_probe(pos, levels=5,
                                   box=(np.zeros(3, np.float32), half))
    a_pin, _, ov = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-6, levels=5,
        capacity=int(occ2) + 8, ws=1,
        box=(np.zeros(3, np.float32), half))
    assert int(ov) == 0
    # both grids sit in the same accuracy class vs the exact oracle
    # (cell-assignment noise differs between alignments, so pin-vs-fit
    # is not rounding-close — compare each to the truth instead)
    a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    assert _rms(a_pin, a_ref) < 1.5 * max(_rms(a_fit, a_ref), 1e-2)


@pytest.mark.slow
def test_tree_order2_improves_accuracy(gauss_blob):
    """order=2 (quadrupole sources + second-order target Taylor) cuts the
    force error by ~the well-separation ratio (~3x at ws=1) and the
    potential error ~10x, with momentum still conserved to rounding."""
    pos, mass = gauss_blob
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    occ, nc = tree_occupancy_probe(pos, levels=5)
    errs, uerrs = {}, {}
    for order in (1, 2):
        a, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                      levels=5, capacity=int(occ) + 8,
                                      max_cells=int(nc) + 32, order=order)
        assert int(ov) == 0
        errs[order] = _rms(a, a_ref)
        uerrs[order] = abs(float(U) - float(U_ref)) / abs(float(U_ref))
        mom = np.abs((np.asarray(mass)[:, None] * np.asarray(a)).sum(0))
        assert mom.max() < 1e-6
    assert errs[2] < errs[1] / 2.0
    assert uerrs[2] < uerrs[1] / 3.0


@pytest.mark.slow
def test_tree_order2_partition_and_exactness(rng):
    """The order-2 tap set claims exactly the same pairs (eps2-flood
    count) and center-placed window bodies stay exact (all higher moments
    vanish at centers)."""
    eps2 = 1e8
    n = 24
    pos = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mm = np.outer(mass, mass)
    S = (mm.sum() - np.trace(mm)) / 2.0
    occ, _ = tree_occupancy_probe(pos, levels=4)
    _, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=eps2,
                                  levels=4, capacity=int(occ) + 4, order=2)
    assert int(ov) == 0
    assert abs(float(U) + S / np.sqrt(eps2)) / (S / np.sqrt(eps2)) < 1e-3

    pos, box = _window_center_bodies(rng, 12, levels=4)
    mass = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    a, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=4, capacity=12, ws=1, box=box,
                                  order=2)
    assert int(ov) == 0
    assert _rms(a, a_ref) < 5e-6


@pytest.mark.slow
def test_simulate_tree_order2(gauss_blob):
    from orbital_tpu.models.scene import SceneArrays

    pos, mass = gauss_blob
    n = len(mass)
    arrays = SceneArrays(
        pos=np.asarray(pos, np.float64), vel=np.zeros((n, 3)),
        mass=np.asarray(mass, np.float64), radius=np.zeros(n),
        names=[f"b{i}" for i in range(n)], uuids=[f"u{i}" for i in range(n)])
    res = ot.simulate(arrays, steps=10, dt=1e-3, softening=1e-2,
                      force_impl="tree", tree_levels=4, tree_order=2,
                      precision="f32", rescale=None, record_every=5)
    assert np.isfinite(res.pos).all()
    assert res.config.tree_order == 2


@pytest.mark.slow
def test_simulate_tree_auto_levels(gauss_blob):
    """tree_levels='auto' picks the smallest pyramid whose densest cell
    is near-field-cheap (<= 64 bodies)."""
    from orbital_tpu.models.scene import SceneArrays

    pos, mass = gauss_blob
    n = len(mass)
    arrays = SceneArrays(
        pos=np.asarray(pos, np.float64), vel=np.zeros((n, 3)),
        mass=np.asarray(mass, np.float64), radius=np.zeros(n),
        names=[f"b{i}" for i in range(n)], uuids=[f"u{i}" for i in range(n)])
    res = ot.simulate(arrays, steps=4, dt=1e-3, softening=1e-2,
                      force_impl="tree", tree_levels="auto",
                      precision="f32", rescale=None, record_every=2)
    assert np.isfinite(res.pos).all()
    assert 5 <= res.config.tree_levels <= 8
    # the chosen depth really is near-field-cheap for this blob
    from orbital_tpu.ops.tree import tree_occupancy_probe
    occ, _ = tree_occupancy_probe(np.asarray(pos, np.float32),
                                  levels=res.config.tree_levels)
    assert int(occ) <= 64 or res.config.tree_levels == 8


@pytest.mark.slow
def test_tree_staged_matches_single_call(gauss_blob):
    """The two-phase evaluation (the N>=512k compile-helper workaround)
    is numerically identical to the single program."""
    from orbital_tpu.ops.tree import tree_acc_potential_staged

    pos, mass = gauss_blob
    occ, nc = tree_occupancy_probe(pos, levels=5)
    kw = dict(G_grav=1.0, eps2=1e-6, levels=5, capacity=int(occ) + 8,
              max_cells=int(nc) + 32)
    a1, U1, ov1 = tree_acc_potential(pos, mass, **kw)
    a2, U2, ov2 = tree_acc_potential_staged(pos, mass, **kw)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1),
                               rtol=1e-6, atol=1e-7)
    assert float(U2) == pytest.approx(float(U1), rel=1e-6)
    assert int(ov2) == int(ov1)


@pytest.mark.slow
def test_tree_class_probe_sizes_budgets(gauss_blob):
    """tree_class_probe counts the same occupancy classes the near-field
    split uses; explicit probe-sized max_big/max_frontier budgets leave
    results bit-identical with zero overflow, and starved budgets COUNT
    the dropped cells instead of silently losing pairs."""
    import jax.numpy as jnp
    from orbital_tpu.ops.tree import tree_class_probe

    pos, mass = gauss_blob
    kw = dict(G_grav=1.0, eps2=1e-3, levels=4, capacity=64, ws=1)
    occ, ncells, nbig, nfront = tree_class_probe(
        jnp.asarray(pos), levels=4, ws=1)
    assert int(occ) > 16 > 0          # concentrated: the split is active
    assert int(nbig) >= 1
    assert int(ncells) >= int(nbig) + int(nfront)

    a_ref, U_ref, ov_ref = tree_acc_potential(pos, mass, **kw)
    assert int(ov_ref) == 0

    a, U, ov = tree_acc_potential(pos, mass, **kw,
                                  max_big=int(nbig), max_frontier=int(nfront))
    assert int(ov) == 0
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a_ref))
    assert float(U) == float(U_ref)

    # starving the big list must be *counted*, never silent
    if int(nbig) > 1:
        _, _, ov_st = tree_acc_potential(pos, mass, **kw, max_big=1,
                                         max_frontier=int(nfront))
        assert int(ov_st) > 0


# ---------------------------------------------------------------------------
# column near field (near="columns")
# ---------------------------------------------------------------------------

def test_tree_columns_pair_partition_exact(rng):
    """The column sweep + its |dz| <= ws band mask must reproduce the
    dense oracle to f32 rounding for center-placed bodies — a missed,
    double-counted, or band-mask-misclassified pair shows as O(1)."""
    for _ in range(20):
        pos, box = _window_center_bodies(rng, 12, levels=4)
        mass = rng.uniform(0.5, 1.5, 12).astype(np.float32)
        a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
        a, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                      levels=4, capacity=16, ws=1,
                                      near="columns", box=box)
        assert int(ov) == 0
        np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ws", [1, 2])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.slow
def test_tree_columns_match_cells(gauss_blob, ws, order):
    """near="columns" computes the SAME near field as near="cells" (only
    the accumulation order differs): accelerations and potential agree to
    f32 summation rounding on the concentrated blob."""
    from orbital_tpu.ops.tree import tree_column_probe

    pos, mass = gauss_blob
    occ, nc = tree_occupancy_probe(pos, levels=5)
    a_c, U_c, ov_c = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-6, levels=5, ws=ws, order=order,
        capacity=int(occ) + 8, max_cells=int(nc) + 32, near="cells")
    cocc, cnc, _, _ = tree_column_probe(pos, levels=5, ws=ws)
    a_k, U_k, ov_k = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-6, levels=5, ws=ws, order=order,
        capacity=int(cocc) + 8, max_cells=int(cnc) + 32, near="columns")
    assert int(ov_c) == 0 and int(ov_k) == 0
    scale = np.sqrt(np.mean(np.sum(np.asarray(a_c) ** 2, -1)))
    np.testing.assert_allclose(np.asarray(a_k), np.asarray(a_c),
                               atol=1e-4 * scale)
    assert float(U_k) == pytest.approx(float(U_c), rel=1e-5)


def test_tree_column_probe_counts(rng):
    """Column census matches a direct histogram of (x, y) bins."""
    from orbital_tpu.ops.tree import tree_column_probe

    n, levels, half = 512, 4, 8.0
    M = 2 ** levels
    pos = rng.uniform(-half * 0.9, half * 0.9, (n, 3)).astype(np.float32)
    box = (np.zeros(3, np.float32), np.float32(half))
    cc = np.clip(np.floor((pos + half) / (2 * half / M)), 0,
                 M - 1).astype(int)
    counts = np.zeros((M, M), int)
    np.add.at(counts, (cc[:, 0], cc[:, 1]), 1)
    cap, ncols, nbig, nfront = tree_column_probe(pos, levels=levels,
                                                 box=box, c_small=4)
    assert int(cap) == counts.max()
    assert int(ncols) == (counts > 0).sum()
    assert int(nbig) == (counts > 4).sum()


@pytest.mark.slow
def test_tree_columns_capacity_overflow_counted(gauss_blob):
    pos, mass = gauss_blob
    _, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=4, capacity=2, ws=1,
                                  near="columns")
    assert int(ov) > 0


@pytest.mark.slow
def test_tree_columns_max_cells_overflow_counted(gauss_blob):
    from orbital_tpu.ops.tree import tree_column_probe

    pos, mass = gauss_blob
    cocc, cnc, _, _ = tree_column_probe(pos, levels=5)
    assert int(cnc) > 8
    _, _, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=5, capacity=int(cocc) + 8, ws=1,
                                  max_cells=8, near="columns")
    assert int(ov) > 0


@pytest.mark.slow
def test_tree_columns_dead_bodies_inert(gauss_blob):
    from orbital_tpu.engine.state import far_positions
    from orbital_tpu.ops.tree import tree_column_probe

    pos, mass = gauss_blob
    n = len(mass)
    alive = np.ones(n, bool)
    alive[1500:] = False
    pos2 = pos.copy()
    pos2[~alive] = far_positions(int((~alive).sum()), 3.0, np.float32)
    cocc, _, _, _ = tree_column_probe(pos[alive], levels=5)
    a_live, _, ov1 = tree_acc_potential(pos[alive], mass[alive],
                                        G_grav=1.0, eps2=1e-6, levels=5,
                                        capacity=int(cocc) + 8, ws=1,
                                        near="columns")
    a_mask, _, ov2 = tree_acc_potential(pos2, mass, alive, G_grav=1.0,
                                        eps2=1e-6, levels=5,
                                        capacity=int(cocc) + 8, ws=1,
                                        near="columns")
    assert int(ov1) == 0 and int(ov2) == 0
    a_mask = np.asarray(a_mask)
    np.testing.assert_array_equal(a_mask[~alive], 0.0)
    assert _rms(a_mask[alive], a_live) < 2e-2


@pytest.mark.slow
def test_simulate_tree_columns(gauss_blob):
    """simulate(tree_near='columns') probe-sizes per-COLUMN budgets and
    stays in the cell path's accuracy class over a short rollout."""
    pos, mass = gauss_blob
    objs = [ot.Object(mass=float(m) * 1e4, radius=1e-3,
                      velocity=np.zeros(3),
                      coordinates=ot.Coordinates(*p.tolist()))
            for m, p in zip(mass[:256], pos[:256])]
    r_cells = ot.simulate(objs, steps=10, dt=1e-4, softening=1e-2,
                          force_impl="tree", tree_levels=4,
                          precision="f32")
    r_cols = ot.simulate(objs, steps=10, dt=1e-4, softening=1e-2,
                         force_impl="tree", tree_levels=4,
                         tree_near="columns", precision="f32")
    assert r_cols.config.tree_near == "columns"
    scale = np.sqrt(np.mean(np.sum(r_cells.pos[-1] ** 2, -1)))
    np.testing.assert_allclose(r_cols.pos[-1], r_cells.pos[-1],
                               atol=1e-4 * scale)


def test_tree_column_probe_chunk_count(rng):
    """with_chunks appends sum(ceil(count/c_small)) over big columns."""
    from orbital_tpu.ops.tree import tree_column_probe

    n, levels, half = 512, 4, 8.0
    M = 2 ** levels
    pos = rng.uniform(-half * 0.9, half * 0.9, (n, 3)).astype(np.float32)
    box = (np.zeros(3, np.float32), np.float32(half))
    cc = np.clip(np.floor((pos + half) / (2 * half / M)), 0,
                 M - 1).astype(int)
    counts = np.zeros((M, M), int)
    np.add.at(counts, (cc[:, 0], cc[:, 1]), 1)
    out = tree_column_probe(pos, levels=levels, box=box, c_small=4,
                            with_chunks=True)
    assert len(out) == 5
    big = counts[counts > 4]
    assert int(out[4]) == int(np.ceil(big / 4).sum())


@pytest.mark.slow
def test_tree_columns_chunked_big_sweep_parity(gauss_blob):
    """The chunked big sweep (i-side 32-row chunks of big columns)
    reproduces the dense oracle, a starved chunk budget overflows loudly,
    and a generous budget changes nothing."""
    from orbital_tpu.ops.tree import tree_column_probe

    pos, mass = gauss_blob
    a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    cap, ncol, nbig, nfront, nch = [
        int(x) for x in tree_column_probe(pos, levels=4, ws=1,
                                          with_chunks=True)]
    assert nbig > 0 and nch > nbig  # the blob must exercise the split
    kw = dict(G_grav=1.0, eps2=1e-6, levels=4, ws=1,
              capacity=int(np.ceil((cap + 8) / 16) * 16),
              max_cells=ncol + 32, max_big=nbig + 8,
              max_frontier=nfront + 8, near="columns")
    a, _, ov = tree_acc_potential(pos, mass, max_chunks=nch + 8, **kw)
    assert int(ov) == 0
    # levels=4 is the shallowest pyramid where the blob has big COLUMNS;
    # the monopole method error there is ~2.5e-2
    assert _rms(a, a_ref) < 3e-2
    # generous budget: identical result (pure padding)
    a2, _, ov2 = tree_acc_potential(pos, mass, max_chunks=2 * nch, **kw)
    assert int(ov2) == 0
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    # starved budget: dropped chunks are counted, not silent
    _, _, ov3 = tree_acc_potential(pos, mass, max_chunks=max(1, nch // 3),
                                   **kw)
    assert int(ov3) > 0


def test_segment_bounds_matches_searchsorted(rng):
    """The associative-scan segment bounds reproduce
    searchsorted(keys, keys, 'left'/'right') on sorted keys with
    duplicates, a constant run, and singletons."""
    import jax.numpy as jnp

    from orbital_tpu.ops.tree import _segment_bounds

    for keys in (
        np.sort(rng.integers(0, 40, 256)).astype(np.int32),
        np.zeros(64, np.int32),
        np.arange(17, dtype=np.int32),
        np.array([3], np.int32),
    ):
        first, last = _segment_bounds(jnp.asarray(keys))
        np.testing.assert_array_equal(
            np.asarray(first), np.searchsorted(keys, keys, side="left"))
        np.testing.assert_array_equal(
            np.asarray(last), np.searchsorted(keys, keys, side="right"))

@pytest.mark.slow
def test_far_field_layout_parity(rng):
    """The NHWC far-field path (channels-last conv + transpose-free
    pack/unpack) matches the NCHW path to f32 contraction rounding, both
    orders. The jit cache is keyed on static args only, so the layout
    flag requires an explicit clear_cache between traces — without it
    the second call silently reuses the first program (verified)."""
    import orbital_tpu.ops.tree as T

    pos = rng.normal(0, 0.3, (256, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    saved = T._FAR_NHWC
    try:
        for order in (1, 2):
            outs = {}
            for nhwc in (False, True):
                T._FAR_NHWC = nhwc
                T.tree_acc_potential.clear_cache()
                a, pe, ov = tree_acc_potential(
                    pos, mass, G_grav=1.0, eps2=1e-4, levels=4, ws=1,
                    capacity=128, max_cells=256, order=order,
                    with_potential=True)
                assert int(ov) == 0
                outs[nhwc] = (np.asarray(a), np.asarray(pe))
            scale = np.sqrt(np.mean(np.sum(outs[False][0] ** 2, -1)))
            np.testing.assert_allclose(outs[True][0], outs[False][0],
                                       atol=2e-6 * scale)
            assert float(outs[True][1]) == pytest.approx(
                float(outs[False][1]), rel=1e-6)
    finally:
        T._FAR_NHWC = saved
        T.tree_acc_potential.clear_cache()


@pytest.mark.slow
def test_far_field_combine_parity(rng):
    """The 'push' level combination (level-by-level pushdown with FULL
    Taylor terms per hop) matches the 'lazy' one (per-level shift
    straight to the finest grid) to f32 rounding on forces, both orders.
    The chained re-expansion only compounds terms BEYOND the kept order,
    so with the full shift the paths differ at rounding, not truncation
    (measured 7e-8 RMS on a 2048-body blob). Module flags are not jit
    cache keys — clear_cache between flips."""
    import orbital_tpu.ops.tree as T

    pos = rng.normal(0, 0.3, (256, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    saved = T._FAR_COMBINE
    try:
        for order in (1, 2):
            outs = {}
            for mode in ("push", "lazy"):
                T._FAR_COMBINE = mode
                T.tree_acc_potential.clear_cache()
                a, pe, ov = tree_acc_potential(
                    pos, mass, G_grav=1.0, eps2=1e-4, levels=4, ws=1,
                    capacity=128, max_cells=256, order=order,
                    with_potential=True)
                assert int(ov) == 0
                outs[mode] = (np.asarray(a), np.asarray(pe))
            scale = np.sqrt(np.mean(np.sum(outs["lazy"][0] ** 2, -1)))
            np.testing.assert_allclose(outs["push"][0], outs["lazy"][0],
                                       atol=2e-6 * scale)
            # potential keeps a small compounding term (hop-chained
            # re-expansion); same accuracy class, not bit-equal
            assert float(outs["push"][1]) == pytest.approx(
                float(outs["lazy"][1]), rel=1e-3)
    finally:
        T._FAR_COMBINE = saved
        T.tree_acc_potential.clear_cache()


def _pairs_budgets(pos, levels, ws=1, chunk=32, alive=None, margin=4):
    import jax.numpy as jnp

    from orbital_tpu.ops.tree import tree_pairs_probe

    total, per = tree_pairs_probe(
        jnp.asarray(pos), None if alive is None else jnp.asarray(alive),
        levels=levels, ws=ws, chunk=chunk)
    e = tuple(int(v) + margin if v else 0 for v in np.asarray(per))
    while e and e[-1] == 0:
        e = e[:-1]
    return int(total) + margin, e


@pytest.mark.parametrize(
    "ws,chunk",
    [(1, 32),
     pytest.param(1, 64, marks=pytest.mark.slow),
     pytest.param(2, 32, marks=pytest.mark.slow)])
def test_tree_pairs_match_cells(rng, ws, chunk):
    """near="pairs" (chunk-pair sweep, octave-padded j widths) computes
    the SAME near field as near="cells": accelerations and potential
    agree to f32 summation rounding on a concentrated blob."""
    n, levels = 1024, 4
    pos = (rng.normal(0, 1, (n, 3))
           * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    occ, nc = tree_occupancy_probe(pos, levels=levels)
    a_c, U_c, ov_c = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-4, levels=levels, ws=ws,
        capacity=int(occ) + 8, max_cells=int(nc) + 32, near="cells")
    total, entries = _pairs_budgets(pos, levels, ws=ws, chunk=chunk)
    a_p, U_p, ov_p = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-4, levels=levels, ws=ws,
        max_chunks=total, chunk=chunk, pair_entries=entries, near="pairs")
    assert int(ov_c) == 0 and int(ov_p) == 0
    scale = np.sqrt(np.mean(np.sum(np.asarray(a_c) ** 2, -1)))
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_c),
                               atol=2e-6 * scale)
    assert float(U_p) == pytest.approx(float(U_c), rel=1e-6)


@pytest.mark.slow
def test_tree_pairs_overflow_counted(rng):
    """Starved chunk-table, starved octave, and missing-octave budgets
    each count the excluded bodies instead of silently dropping them."""
    n, levels = 1024, 4
    pos = (rng.normal(0, 1, (n, 3))
           * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    total, entries = _pairs_budgets(pos, levels)
    kw = dict(G_grav=1.0, eps2=1e-4, levels=levels, ws=1, near="pairs")
    _, _, ov = tree_acc_potential(pos, mass, max_chunks=max(1, total // 2),
                                  pair_entries=entries, **kw)
    assert int(ov) > 0
    starved = tuple(max(1, v // 3) if v else 0 for v in entries)
    _, _, ov2 = tree_acc_potential(pos, mass, max_chunks=total,
                                   pair_entries=starved, **kw)
    assert int(ov2) > 0
    _, _, ov3 = tree_acc_potential(pos, mass, max_chunks=total,
                                   pair_entries=entries[:1], **kw)
    assert int(ov3) > 0


@pytest.mark.slow
def test_tree_pairs_dead_bodies_inert(rng):
    """Masked bodies exert no force, feel no force, and the masked run is
    bit-identical to running on the alive subset (same box, same order)."""
    n, levels = 1024, 4
    pos = (rng.normal(0, 1, (n, 3))
           * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[::3] = False
    total, entries = _pairs_budgets(pos, levels, alive=alive)
    a_m, U_m, ov_m = tree_acc_potential(
        pos, mass, alive, G_grav=1.0, eps2=1e-4, levels=levels, ws=1,
        max_chunks=total, pair_entries=entries, near="pairs")
    sub = alive.nonzero()[0]
    t2, e2 = _pairs_budgets(pos[sub], levels)
    a_s, U_s, ov_s = tree_acc_potential(
        pos[sub], mass[sub], G_grav=1.0, eps2=1e-4, levels=levels, ws=1,
        max_chunks=t2, pair_entries=e2, near="pairs")
    assert int(ov_m) == 0 and int(ov_s) == 0
    a_m = np.asarray(a_m)
    np.testing.assert_array_equal(a_m[~alive], 0.0)
    np.testing.assert_array_equal(a_m[alive], np.asarray(a_s))
    assert float(U_m) == pytest.approx(float(U_s), rel=1e-6)


@pytest.mark.slow
def test_simulate_tree_pairs(gauss_blob):
    """simulate(tree_near='pairs') probe-sizes max_chunks/pair_entries and
    matches the cells path over a short rollout."""
    pos, mass = gauss_blob
    objs = [ot.Object(mass=float(m) * 1e4, radius=1e-3,
                      velocity=np.zeros(3),
                      coordinates=ot.Coordinates(*p.tolist()))
            for m, p in zip(mass[:256], pos[:256])]
    r_cells = ot.simulate(objs, steps=10, dt=1e-4, softening=1e-2,
                          force_impl="tree", tree_levels=4,
                          precision="f32")
    r_pairs = ot.simulate(objs, steps=10, dt=1e-4, softening=1e-2,
                          force_impl="tree", tree_levels=4,
                          tree_near="pairs", precision="f32")
    assert r_pairs.config.tree_near == "pairs"
    assert r_pairs.config.tree_pair_entries
    scale = np.sqrt(np.mean(np.sum(r_cells.pos[-1] ** 2, -1)))
    np.testing.assert_allclose(r_pairs.pos[-1], r_cells.pos[-1],
                               atol=1e-4 * scale)

@pytest.mark.slow
def test_rollout_staged_matches_compiled(rng):
    """rollout_staged (host-driven two-program KDK for the large-N tree
    regime) reproduces the compiled rollout to f32 rounding, records the
    same trajectory shape, and reports zero overflow on a probed config."""
    from orbital_tpu.engine.state import make_state

    n, levels = 512, 4
    pos = (rng.normal(0, 1, (n, 3))
           * rng.uniform(0.05, 1.0, (n, 1))).astype(np.float32)
    vel = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    total, entries = _pairs_budgets(pos, levels)
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, force_impl="tree",
                       tree_levels=levels, tree_near="pairs",
                       tree_max_chunks=total, tree_pair_entries=entries)
    st = make_state(pos, vel, mass, precision="f32")

    st_c = ot.init_forces(st, cfg)
    fin_c, traj_c = ot.rollout_jit(st_c, cfg, 8, record_every=4)

    st_s = ot.init_forces_staged(st, cfg)
    np.testing.assert_allclose(np.asarray(st_s.acc), np.asarray(st_c.acc),
                               rtol=1e-5, atol=1e-7)
    fin_s, traj_s, ovf = ot.rollout_staged(st_s, cfg, 8, record_every=4)
    assert ovf == 0
    scale = np.sqrt(np.mean(np.sum(np.asarray(fin_c.pos) ** 2, -1)))
    np.testing.assert_allclose(np.asarray(fin_s.pos),
                               np.asarray(fin_c.pos), atol=1e-5 * scale)
    assert traj_s.pos.shape == traj_c.pos.shape
    np.testing.assert_allclose(np.asarray(traj_s.energy),
                               np.asarray(traj_c.energy), rtol=1e-5)
    assert float(fin_s.time) == pytest.approx(float(fin_c.time))

    # contract guards
    with pytest.raises(ValueError, match="kdk"):
        ot.rollout_staged(st_s, cfg.replace(integrator="euler"), 2)
    with pytest.raises(ValueError, match="tree"):
        ot.rollout_staged(st_s, cfg.replace(force_impl="dense"), 2)

@pytest.mark.slow
def test_simulate_routes_large_tree_to_staged(gauss_blob, monkeypatch):
    """At the staged-regime shape (levels >= 8, N >= 512k on the real
    platform; thresholds lowered here) simulate() routes through
    rollout_staged and produces the same SimResult surface."""
    import sys

    # orbital_tpu.simulate the ATTRIBUTE is the function (package
    # re-export); the module lives in sys.modules
    import orbital_tpu.simulate  # noqa: F401
    sim_mod = sys.modules["orbital_tpu.simulate"]

    pos, mass = gauss_blob
    objs = [ot.Object(mass=float(m) * 1e4, radius=1e-3,
                      velocity=np.zeros(3),
                      coordinates=ot.Coordinates(*p.tolist()))
            for m, p in zip(mass[:128], pos[:128])]
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_LEVELS", 4)
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_N", 64)
    calls = {}
    from orbital_tpu.engine import rollout as ro
    orig = ro.rollout_staged

    def spy(*a, **k):
        calls["staged"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ro, "rollout_staged", spy)
    r = ot.simulate(objs, steps=10, dt=1e-4, softening=1e-2,
                    force_impl="tree", tree_levels=4, tree_near="pairs",
                    precision="f32", record_every=5)
    assert calls.get("staged")
    assert r.pos.shape[0] == 2 and np.isfinite(r.pos).all()
    assert np.isfinite(r.energy).all()

@pytest.mark.slow
def test_tree_pairs_pathological_distributions(rng):
    """Chunk-pair geometry survives its adversarial shapes: every body
    in ONE tall column (maximum S, deepest octave, z-trim at its most
    load-bearing), and a near-boundary lattice with exactly one body per
    cell (octave 0 everywhere, every run length 1). Both must match the
    cells-mode near field to f32 rounding with zero overflow."""
    levels = 4
    M = 2 ** levels

    # one tall column: x, y fixed mid-cell; z spans the box
    n1 = 512
    z = np.linspace(-0.95, 0.95, n1)
    pos1 = np.stack([np.full(n1, 0.01), np.full(n1, 0.02), z],
                    axis=1).astype(np.float32)
    # lattice: one body per cell over an 8^3 block (jittered off centers)
    g = np.arange(8)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    cc = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    pos2 = (-1.0 + (cc + 0.5) * (2.0 / M)
            + rng.uniform(-0.2, 0.2, (512, 3)) * (2.0 / M)
            ).astype(np.float32)

    for pos in (pos1, pos2):
        n = len(pos)
        mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
        occ, nc = tree_occupancy_probe(pos, levels=levels)
        a_c, U_c, ov_c = tree_acc_potential(
            pos, mass, G_grav=1.0, eps2=1e-4, levels=levels, ws=1,
            capacity=int(occ) + 8, max_cells=int(nc) + 32, near="cells")
        total, entries = _pairs_budgets(pos, levels)
        a_p, U_p, ov_p = tree_acc_potential(
            pos, mass, G_grav=1.0, eps2=1e-4, levels=levels, ws=1,
            max_chunks=total, pair_entries=entries, near="pairs")
        assert int(ov_c) == 0 and int(ov_p) == 0
        # 512 bodies sharing one column make O(n)-term f32 sums whose
        # order differs between sweeps: tolerance is rounding-sized
        # (~5e-6 relative); a missed pair at eps2=1e-4 would be O(1e2)
        scale = np.sqrt(np.mean(np.sum(np.asarray(a_c) ** 2, -1)))
        np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_c),
                                   atol=1e-5 * scale)
        assert float(U_p) == pytest.approx(float(U_c), rel=1e-6)


@pytest.mark.slow
def test_simulate_routes_staged_mesh(gauss_blob, monkeypatch):
    """simulate(mesh=...) in the staged regime threads the mesh through
    rollout_staged (each tree phase one shard_map program) and matches the
    unsharded route bit-for-bit at f32."""
    import sys

    import orbital_tpu.simulate  # noqa: F401
    from orbital_tpu.parallel.mesh import make_mesh
    sim_mod = sys.modules["orbital_tpu.simulate"]

    pos, mass = gauss_blob
    objs = [ot.Object(mass=float(m) * 1e4, radius=1e-3,
                      velocity=np.zeros(3),
                      coordinates=ot.Coordinates(*p.tolist()))
            for m, p in zip(mass[:128], pos[:128])]
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_LEVELS", 4)
    monkeypatch.setattr(sim_mod, "_STAGED_MIN_N", 64)
    kw = dict(steps=10, dt=1e-4, softening=1e-2, force_impl="tree",
              tree_levels=4, tree_near="pairs", precision="f32",
              record_every=5)
    ref = ot.simulate(objs, **kw)

    calls = {}
    from orbital_tpu.engine import rollout as ro
    orig = ro.rollout_staged

    def spy(*a, **k):
        calls["mesh"] = k.get("mesh")
        return orig(*a, **k)

    monkeypatch.setattr(ro, "rollout_staged", spy)
    out = ot.simulate(objs, mesh=make_mesh(), **kw)
    assert calls.get("mesh") is not None
    np.testing.assert_allclose(out.pos, ref.pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.energy, ref.energy, rtol=1e-6)
