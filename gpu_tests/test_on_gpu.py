"""Compiled-kernel and path validation on the GPU (skipped elsewhere by
the ``gpu`` fixture of conftest.py).

Tolerances: the kernels sum in float32 in another order than the dense
XLA oracle, so 1e-5 relative to the largest acceleration is rounding
level at N = 4096."""
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.engine.state import make_state
from orbital_tpu.ops.collisions import bounce_deltas, bounce_deltas_chunked
from orbital_tpu.ops.forces import pairwise_acc_dense
from orbital_tpu.ops.pallas_forces import pairwise_acc_pallas

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cluster():
    rng = np.random.default_rng(0)
    n = 4096
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    radius = np.full(n, 0.05, np.float32)
    return pos, vel, mass, radius


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_pallas_forces_on_gpu(cluster):
    pos, _, mass, _ = cluster
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
    a, U = pairwise_acc_pallas(pos, mass, G=1.0, eps2=1e-4)
    assert _relerr(a, a_ref) < 1e-5
    assert abs(float(U) - float(U_ref)) / abs(float(U_ref)) < 1e-5


def test_bounce_chunked_on_gpu(cluster):
    """The large-N bounce sweep (row-chunked XLA) equals the dense one."""
    pos, vel, mass, radius = cluster
    alive = np.ones(len(mass), bool)
    dp_ref, dv_ref = bounce_deltas(pos, vel, mass, radius, alive,
                                   restitution=0.9)
    dp, dv = bounce_deltas_chunked(pos, vel, mass, radius, alive,
                                   restitution=0.9)
    assert float(np.abs(np.asarray(dv_ref)).max()) > 0
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dv_ref), atol=1e-4)
    np.testing.assert_allclose(np.asarray(dp), np.asarray(dp_ref), atol=1e-5)


def test_ds32_drift_on_gpu(cluster):
    from bench import energy_hybrid, make_cluster

    pos, vel, mass, eps2 = make_cluster(4096)
    st = make_state(pos, vel, mass, precision="ds32")
    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=eps2)
    st = ot.init_forces(st, cfg)
    E0 = energy_hybrid(st, eps2)
    fin, _ = ot.rollout_jit(st, cfg, 2000)
    E1 = energy_hybrid(fin, eps2)
    assert abs((E1 - E0) / E0) < 1e-6


def test_fused_detect_on_gpu(cluster):
    from orbital_tpu.ops.collisions import count_contacts_dense
    from orbital_tpu.ops.pallas_forces import pairwise_acc_detect_pallas

    pos, _, mass, radius = cluster
    alive = np.ones(len(mass), bool)
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
    c_ref = int(count_contacts_dense(pos, radius, alive))
    a, U, c = pairwise_acc_detect_pallas(pos, mass, radius, alive,
                                         G=1.0, eps2=1e-4)
    assert int(c) == c_ref
    assert _relerr(a, a_ref) < 1e-5


def test_pallas_jerk_on_gpu(cluster):
    from orbital_tpu.ops.forces import accel_jerk_dense
    from orbital_tpu.ops.pallas_forces import accel_jerk_pallas

    pos, vel, mass, _ = cluster
    a_ref, j_ref, _ = accel_jerk_dense(pos, vel, mass, G=1.0, eps2=1e-4)
    a, j, _ = accel_jerk_pallas(pos, vel, mass, G=1.0, eps2=1e-4)
    assert _relerr(a, a_ref) < 1e-5
    assert _relerr(j, j_ref) < 1e-5


def test_pm_on_gpu():
    from orbital_tpu.ops.pm import pm_acc_potential

    rng = np.random.default_rng(1)
    n = 2048
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=0.09)
    a, _ = pm_acc_potential(pos, mass, G_grav=1.0, eps2=0.09, grid=64)
    a, a_ref = np.asarray(a), np.asarray(a_ref)
    rms = (np.sqrt(np.mean(np.sum((a - a_ref) ** 2, -1)))
           / np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert rms < 0.03


def test_p3m_on_gpu():
    from orbital_tpu.ops.p3m import p3m_acc_potential

    rng = np.random.default_rng(3)
    n = 4096
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    a_ref, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    a, _, ov = p3m_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6, grid=64)
    assert int(ov) == 0
    a, a_ref = np.asarray(a), np.asarray(a_ref)
    rms = (np.sqrt(np.mean(np.sum((a - a_ref) ** 2, -1)))
           / np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert rms < 6e-3


def test_tree_on_gpu():
    """Conv far field + near-field sweeps compile and match the dense
    oracle on the card, where a float32 conv could run in TF32 without
    the HIGHEST-precision taps (CPU tests run full float32 regardless)."""
    from orbital_tpu.ops.tree import tree_acc_potential, tree_occupancy_probe

    rng = np.random.default_rng(5)
    n = 4096
    pos = rng.normal(size=(n, 3)).astype(np.float32)  # concentrated blob
    mass = (rng.uniform(0.5, 1.5, n) / n).astype(np.float32)
    a_ref, U_ref = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-6)
    cap, occ = tree_occupancy_probe(pos, levels=6)
    a, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=6, capacity=int(cap) + 8,
                                  max_cells=int(occ) + 32)
    assert int(ov) == 0
    a, a_ref = np.asarray(a), np.asarray(a_ref)
    rms = (np.sqrt(np.mean(np.sum((a - a_ref) ** 2, -1)))
           / np.sqrt(np.mean(np.sum(a_ref ** 2, -1))))
    assert rms < 3e-2
    assert abs(float(U) - float(U_ref)) / abs(float(U_ref)) < 3e-2
    # total momentum exchange cancels to rounding (tap antisymmetry)
    mom = (np.asarray(mass)[:, None] * a).sum(0)
    assert np.abs(mom).max() < 1e-5 * np.abs(
        np.asarray(mass)[:, None] * a).max()


def test_tree_level8_fits_hbm_on_gpu():
    """levels=8 (16.7M finest cells) compiles and runs on one card."""
    from orbital_tpu.ops.tree import tree_acc_potential

    rng = np.random.default_rng(6)
    n = 8192
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (r[:, None] * v).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    a, U, ov = tree_acc_potential(pos, mass, G_grav=1.0, eps2=1e-6,
                                  levels=8, capacity=32)
    assert np.isfinite(np.asarray(a)).all()
    assert int(ov) == 0


def test_yoshida4_on_gpu(cluster):
    """The composed symplectic stepper compiles and conserves through the
    resolved force path on the card (ds32 state)."""
    from orbital_tpu.engine.rollout import init_forces, rollout_jit
    from orbital_tpu.ops import diagnostics as diag

    pos, vel, mass, radius = cluster
    st = make_state(pos, 0.1 * vel, mass, radius, precision="ds32")
    cfg = ot.SimConfig(dt=1e-4, G=1.0, eps2=1e-2, integrator="yoshida4")
    st = init_forces(st, cfg)
    e0 = float(diag.total_energy(st.vel_full(), st.mass, st.potential))
    fin, _ = rollout_jit(st, cfg, 200)
    e1 = float(diag.total_energy(fin.vel_full(), fin.mass, fin.potential))
    assert np.isfinite(np.asarray(fin.pos)).all()
    assert abs((e1 - e0) / e0) < 1e-4


def test_block_hermite_on_gpu():
    """Fast/slow Hermite: the cond-skipped substep loop, the F x N subset
    evaluation, and the scatter-merge compile and run on the card."""
    from orbital_tpu.engine.rollout import init_forces, rollout_jit

    s_b, m_b = 0.02, 0.5
    v_b = np.sqrt(1.0 * (2 * m_b) / s_b) / 2.0
    rng = np.random.default_rng(4)
    n_out = 126
    ang = rng.uniform(0, 2 * np.pi, n_out)
    R = rng.uniform(2.0, 6.0, n_out)
    pos = np.concatenate([
        [[-s_b / 2, 0, 0], [s_b / 2, 0, 0]],
        np.stack([R * np.cos(ang), R * np.sin(ang),
                  0.1 * rng.standard_normal(n_out)], 1)]).astype(np.float32)
    vel = np.concatenate([
        [[0, -v_b, 0], [0, v_b, 0]],
        np.stack([-np.sin(ang) / np.sqrt(R), np.cos(ang) / np.sqrt(R),
                  np.zeros(n_out)], 1)]).astype(np.float32)
    mass = np.concatenate([[m_b, m_b], np.full(n_out, 1e-6)]).astype(
        np.float32)
    T_b = 2 * np.pi * np.sqrt(s_b ** 3 / (1.0 * 2 * m_b))
    st = make_state(pos, vel, mass, precision="f32")
    cfg = ot.SimConfig(dt=T_b / 4, G=1.0, eps2=1e-10, integrator="hermite",
                       adaptive_eta=0.02, dt_min=T_b / 4096,
                       hermite_fast_cap=4, hermite_max_substeps=256)
    st = init_forces(st, cfg)
    fin, _ = rollout_jit(st, cfg, 16)  # 4 binary orbits
    sep = float(np.linalg.norm(np.asarray(fin.pos)[0]
                               - np.asarray(fin.pos)[1]))
    assert abs(sep - s_b) / s_b < 0.1  # binary survives at macro dt


def test_tree_probed_budgets_on_gpu():
    """Probe-sized class budgets (tree_class_probe -> max_big /
    max_frontier) reproduce the heuristic-budget result with zero
    overflow on the card."""
    from orbital_tpu.ops.tree import tree_acc_potential, tree_class_probe

    rng = np.random.default_rng(7)
    n = 8192
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (r[:, None] * v).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    cap, occ, nbig, nfront = tree_class_probe(pos, levels=6, ws=1)
    kw = dict(G_grav=1.0, eps2=1e-6, levels=6,
              capacity=int(np.ceil((int(cap) + 8) / 16) * 16),
              max_cells=int(np.ceil((int(occ) * 1.3) / 512) * 512))
    a_ref, U_ref, ov_ref = tree_acc_potential(pos, mass, **kw)
    a, U, ov = tree_acc_potential(
        pos, mass, **kw,
        max_big=max(256, int(nbig) + 32),
        max_frontier=max(256, int(nfront) + 32))
    assert int(ov_ref) == 0 and int(ov) == 0
    # the GPU's scatter-adds are atomic, so two programs sum in different
    # orders: equal to float32 rounding, not bit for bit
    scale = float(np.sqrt(np.mean(np.sum(np.asarray(a_ref) ** 2, -1))))
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               atol=1e-6 * scale)
    assert float(U) == pytest.approx(float(U_ref), rel=1e-6)


def test_tree_pairs_on_gpu():
    """Chunk-pair near field (tree_near='pairs', z-trimmed octave runs)
    matches the cells sweep on the card with zero overflow, at a
    realistic 65k shape."""
    from orbital_tpu.ops.tree import (tree_acc_potential,
                                      tree_occupancy_probe,
                                      tree_pairs_budgets)

    rng = np.random.default_rng(11)
    n = 65536
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (r[:, None] * v).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)

    occ, nc = tree_occupancy_probe(pos, levels=7)
    a_c, U_c, ov_c = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-6, levels=7, ws=1,
        capacity=int(occ) + 8, max_cells=int(nc) + 64, near="cells")
    kch, entries = tree_pairs_budgets(pos, levels=7)
    a_p, U_p, ov_p = tree_acc_potential(
        pos, mass, G_grav=1.0, eps2=1e-6, levels=7, ws=1,
        max_chunks=kch, pair_entries=entries, near="pairs")
    assert int(ov_c) == 0 and int(ov_p) == 0
    scale = float(np.sqrt(np.mean(np.sum(np.asarray(a_c) ** 2, -1))))
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_c),
                               atol=1e-4 * scale)
    assert float(U_p) == pytest.approx(float(U_c), rel=1e-5)


def test_ring_block_kernel_on_gpu(cluster):
    """The ring's rectangular block kernel against the chunked XLA block
    (the same partial sums of block j on block i)."""
    from orbital_tpu.ops.forces import block_acc_chunked
    from orbital_tpu.ops.pallas_forces import block_acc_pallas

    pos, _, mass, _ = cluster
    a, pe = block_acc_pallas(pos[:1024], pos, mass, G=1.0, eps2=1e-4)
    a_ref, pe_ref = block_acc_chunked(pos[:1024], pos, mass, G=1.0,
                                      eps2=1e-4)
    assert _relerr(a, a_ref) < 1e-5
    assert _relerr(pe, pe_ref) < 1e-5


def test_auto_path_is_the_gpu_kernel():
    """force_impl='auto' above 4096 bodies resolves to the GPU kernel."""
    from orbital_tpu.ops import backend

    assert backend.platform() == "gpu"
    assert backend.exact_sweep_impl(65536) == "pallas"
    assert backend.exact_sweep_impl(4096) == "dense"
