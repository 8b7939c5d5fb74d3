"""Randomized cross-path property sweeps: every force/collision
implementation must agree with the dense oracle on the same seeds, and
conservation laws must hold regardless of path. Seeds are fixed —
deterministic in CI."""
import numpy as np
import pytest

import orbital_tpu as ot
from orbital_tpu.engine.state import make_state
from orbital_tpu.ops.forces import (accel_jerk_chunked, accel_jerk_dense,
                                    pairwise_acc_chunked, pairwise_acc_dense)
from orbital_tpu.ops.pallas_forces import pairwise_acc_pallas as _kernel
from orbital_tpu.ops import collisions as coll


def pairwise_acc_pallas(*args, **kw):
    """The GPU kernel in the Pallas interpreter."""
    return _kernel(*args, interpret=True, **kw)


def _cluster(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    return pos, vel, mass, alive


@pytest.mark.parametrize("seed,n,eps2", [
    (1, 128, 1e-4), (2, 256, 1e-2), (3, 384, 1e-6), (4, 512, 1e-4),
])
def test_force_paths_agree(seed, n, eps2):
    pos, _, mass, alive = _cluster(seed, n)
    a_ref, U_ref = pairwise_acc_dense(pos, mass, alive, G=1.3, eps2=eps2)
    for name, fn in [
        ("chunked", lambda: pairwise_acc_chunked(
            pos, mass, alive, G=1.3, eps2=eps2, chunk=64)),
        ("pallas", lambda: pairwise_acc_pallas(
            pos, mass, alive, G=1.3, eps2=eps2)),
    ]:
        a, U = fn()
        err = np.abs(np.asarray(a) - np.asarray(a_ref)).max()
        scale = np.abs(np.asarray(a_ref)).max()
        assert err < 2e-5 * scale, (name, seed)
        assert float(U) == pytest.approx(float(U_ref), rel=2e-5), (name, seed)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_force_antisymmetry_total_momentum(seed):
    """Newton's third law: total force (sum m*a) vanishes for every path."""
    pos, _, mass, alive = _cluster(seed, 256)
    m_eff = mass * alive
    for fn in (
        lambda: pairwise_acc_dense(pos, mass, alive, G=1.0, eps2=1e-4)[0],
        lambda: pairwise_acc_pallas(pos, mass, alive, G=1.0, eps2=1e-4)[0],
    ):
        F = np.sum(m_eff[:, None] * np.asarray(fn()), axis=0)
        scale = float(np.abs(m_eff[:, None] * np.asarray(fn())).max())
        assert np.abs(F).max() < 1e-4 * scale


@pytest.mark.parametrize("seed", [8, 9])
def test_jerk_paths_agree(seed):
    pos, vel, mass, alive = _cluster(seed, 192)
    a1, j1, U1 = accel_jerk_dense(pos, vel, mass, alive, G=1.0, eps2=1e-3)
    a2, j2, U2 = accel_jerk_chunked(pos, vel, mass, alive, G=1.0, eps2=1e-3,
                                    chunk=64)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(j2), np.asarray(j1), rtol=2e-6,
                               atol=1e-7)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_merge_conserves_mass_momentum_random(seed):
    rng = np.random.default_rng(seed)
    n = 128
    pos = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    radius = np.full(n, 0.08, np.float32)
    alive = rng.uniform(size=n) > 0.05
    outs = coll.merge_groups(pos, vel, mass * alive, radius * alive, alive)
    p2, v2, m2, r2, a2 = (np.asarray(x) for x in outs)
    assert np.asarray(a2).sum() < alive.sum()  # some merges happened
    np.testing.assert_allclose(m2.sum(), (mass * alive).sum(), rtol=1e-6)
    np.testing.assert_allclose((m2[:, None] * v2).sum(0),
                               ((mass * alive)[:, None] * vel).sum(0),
                               rtol=1e-4, atol=1e-5)
    # chunked roots give the identical partition
    outs_c = coll.merge_groups(pos, vel, mass * alive, radius * alive,
                               alive, chunk=32)
    for a, b in zip(outs_c, outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed,integ", [(21, "kdk"), (22, "euler"),
                                        (23, "rk4"), (24, "yoshida4")])
def test_bounce_rollout_conserves_momentum_random(seed, integ):
    rng = np.random.default_rng(seed)
    n = 64
    pos = (rng.normal(size=(n, 3)) * 0.6).astype(np.float64)
    vel = (rng.normal(size=(n, 3)) * 0.4).astype(np.float64)
    mass = rng.uniform(0.5, 1.5, n)
    radius = np.full(n, 0.1)
    st = make_state(pos, vel, mass, radius, precision="f64")
    cfg = ot.SimConfig(dt=5e-3, G=1e-3, eps2=1e-4, collisions="bounce",
                       restitution=0.7, force_impl="dense",
                       integrator=integ)
    st = ot.init_forces(st, cfg)
    p0 = (mass[:, None] * np.asarray(st.vel)).sum(0)
    fin, _ = ot.rollout_jit(st, cfg, 50)
    p1 = (np.asarray(fin.mass)[:, None] * np.asarray(fin.vel_full())).sum(0)
    np.testing.assert_allclose(p1, p0, rtol=1e-9, atol=1e-12)
