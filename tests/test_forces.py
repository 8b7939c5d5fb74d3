"""Device force kernels: dense vs chunked vs host-numpy reference, masks,
potential bookkeeping."""
import numpy as np
import pytest

from orbital_tpu.ops.forces import pairwise_acc_chunked, pairwise_acc_dense

G = 6.67430e-11


def numpy_forces(pos, mass, eps2, G=G):
    """Independent O(N^2) f64 oracle."""
    d = pos[None] - pos[:, None]
    r2 = np.einsum("ijk,ijk->ij", d, d) + eps2
    np.fill_diagonal(r2, 1.0)
    inv_r = 1.0 / np.sqrt(r2)
    np.fill_diagonal(inv_r, 0.0)
    inv_r3 = inv_r**3
    acc = G * np.einsum("ij,ijk->ik", mass[None] * inv_r3, d)
    U = -0.5 * G * np.sum(mass[:, None] * mass[None] * inv_r)
    return acc, U


@pytest.fixture
def cluster(rng):
    n = 64
    pos = rng.normal(size=(n, 3))
    mass = rng.uniform(0.1, 2.0, n)
    return pos, mass


def test_dense_matches_numpy(cluster):
    pos, mass = cluster
    acc, U = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
    acc_np, U_np = numpy_forces(pos, mass, 1e-4, G=1.0)
    np.testing.assert_allclose(np.asarray(acc), acc_np, rtol=1e-10)
    assert float(U) == pytest.approx(U_np, rel=1e-10)


def test_chunked_matches_dense(cluster):
    pos, mass = cluster
    acc_d, U_d = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
    acc_c, U_c = pairwise_acc_chunked(pos, mass, G=1.0, eps2=1e-4, chunk=16)
    np.testing.assert_allclose(np.asarray(acc_c), np.asarray(acc_d), rtol=1e-12)
    assert float(U_c) == pytest.approx(float(U_d), rel=1e-12)


def test_chunked_requires_divisible():
    pos = np.zeros((10, 3))
    with pytest.raises(ValueError):
        pairwise_acc_chunked(pos, np.ones(10), G=1.0, eps2=0.0, chunk=16)


def test_alive_mask_excludes_dead(cluster):
    pos, mass = cluster
    alive = np.ones(len(mass), dtype=bool)
    alive[10:20] = False
    acc, U = pairwise_acc_dense(pos, mass, alive, G=1.0, eps2=1e-4)
    acc_np, U_np = numpy_forces(pos[alive], mass[alive], 1e-4, G=1.0)
    np.testing.assert_allclose(np.asarray(acc)[alive], acc_np, rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(acc)[~alive], 0.0)
    assert float(U) == pytest.approx(U_np, rel=1e-10)


def test_newtons_third_law(cluster):
    pos, mass = cluster
    acc, _ = pairwise_acc_dense(pos, mass, G=1.0, eps2=0.0)
    total_force = np.sum(mass[:, None] * np.asarray(acc), axis=0)
    np.testing.assert_allclose(total_force, 0.0, atol=1e-10)


def test_unsoftened_no_nan_on_self():
    # eps=0 must still mask the diagonal cleanly
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    acc, U = pairwise_acc_dense(pos, np.array([1.0, 1.0]), G=1.0, eps2=0.0)
    assert np.all(np.isfinite(np.asarray(acc)))
    assert float(U) == pytest.approx(-1.0)
    np.testing.assert_allclose(np.asarray(acc)[0], [1.0, 0, 0])


def test_two_body_softened_values():
    # manual check of softening: inv_r uses sqrt(r^2 + eps^2)
    pos = np.array([[0.0, 0, 0], [3.0, 0, 0]])
    mass = np.array([2.0, 5.0])
    eps2 = 16.0  # r2 + eps2 = 25
    acc, U = pairwise_acc_dense(pos, mass, G=1.0, eps2=eps2)
    assert np.asarray(acc)[0, 0] == pytest.approx(5.0 * 3.0 / 125.0)
    assert np.asarray(acc)[1, 0] == pytest.approx(-2.0 * 3.0 / 125.0)
    assert float(U) == pytest.approx(-2.0 * 5.0 / 5.0)


def test_mxu_gram_formulation_matches_dense(rng):
    """The Gram-matrix path (``force_impl="mxu"``, ops/mxu_forces.py) is
    correctness-checked at its documented accuracy (~1e-4 rel: the Gram
    identity cancels bits on close pairs)."""
    from orbital_tpu.ops.mxu_forces import pairwise_acc_mxu

    n = 512
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 2.0, n).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    a_ref, U_ref = pairwise_acc_dense(pos, mass, alive, G=1.0, eps2=1e-4)
    a, U = pairwise_acc_mxu(pos, mass, alive, G=1.0, eps2=1e-4, chunk=128)
    err = np.abs(np.asarray(a) - np.asarray(a_ref)).max() / np.abs(a_ref).max()
    assert err < 5e-4
    assert float(U) == pytest.approx(float(U_ref), rel=1e-4)
