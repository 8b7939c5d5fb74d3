"""bench.py helpers and the benchmarks CLI (cheap CPU configs)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, timeout=600, env=None):
    return subprocess.run([sys.executable, *args], cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_benchmarks_cli_lagrange3():
    out = _run(["-m", "benchmarks.run", "--config", "lagrange3",
                "--steps", "50", "--iters", "5", "--precision", "f32",
                "--platform", "cpu"])
    assert out.returncode == 0, out.stderr[-1500:]
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["config"] == "lagrange3" and data["n"] == 3
    assert data["body_steps_per_s"] > 0


def test_benchmarks_cli_rk4_integrator():
    out = _run(["-m", "benchmarks.run", "--config", "lagrange3",
                "--steps", "20", "--iters", "4", "--integrator", "rk4",
                "--precision", "f32", "--platform", "cpu"])
    assert out.returncode == 0, out.stderr[-1500:]
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["integrator"] == "rk4"


def test_bench_exits_nonzero_without_gpu():
    """The bench never falls back to the CPU: no GPU, no result."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = _run(["bench.py"], timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_device_potential_uses_resolved_sweep():
    """Without the native oracle the virial scaling takes the resolved
    exact sweep (dense/chunked on the CPU), never a Pallas interpreter."""
    sys.path.insert(0, str(REPO))
    try:
        from bench import device_potential
        from orbital_tpu.ops.forces import pairwise_acc_dense

        rng = np.random.default_rng(0)
        pos = rng.normal(size=(256, 3)).astype(np.float32)
        mass = np.full(256, 1.0 / 256, np.float32)
        _, U = pairwise_acc_dense(pos, mass, G=1.0, eps2=1e-4)
        assert device_potential(pos, mass, 1e-4) == pytest.approx(
            float(U), rel=1e-6)
    finally:
        sys.path.remove(str(REPO))


def test_bench_cluster_is_virialized():
    sys.path.insert(0, str(REPO))
    try:
        from bench import make_cluster
        from orbital_tpu.utils import native

        pos, vel, mass, eps2 = make_cluster(256)
        U = abs(native.potential_f64(pos, mass, eps2))
        K = 0.5 * float(np.sum(mass * np.sum(vel**2, -1)))
        assert 2 * K == pytest.approx(U, rel=1e-5)
    finally:
        sys.path.remove(str(REPO))


def test_bench_ensemble_drift_small():
    """The ensemble-drift certification rung: a tiny
    ensemble over a short horizon must return finite, small per-member
    drift, with the member-0 control no worse than the max."""
    sys.path.insert(0, str(REPO))
    try:
        from bench import bench_ensemble_drift

        d_max, d_m0 = bench_ensemble_drift(4, steps=40, chunk=20)
        assert np.isfinite(d_max) and np.isfinite(d_m0)
        assert 0.0 <= d_m0 <= d_max < 1e-4  # short horizon: well under budget
    finally:
        sys.path.remove(str(REPO))
