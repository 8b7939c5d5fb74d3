"""chip_smoke.py rehearsed on the CPU: its phase functions at tiny sizes
(kernels in the Pallas interpreter), and the script itself refusing to run
without a GPU or outside the repository."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    kernel_n=(512,), kdk_n=256, sample_rows=64, reps=1, main_n=256,
    main_steps=20, main_record_every=10, paths_n=512, pm_n=1024, pm_grid=16,
    tree_levels=4, staged_n=1024, staged_levels=4, ensemble=2,
    ensemble_steps=4, multichip_n=512)


def test_kernel_phase_tiny():
    out = chip_smoke.phase_kernels(TINY)
    res = out["512"]
    assert set(res) == {"force", "force_pe", "detect", "jerk",
                        "jerk_detect", "ring_block"}
    assert res["detect"]["contacts"] == res["detect"]["contacts_kdtree"] > 0
    assert res["jerk_detect"]["contacts"] == res["detect"]["contacts"]
    for r in res.values():
        assert r["kernel_acc_err"]["rms"] <= chip_smoke.ACC_RMS_BOUND
        assert r["kernel_s"] > 0 and r["xla_s"] > 0
    assert len(out["kdk_step_s"]["pallas"]) == 2


def test_main_phase_tiny():
    out = chip_smoke.phase_main(TINY)
    assert out["simulate"]["records"] == 2
    assert out["simulate"]["energy_drift_f64"] <= chip_smoke.DRIFT_BUDGET
    assert out["cli_simulate"]["steps"] == 365


def test_paths_phase_tiny():
    out = chip_smoke.phase_paths(TINY)
    assert set(out) >= {"hermite", "bounce", "resolve", "pm", "p3m",
                        "tree_pairs", "tree_staged", "respa_k4", "ensemble"}
    assert out["bounce"]["contacts_at_start"] > 0
    assert out["bounce"]["momentum_change"] < 1e-6


def test_multichip_phase_on_cpu_mesh():
    """The four-card phase on four of the suite's eight virtual CPU
    devices (the mesh and the comparison; the kernel is interpreted)."""
    import jax

    out = chip_smoke.phase_multichip(TINY, devices=jax.devices()[:4])
    assert out["devices"] == 4
    assert out["ring_vs_single"]["rms"] <= chip_smoke.ACC_RMS_BOUND


def test_contact_radius_gives_contacts():
    rng = np.random.default_rng(0)
    n = 4096
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    c = chip_smoke.kdtree_contacts(pos, chip_smoke.contact_radius(n))
    assert 100 <= c <= 1000  # ~200 pairs, counted both ways


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_without_gpu_exits_nonzero():
    out = _run([str(REPO / "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
