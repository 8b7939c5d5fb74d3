"""Flask service: routes, payload schema, thread safety setup."""
import importlib
import json
import os
import sys

import numpy as np
import pytest


@pytest.fixture(scope="module")
def client():
    os.environ.update({
        "SIM_INITIAL_STEPS": "20",
        "SIM_MAX_HISTORY": "100",
        "SIM_DISABLE_THREAD": "true",
        "SIM_MOONS": "false",
        "USE_CACHE": "false",
    })
    # the golden-test `reference` fixture puts /root/reference on sys.path
    # (it also has an `app` package); pin the repo root first so this
    # always imports OUR app regardless of test ordering
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != repo_root:
        sys.path.insert(0, repo_root)
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    mod = importlib.import_module("app.app")
    mod.app.config["TESTING"] = True
    with mod.app.test_client() as c:
        yield c, mod


def test_health(client):
    c, _ = client
    r = c.get("/health")
    assert r.status_code == 200
    assert r.get_json() == {"status": "ok"}


def test_api_state_schema(client):
    c, mod = client
    r = c.get("/api/state")
    assert r.status_code == 200
    data = r.get_json()
    assert set(data) >= {"bodies", "mass_min", "mass_max", "radius_min",
                         "radius_max", "time_elapsed", "sim_time_jd",
                         "sim_time_iso"}
    assert len(data["bodies"]) == 15
    body = next(b for b in data["bodies"] if b["name"] == "Earth")
    assert set(body) == {"id", "name", "mass_kg", "radius_km", "T_seconds",
                         "fg_ms2", "position"}
    assert body["radius_km"] == pytest.approx(6371.0)
    assert body["T_seconds"] == pytest.approx(365.25 * 86400, rel=2e-3)
    # warmed up 20 steps of 1800 s
    assert data["time_elapsed"] == pytest.approx(20 * 1800.0)
    assert data["sim_time_iso"].startswith("2000-01-01T22:00")  # J2000 epoch 12:00 UTC + 10 h


def test_index_bootstrap(client):
    c, _ = client
    r = c.get("/")
    assert r.status_code == 200
    html = r.data.decode()
    assert "__BOOTSTRAP__" in html and "orbital-tpu" in html


def test_snapshot_advances(client):
    c, mod = client
    t0 = c.get("/api/state").get_json()["time_elapsed"]
    with mod.engine_lock:
        mod.engine.step()
        mod._snapshot = mod.build_snapshot()
    t1 = c.get("/api/state").get_json()["time_elapsed"]
    assert t1 == pytest.approx(t0 + mod.INTERVAL)


def test_checkpoint_endpoint(client, tmp_path):
    c, mod = client
    os.environ["CHECKPOINT_FP"] = str(tmp_path / "ck.npz")
    r = c.post("/api/checkpoint")
    assert r.status_code == 200
    assert (tmp_path / "ck.npz").exists()


def test_resume_from_cache_skips_warmup(tmp_path):
    """RESUME_FROM_CACHE=true restores the sim clock from the JSONL cache
    instead of re-warming (the failure-recovery path the reference lacks)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    cache = tmp_path / "cache.jsonl"
    script = f'''
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import os
os.environ.update(SIM_INITIAL_STEPS="40", SIM_DISABLE_THREAD="true",
                  SIM_MOONS="false", USE_CACHE="true",
                  CACHE_FP={str(cache)!r}, CACHE_EVERY_N="10")
import app.app as first
t_first = first.engine.time_elapsed
assert t_first == 40 * first.INTERVAL

# simulate a pod restart: fresh import with resume enabled and no warmup
import importlib, sys
for m in list(sys.modules):
    if m.startswith("app"):
        del sys.modules[m]
os.environ.update(SIM_INITIAL_STEPS="0", RESUME_FROM_CACHE="true")
import app.app as second
# resumed from the last cached frame (step 30), not from scratch
assert second.engine.time_elapsed == 30 * second.INTERVAL, second.engine.time_elapsed
assert len(second.engine.objects) == 15
print("RESUME_OK")
'''
    out = subprocess.run([sys.executable, "-c", script], cwd=str(repo),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESUME_OK" in out.stdout


@pytest.fixture()
def cluster_client():
    """App in large-N demo mode (tiny N for CPU CI)."""
    saved = {k: os.environ.get(k) for k in
             ("SIM_SCENE", "SIM_N", "SIM_VIEW_MAX", "SIM_INITIAL_STEPS",
              "SIM_STEPS_PER_TICK", "SIM_DISABLE_THREAD")}
    os.environ.update({
        "SIM_SCENE": "cluster",
        "SIM_N": "256",
        "SIM_VIEW_MAX": "64",
        "SIM_INITIAL_STEPS": "20",
        "SIM_STEPS_PER_TICK": "5",
        "SIM_DISABLE_THREAD": "true",
    })
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != repo_root:
        sys.path.insert(0, repo_root)
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    mod = importlib.import_module("app.app")
    mod.app.config["TESTING"] = True
    with mod.app.test_client() as c:
        yield c, mod
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_cluster_demo_mode(cluster_client):
    """SIM_SCENE=cluster serves a decimated live cluster through the same
    payload schema: N_view bodies, advancing time, compiled rollout ticks."""
    c, mod = cluster_client
    d = c.get("/api/state").get_json()
    assert len(d["bodies"]) == 64
    assert d["scene"]["kind"] == "cluster"
    assert d["scene"]["n_total"] == 256
    b = d["bodies"][0]
    assert set(b) >= {"id", "name", "mass_kg", "radius_km", "position"}
    t0 = d["time_elapsed"]

    # advance one tick exactly as the sim thread would
    with mod.engine_lock:
        from orbital_tpu.engine.rollout import rollout

        mod._cl["state"], _ = rollout(mod._cl["state"], mod._cl["cfg"],
                                      mod.SIM_STEPS_PER_TICK)
        mod._snapshot = mod.build_snapshot()
    d1 = c.get("/api/state").get_json()
    assert d1["time_elapsed"] > t0

    # bootstrap page renders with the decimated history
    r = c.get("/")
    assert r.status_code == 200
    assert c.get("/health").get_json()["status"] == "ok"

@pytest.fixture()
def tree_cluster_client():
    """Cluster demo with SIM_FORCE=tree (tiny N + shallow levels for CPU)."""
    keys = ("SIM_SCENE", "SIM_N", "SIM_VIEW_MAX", "SIM_INITIAL_STEPS",
            "SIM_STEPS_PER_TICK", "SIM_DISABLE_THREAD", "SIM_FORCE",
            "SIM_TREE_LEVELS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({
        "SIM_SCENE": "cluster",
        "SIM_N": "256",
        "SIM_VIEW_MAX": "32",
        "SIM_INITIAL_STEPS": "10",
        "SIM_STEPS_PER_TICK": "5",
        "SIM_DISABLE_THREAD": "true",
        "SIM_FORCE": "tree",
        "SIM_TREE_LEVELS": "4",
    })
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != repo_root:
        sys.path.insert(0, repo_root)
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    mod = importlib.import_module("app.app")
    mod.app.config["TESTING"] = True
    with mod.app.test_client() as c:
        yield c, mod
    sys.modules.pop("app.app", None)
    sys.modules.pop("app", None)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.slow
def test_cluster_demo_tree_force(tree_cluster_client):
    """SIM_FORCE=tree drives the cluster demo on the multilevel tree
    (probe-sized pairs budgets); the staged branch of the same _advance
    wrapper advances time via rollout_staged with zero overflow."""
    c, mod = tree_cluster_client
    assert mod._cl["cfg"].force_impl == "tree"
    assert mod._cl["cfg"].tree_near == "pairs"
    assert mod._cl["cfg"].tree_pair_entries
    d = c.get("/api/state").get_json()
    assert len(d["bodies"]) == 32
    t0 = d["time_elapsed"]
    with mod.engine_lock:
        mod._cl["advance"](mod.SIM_STEPS_PER_TICK)
        mod._snapshot = mod.build_snapshot()
    d1 = c.get("/api/state").get_json()
    assert d1["time_elapsed"] > t0

    # the staged branch of the same wrapper (the >= 512k path, small here)
    t1 = float(mod._cl["state"].time)
    with mod.engine_lock:
        mod._cl["staged"] = True
        mod._cl["advance"](2)
        mod._cl["staged"] = False
    assert float(mod._cl["state"].time) > t1


def test_viewer_bootstrap_page_e2e(client):
    """Headless end-to-end of the viewer bootstrap path:
    the rendered page must carry a parseable ``window.__BOOTSTRAP__``
    whose schema is what main.js / fallback2d.js actually consume, and
    the module chain (main.js + the zero-egress 2D fallback) must be
    served by the static route of the werkzeug shim."""
    import re

    c, _ = client
    r = c.get("/")
    assert r.status_code == 200
    html = r.get_data(as_text=True)

    m = re.search(r"window\.__BOOTSTRAP__\s*=\s*\{\s*history:\s*(.*?),\s*"
                  r"snapshot:\s*(.*?)\s*\};", html, re.DOTALL)
    assert m, "bootstrap blob missing from the rendered page"
    history = json.loads(m.group(1))
    snapshot = json.loads(m.group(2))
    # fields fallback2d.js walks: snapshot.bodies[*].{name, position.xyz}
    assert isinstance(snapshot["bodies"], list) and snapshot["bodies"]
    b0 = snapshot["bodies"][0]
    for key in ("name", "position", "radius_km", "mass_kg"):
        assert key in b0, f"snapshot body missing {key}"
    assert set(b0["position"]) == {"x", "y", "z"}
    # history seeds the trails: name -> [[x, y, z], ...]
    assert isinstance(history, dict) and history
    some = next(iter(history.values()))
    assert len(some[0]) == 3
    # history names must remap onto snapshot names (trail seeding joins
    # on name, app/static/js/fallback2d.js)
    snap_names = {b["name"] for b in snapshot["bodies"]}
    assert set(history) <= snap_names

    # the module chain is served: entry module + the 2D fallback it
    # dynamically imports when the three.js CDN is unreachable
    main_js = c.get("/static/js/main.js")
    assert main_js.status_code == 200
    body = main_js.get_data(as_text=True)
    assert "fallback2d.js" in body, "main.js lost its zero-egress fallback"
    fb = c.get("/static/js/fallback2d.js")
    assert fb.status_code == 200
    assert "startFallback" in fb.get_data(as_text=True)
    # path traversal must stay blocked by the shim's static view
    evil = c.get("/static/../app.py")
    assert evil.status_code in (403, 404)


def test_cluster_snapshot_latency_and_memory_bound_65536(cluster_client):
    """Long-uptime soak bound: at SIM_N=65536 the
    per-tick snapshot path must stay cheap, and the trail history must be
    the FIXED preallocated float32 ring — no per-tick allocation growth
    (the old per-body Python-list dict cost ~40x the bytes in object
    headers and trimmed 300-point lists under the engine lock every
    tick). Swaps a synthetic 65k state into the cluster runtime so the
    host-path cost is measured without stepping 65k bodies on CI CPUs."""
    import time
    import types

    import numpy as np

    c, mod = cluster_client
    n, n_view, cap = 65536, 2000, 300
    rng = np.random.default_rng(0)
    state = types.SimpleNamespace(
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        pos_lo=None, time=np.float32(1.0))
    view = np.linspace(0, n - 1, n_view, dtype=np.int64)
    saved_cl, saved_n = mod._cl, mod.SIM_N
    mod.SIM_N = n
    mod._cl = dict(saved_cl, state=state, view=view,
                   names=[f"b{int(i):06d}" for i in view],
                   hist_buf=np.zeros((n_view, cap, 3), np.float32),
                   hist_len=0, hist_head=0)
    try:
        mod.build_cluster_snapshot()  # warm
        t0 = time.perf_counter()
        for _ in range(5):
            snap = mod.build_cluster_snapshot()
        per_tick = (time.perf_counter() - t0) / 5
        assert len(snap["bodies"]) == n_view
        assert snap["scene"]["n_total"] == n
        # generous 1-core CI budget; measured ~2-5 ms (soak note, DESIGN)
        assert per_tick < 0.25, f"snapshot took {per_tick * 1e3:.1f} ms"
        # memory bound: the history IS the preallocated ring, exactly
        assert mod._cl["hist_buf"].nbytes == n_view * cap * 3 * 4
        # soak past the ring capacity: head wraps, length saturates, the
        # buffer object is never reallocated
        buf_id = id(mod._cl["hist_buf"])
        for _ in range(cap + 60):
            mod.build_cluster_snapshot()
        assert mod._cl["hist_len"] == cap
        assert id(mod._cl["hist_buf"]) == buf_id
        # the bootstrap page reconstructs ordered trails from the ring
        r = c.get("/")
        assert r.status_code == 200
    finally:
        mod._cl, mod.SIM_N = saved_cl, saved_n
