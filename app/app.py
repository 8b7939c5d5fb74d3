"""Live solar-system viewer service.

Same public surface as the reference app (reference: app/app.py): builds a
26-body solar system engine at module import, warms it up, advances it on a
background thread paced at ``SIM_FPS``, and serves

    GET /           bootstrap page (recent history + body snapshot)
    GET /api/state  current positions/properties as JSON (1 Hz polling)
    GET /health     k8s liveness/readiness probe

Differences (deliberate):
  * no unlocked shared mutation (the reference comments its lock out,
    app/app.py:104): the sim thread owns the engine and publishes an
    immutable JSON snapshot by reference swap after each step; request
    handlers never observe partial state. ``/`` takes the engine lock only
    to copy history.
  * restart can resume from the JSONL cache instead of re-warming
    (``RESUME_FROM_CACHE=true``) — the reference writes the cache but never
    reads it back.
  * stepping runs on the device engine (compiled KDK step per tick).

Env config (same names/defaults as the reference, app/app.py:69-76):
SIM_INTERVAL, SIM_INITIAL_STEPS, SIM_MAX_HISTORY, USE_CACHE, CACHE_FP,
CACHE_EVERY_N; plus SIM_FPS, SIM_MOONS, RESUME_FROM_CACHE.

Large-N demo mode (``SIM_SCENE=cluster``): instead of the 26-body solar
system, serve a live ``SIM_N``-body (default 65536) virialized cluster
advanced by the compiled rollout pipeline — the engine's actual regime.
Each wall tick runs ``SIM_STEPS_PER_TICK`` compiled KDK steps on device;
the browser receives a DECIMATED sample of ``SIM_VIEW_MAX`` bodies (the
full state never crosses to the host per tick beyond one sampled fetch)
through the same snapshot-swap machinery and unchanged viewer/API
payloads.
"""
from __future__ import annotations

import json
import os
import threading
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path

try:
    from app._compat import Flask, jsonify, render_template
except ImportError:  # running as a top-level module from the app/ dir
    from _compat import Flask, jsonify, render_template

from orbital_tpu.engine.engine import SimulationEngine, run_simulation
from orbital_tpu.models.constants import J2000_JD, JULIAN_DAY
from orbital_tpu.models.datasets import solar_system_v2
from orbital_tpu.models.objects import Coordinates, Object, ObjectCollection
from orbital_tpu.models.scene import compile_system

AU_METERS = 1.495978707e11
WORLD_SCALE = 1.0  # world units are meters; the viewer rescales client-side


def generate_solar_system(
    dt: float,
    max_hist: int | None = None,
    use_cache: bool = False,
    cache_fp: str | None = "solar_system_cache.jsonl",
    cache_every_n: int = 600,
    moons: bool = True,
) -> SimulationEngine:
    """Dataset -> Keplerian states (parent-composed) -> engine
    (reference: app/app.py:19-63)."""
    system = solar_system_v2(moons=moons)
    scene = compile_system(system, compose_parents=True)
    bodies = [
        Object(mass=float(scene.mass[i]), radius=float(scene.radius[i]),
               velocity=scene.vel[i], coordinates=Coordinates(*scene.pos[i]),
               name=scene.names[i])
        for i in range(scene.n)
    ]
    engine = SimulationEngine(
        ObjectCollection(bodies),
        dt=dt,
        softening=1e6,
        restitution=1.0,
        max_hist=max_hist,
        cache=use_cache,
        cache_fp=cache_fp or "solar_system_cache.jsonl",
        cache_every_n=cache_every_n,
    )
    engine.body_map = {b.name: b for b in system.bodies}
    engine.system = system
    return engine


_config_fp = Path(__file__).resolve().parent.parent / "config.json"
CONFIG = json.loads(_config_fp.read_text()) if _config_fp.exists() else {"version": "dev"}

INTERVAL = float(os.getenv("SIM_INTERVAL", 1800.0))
INITIAL_STEPS = int(os.getenv("SIM_INITIAL_STEPS", 5000))
MAX_HISTORY = int(os.getenv("SIM_MAX_HISTORY", 7000))
USE_CACHE = os.getenv("USE_CACHE", "false").lower() == "true"
CACHE_FP = os.getenv("CACHE_FP")
CACHE_EVERY_N = int(os.getenv("CACHE_EVERY_N", "600"))
SIM_FPS = float(os.getenv("SIM_FPS", "10.0"))
SIM_MOONS = os.getenv("SIM_MOONS", "true").lower() == "true"
RESUME_FROM_CACHE = os.getenv("RESUME_FROM_CACHE", "false").lower() == "true"
SIM_SCENE = os.getenv("SIM_SCENE", "sol")  # "sol" | "cluster"
SIM_N = int(os.getenv("SIM_N", "65536"))
SIM_VIEW_MAX = int(os.getenv("SIM_VIEW_MAX", "1500"))
SIM_STEPS_PER_TICK = int(os.getenv("SIM_STEPS_PER_TICK", "10"))
# cluster force family: "exact" (O(N^2) Pallas kernels, the default) or
# "tree" (multilevel multipole — the live 512k-1M regime; past the
# single-program compile limit the loop switches to rollout_staged)
SIM_FORCE = os.getenv("SIM_FORCE", "exact")
SIM_TREE_LEVELS = int(os.getenv("SIM_TREE_LEVELS", "0"))  # 0 = auto

engine = None
_cl = None  # cluster-mode runtime (dict), None in solar mode

if SIM_SCENE == "cluster":
    import numpy as np

    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import rollout

    _rng = np.random.default_rng(0)
    _pos = _rng.normal(size=(SIM_N, 3))
    _vel = _rng.normal(size=(SIM_N, 3)) * 0.6
    _mass = np.full(SIM_N, 1.0 / SIM_N)
    if SIM_FORCE == "tree":
        from orbital_tpu.ops.tree import tree_pairs_budgets

        _lv = SIM_TREE_LEVELS or (8 if SIM_N > 262144 else 7)
        _kch, _entries = tree_pairs_budgets(
            np.asarray(_pos, np.float32), levels=_lv)
        _cl_cfg = ot.SimConfig(
            dt=1e-3, G=1.0, eps2=1e-4, force_impl="tree",
            tree_levels=_lv, tree_near="pairs",
            tree_max_chunks=_kch, tree_pair_entries=_entries)
    else:
        _cl_cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4)
    # at levels=8 AND N >= 512k the staged host loop runs the tree (same
    # gate as simulate._STAGED_MIN_*)
    _cl_staged = (SIM_FORCE == "tree" and SIM_N >= 524288
                  and _cl_cfg.tree_levels >= 8)
    _state0 = ot.make_state(_pos, _vel, _mass, np.full(SIM_N, 1e-4),
                            precision="ds32")
    _cl_state = (ot.init_forces_staged(_state0, _cl_cfg) if _cl_staged
                 else ot.init_forces(_state0, _cl_cfg))
    _view_idx = np.linspace(0, SIM_N - 1, min(SIM_VIEW_MAX, SIM_N),
                            dtype=np.int64)
    # trail history: ONE preallocated float32 ring [n_view, cap, 3] —
    # a dict of per-body Python lists costs ~40x the bytes in object
    # headers and churns the allocator every tick; the ring bounds
    # long-uptime memory at n_view*cap*12 bytes exactly and makes the
    # per-tick append one vectorized row write (soak notes in DESIGN.md)
    _HIST_CAP = 300
    _cl = {
        "state": _cl_state, "cfg": _cl_cfg, "view": _view_idx,
        "names": [f"b{int(i):06d}" for i in _view_idx],
        "hist_buf": np.zeros((len(_view_idx), _HIST_CAP, 3), np.float32),
        "hist_len": 0, "hist_head": 0,
        "chunk": max(64, (1 << 27) // SIM_N),
        "staged": _cl_staged,
    }

    def _advance(k: int) -> None:
        if _cl["staged"]:
            from orbital_tpu.engine.rollout import rollout_staged

            _cl["state"], _, ovf = rollout_staged(_cl["state"],
                                                  _cl["cfg"], k)
            if ovf:
                print(f"WARNING: tree near-field overflow {ovf} "
                      "(budgets outgrown; restart to re-probe)")
        else:
            _cl["state"], _ = rollout(_cl["state"], _cl["cfg"], k)

    _cl["advance"] = _advance
    if INITIAL_STEPS > 0:
        print(f"Warming up {SIM_N}-body cluster...")
        done = 0
        while done < INITIAL_STEPS:
            k = min(_cl["chunk"], INITIAL_STEPS - done)
            _advance(k)
            done += k
        float(_cl["state"].time)
        print("Done.")
else:
    engine = generate_solar_system(
        dt=INTERVAL, max_hist=MAX_HISTORY, use_cache=USE_CACHE,
        cache_fp=CACHE_FP, cache_every_n=CACHE_EVERY_N, moons=SIM_MOONS,
    )
    epoch_ts = (J2000_JD - 2440587.5) * JULIAN_DAY  # seconds since Unix epoch
    engine.sim_epoch = datetime.fromtimestamp(epoch_ts, tz=timezone.utc)
    engine.sim_epoch_jd = float(J2000_JD)

    resumed = False
    if RESUME_FROM_CACHE and CACHE_FP and Path(CACHE_FP).exists():
        resumed = engine.resume_from_cache(CACHE_FP)
        print(f"Resumed from cache: {resumed} (t={engine.time_elapsed:.0f}s)")

    if not resumed and INITIAL_STEPS > 0:
        print("Warming up simulation...")
        run_simulation(engine, steps=INITIAL_STEPS,
                       print_every=max(1, INITIAL_STEPS // 10))
        print("Done.")

app = Flask(__name__)

STOP_SIMULATION = False
engine_lock = threading.Lock()


def _unwrap_unit(val):
    try:
        return float(val.value) if hasattr(val, "value") else float(val)
    except (TypeError, ValueError):
        return None


def build_cluster_snapshot() -> dict:
    """Decimated large-N snapshot: one sampled device->host fetch of the
    view subset, same payload field names as the solar snapshot so the
    viewer and /api/state consumers are unchanged."""
    import numpy as np

    state = _cl["state"]
    view = _cl["view"]
    pos = np.asarray(state.pos, np.float64)[view]
    if state.pos_lo is not None:
        pos = pos + np.asarray(state.pos_lo, np.float64)[view]
    t = float(state.time)
    mass = float(1.0 / SIM_N)
    # trail append: one vectorized ring-row write (bounded memory +
    # O(n_view) tick cost with no allocator churn — long-uptime soak)
    buf, head = _cl["hist_buf"], _cl["hist_head"]
    buf[:, head] = pos.astype(np.float32)
    _cl["hist_head"] = (head + 1) % buf.shape[1]
    _cl["hist_len"] = min(_cl["hist_len"] + 1, buf.shape[1])
    names = _cl["names"]
    bodies = []
    for k in range(len(view)):
        name = names[k]
        bodies.append({
            "id": name,
            "name": name,
            "mass_kg": mass,
            "radius_km": 1.0,
            "T_seconds": None,
            "fg_ms2": None,
            "position": {"x": float(pos[k, 0]), "y": float(pos[k, 1]),
                         "z": float(pos[k, 2])},
        })
    return {
        "bodies": bodies,
        "mass_min": mass,
        "mass_max": mass,
        "radius_min": 1.0,
        "radius_max": 1.0,
        "time_elapsed": t,
        "sim_time_jd": float(J2000_JD) + t / JULIAN_DAY,
        "sim_time_iso": datetime.fromtimestamp(
            (J2000_JD - 2440587.5) * JULIAN_DAY,
            tz=timezone.utc).isoformat(),
        "scene": {"kind": "cluster", "n_total": SIM_N,
                  "n_view": int(len(view)),
                  "steps_per_tick": SIM_STEPS_PER_TICK},
    }


def build_snapshot() -> dict:
    """JSON state payload (same field names as the reference,
    app/app.py:117-168). Called only by the owner of the engine lock."""
    if _cl is not None:
        return build_cluster_snapshot()
    bodies, masses, radii_km = [], [], []
    body_map = getattr(engine, "body_map", {})
    for obj in engine.objects:
        pos_world = obj.position() * WORLD_SCALE
        r_km = float(obj.radius) / 1000.0
        kep = body_map.get(obj.name)
        bodies.append({
            "id": obj.uuid,
            "name": obj.name,
            "mass_kg": float(obj.mass),
            "radius_km": r_km,
            "T_seconds": _unwrap_unit(kep.T) if kep is not None else None,
            "fg_ms2": kep.fg if kep is not None else None,
            "position": {"x": float(pos_world[0]), "y": float(pos_world[1]),
                         "z": float(pos_world[2])},
        })
        masses.append(float(obj.mass))
        radii_km.append(r_km)
    masses = masses or [1.0]
    radii_km = radii_km or [1.0]
    sim_jd = engine.sim_epoch_jd + engine.time_elapsed / JULIAN_DAY
    sim_iso = (engine.sim_epoch + timedelta(seconds=engine.time_elapsed)).isoformat()
    return {
        "bodies": bodies,
        "mass_min": min(masses),
        "mass_max": max(masses),
        "radius_min": min(radii_km),
        "radius_max": max(radii_km),
        "time_elapsed": engine.time_elapsed,
        "sim_time_jd": sim_jd,
        "sim_time_iso": sim_iso,
    }


# the sim thread republishes this immutable snapshot after every step;
# handlers read the reference atomically (GIL) — no partial state visible
_snapshot: dict = build_snapshot()


def engine_loop() -> None:
    global _snapshot
    t_target = 1.0 / SIM_FPS
    while not STOP_SIMULATION:
        t0 = time.time()
        with engine_lock:
            if _cl is not None:
                _cl["advance"](SIM_STEPS_PER_TICK)
            else:
                engine.step()
            _snapshot = build_snapshot()
        time.sleep(max(0.0, t_target - (time.time() - t0)))


_thread = threading.Thread(target=engine_loop, daemon=True)
if os.getenv("SIM_DISABLE_THREAD", "false").lower() != "true":
    _thread.start()


@app.route("/")
def index():
    with engine_lock:
        if _cl is not None:
            # reconstruct ordered trails from the ring buffer (page loads
            # only — the per-tick path never builds Python lists)
            buf, L = _cl["hist_buf"], _cl["hist_len"]
            order = (np.arange(L) + _cl["hist_head"] - L) % buf.shape[1]
            world_hist = {n: buf[k, order].tolist()
                          for k, n in enumerate(_cl["names"])}
        else:
            raw_hist = engine.named_history(limit=5000)
            world_hist = {
                name: [[p[0] * WORLD_SCALE, p[1] * WORLD_SCALE,
                        p[2] * WORLD_SCALE] for p in pts]
                for name, pts in raw_hist.items()
            }
        snapshot = _snapshot
    return render_template(
        "index.html",
        initial_state=world_hist,
        bodies=snapshot,
        version=CONFIG["version"],
        system=SIM_SCENE,
    )


@app.route("/api/state")
def api_state():
    """Current positions & properties for all bodies (world units are
    meters; includes mass/radius extrema for client-side scaling)."""
    return jsonify(_snapshot)


@app.get("/health")
def health():
    """Kubernetes liveness/readiness probe endpoint."""
    return jsonify(status="ok"), 200


@app.post("/api/checkpoint")
def checkpoint():
    """Write a full-fidelity device-state checkpoint (new capability)."""
    path = os.getenv("CHECKPOINT_FP", "engine_checkpoint.npz")
    with engine_lock:
        if _cl is not None:
            from orbital_tpu.engine.checkpoint import save_state

            save_state(_cl["state"], path,
                       meta={"scene": "cluster", "n": SIM_N})
        else:
            engine.checkpoint(path)
    return jsonify(status="ok", path=path), 200
