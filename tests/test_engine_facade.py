"""SimulationEngine facade: reference-parity stepping, history, JSONL cache,
checkpoint/resume, diagnostics, merge pruning."""
import json

import numpy as np
import pytest

from orbital_tpu import SimulationEngine, run_simulation
from orbital_tpu.models.objects import (
    Coordinates,
    Object,
    ObjectCollection,
    set_circular_orbit,
)


@pytest.fixture
def em_engine(tmp_path):
    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
               coordinates=Coordinates(0, 0, 0), name="earth")
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
               coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    set_circular_orbit(a, b)
    return SimulationEngine(
        ObjectCollection([a, b]), dt=3600.0, softening=1e3,
        cache=True, cache_fp=str(tmp_path / "h.jsonl"), cache_every_n=100,
        max_hist=None,
    )


def test_step_matches_reference_engine(em_engine, reference):
    ref = reference["core.physics"]
    reng = reference["core.engine"]
    objs = []
    for o in em_engine.objects:
        r = ref.Object(o.mass, o.radius, velocity=np.zeros(3),
                       coordinates=ref.Coordinates(*o.position()))
        r.velocity = np.asarray(o.velocity, np.float64).copy()
        objs.append(r)
    eng_ref = reng.SimulationEngine(ref.ObjectCollection(objs), dt=3600.0,
                                    softening=1e3, cache=False, max_hist=None)
    for _ in range(10):
        em_engine.step()
        eng_ref.step()
    for ours, theirs in zip(em_engine.objects, eng_ref.objects):
        np.testing.assert_allclose(ours.position(), theirs.position(), atol=1e-6)
        np.testing.assert_allclose(ours.velocity, theirs.velocity, atol=1e-12)
    assert em_engine.total_energy() == pytest.approx(eng_ref.total_energy(), rel=1e-12)
    np.testing.assert_allclose(em_engine.angular_momentum(),
                               eng_ref.angular_momentum(), rtol=1e-12)


def test_run_equals_stepping(em_engine):
    import copy

    run_engine = em_engine
    pos_step = None
    # run(50) in one compiled rollout
    run_engine.run(50)
    pos_run = [o.position().copy() for o in run_engine.objects]
    hist_run = {k: list(v) for k, v in run_engine.named_history().items()}

    # fresh engine, 50 individual steps
    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
               coordinates=Coordinates(0, 0, 0), name="earth")
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
               coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    set_circular_orbit(a, b)
    eng2 = SimulationEngine(ObjectCollection([a, b]), dt=3600.0,
                            softening=1e3, cache=False, max_hist=None)
    for _ in range(50):
        eng2.step()
    pos_step = [o.position().copy() for o in eng2.objects]
    np.testing.assert_allclose(pos_run, pos_step, rtol=1e-14)
    assert len(hist_run["moon"]) == 51  # seeded + 50
    np.testing.assert_allclose(hist_run["moon"],
                               eng2.named_history()["moon"], rtol=1e-14)
    assert run_engine.step_idx == 50
    assert run_engine.time_elapsed == pytest.approx(50 * 3600.0)


def test_history_ring_buffer(em_engine):
    em_engine.max_hist = 10
    em_engine.run(30)
    for o in em_engine.objects:
        assert len(em_engine.history[o.uuid]) == 10
    # unlimited modes
    em_engine.max_hist = None
    em_engine.run(5)
    assert len(em_engine.history[em_engine.objects[0].uuid]) == 15


def test_jsonl_cache_schema(em_engine, tmp_path):
    em_engine.run(250)
    frames = [json.loads(line) for line in open(em_engine.cache_fp)]
    assert len(frames) == 3  # steps 0, 100, 200
    f = frames[-1]
    assert set(f) == {"time_elapsed", "objects", "history"}
    # reference frame-timestamp convention: a frame written after
    # step k carries t = k*dt (core/engine.py:94-97)
    assert f["time_elapsed"] == pytest.approx(200 * 3600.0)
    assert {o["uuid"] for o in f["objects"]} == {o.uuid for o in em_engine.objects}
    assert set(f["history"]) == {"earth", "moon"}
    assert len(f["history"]["moon"]) == 1


def test_checkpoint_roundtrip(em_engine, tmp_path):
    em_engine.run(20)
    ck = tmp_path / "state.npz"
    em_engine.checkpoint(ck)
    pos_before = [o.position().copy() for o in em_engine.objects]
    t_before = em_engine.time_elapsed
    em_engine.run(50)
    em_engine.resume(ck)
    np.testing.assert_allclose([o.position() for o in em_engine.objects], pos_before)
    assert em_engine.time_elapsed == t_before
    # resuming then running gives the same future
    em_engine.run(10)
    pos_a = [o.position().copy() for o in em_engine.objects]
    em_engine.resume(ck)
    em_engine.run(10)
    np.testing.assert_allclose([o.position() for o in em_engine.objects], pos_a)


def test_resume_from_jsonl_cache(em_engine):
    em_engine.run(150)
    t = em_engine.time_elapsed
    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
               coordinates=Coordinates(0, 0, 0), name="earth")
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
               coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    eng2 = SimulationEngine(ObjectCollection([a, b]), dt=3600.0, softening=1e3,
                            cache=False)
    assert eng2.resume_from_cache(em_engine.cache_fp)
    # resumed from the last cached frame (step 100), not the live state
    assert eng2.time_elapsed == pytest.approx(100 * 3600.0)
    assert t > eng2.time_elapsed
    names = {o.name for o in eng2.objects}
    assert names == {"earth", "moon"}


def test_merge_prunes_objects():
    a = Object(6.0, 1.0, velocity=np.array([1.0, 0, 0]),
               coordinates=Coordinates(0, 0, 0), name="big")
    b = Object(3.0, 1.0, velocity=np.array([-1.0, 0, 0]),
               coordinates=Coordinates(5.0, 0, 0), name="small")
    eng = SimulationEngine(ObjectCollection([a, b]), dt=0.05,
                           merge_on_capture=True, cache=False, max_hist=None,
                           precision="f64")
    eng.run(200)
    assert len(eng.objects) == 1
    assert eng.objects[0].name == "big"
    assert eng.objects[0].mass == pytest.approx(9.0)
    np.testing.assert_allclose(eng.objects[0].velocity, [(6 - 3) / 9.0, 0, 0],
                               atol=1e-12)


def test_run_simulation_prints_drift(em_engine, capsys):
    run_simulation(em_engine, 100, print_every=50)
    out = capsys.readouterr().out
    assert "dE=" in out and "dL=" in out
    assert out.count("step ") == 2


def test_cache_fp_validation():
    a = Object(1.0, 1.0, velocity=np.zeros(3), coordinates=Coordinates(0, 0, 0))
    with pytest.raises(ValueError):
        SimulationEngine(ObjectCollection([a]), cache_fp="frames.json")


def test_metrics_recorder(em_engine):
    from orbital_tpu.utils.metrics import MetricsRecorder

    emitted = []
    rec = MetricsRecorder.start(em_engine, emit=emitted.append)
    em_engine.run(100)
    w = rec.record(em_engine)
    em_engine.run(50)
    rec.record(em_engine)
    assert len(rec.windows) == 2 and emitted == rec.windows
    assert w.step == 100 and rec.windows[1].step == 150
    assert w.n_alive == 2 and w.n_merged == 0
    assert abs(w.dE_rel) < 1e-4 and w.dL_rel < 1e-12
    assert w.steps_per_s > 0
    import json

    assert json.loads(w.to_json())["step"] == 100


def test_checkpoint_orbax_directory(em_engine, tmp_path):
    pytest.importorskip("orbax.checkpoint")
    em_engine.run(10)
    ck = tmp_path / "orbax_ck"
    em_engine.checkpoint(ck)
    pos_before = [o.position().copy() for o in em_engine.objects]
    em_engine.run(20)
    em_engine.resume(ck)
    np.testing.assert_allclose([o.position() for o in em_engine.objects],
                               pos_before)


def test_astro_unit_profile_engine():
    # a two-body system specified in ASTRO units (AU, M_sun, day)
    import orbital_tpu as ot

    sun = Object(1.0, 0.00465, velocity=np.zeros(3),
                 coordinates=Coordinates(0, 0, 0), name="sun",
                 unit_profile=ot.ASTRO)
    planet = Object(3e-6, 4.26e-5, velocity=np.zeros(3),
                    coordinates=Coordinates(1.0, 0, 0), name="planet",
                    unit_profile=ot.ASTRO)
    set_circular_orbit(sun, planet, unit_profile=ot.ASTRO)
    eng = SimulationEngine(ObjectCollection([sun, planet]), dt=1.0,
                           softening=1e-6, cache=False, max_hist=None,
                           unit_profile=ot.ASTRO, precision="f64")
    E0 = eng.total_energy()
    eng.run(365)
    # one year later the planet is back near its start
    assert np.linalg.norm(planet.position() - np.array([1.0, 0, 0])) < 0.05
    assert abs((eng.total_energy() - E0) / E0) < 1e-8


def test_simulate_one_call():
    import orbital_tpu as ot

    result = ot.simulate(ot.solar_system_v2(moons=False), steps=365,
                         dt=86400.0, softening=1e6)
    assert result.pos.shape[1:] == (15, 3)
    assert result.names[0] == "Sol"
    assert result.time[-1] == pytest.approx(365 * 86400.0)
    # Mercury's (omega dt)^2 leapfrog oscillation dominates at dt = 1 day
    assert result.energy_drift < 1e-4
    # Earth swept ~a full revolution
    ei = result.names.index("Earth")
    ang = np.unwrap(np.arctan2(result.pos[:, ei, 1], result.pos[:, ei, 0]))
    assert 5.9 < abs(ang[-1] - ang[0]) < 6.6


def test_simulate_from_objects():
    import orbital_tpu as ot

    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
               coordinates=Coordinates(0, 0, 0), name="earth")
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
               coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    set_circular_orbit(a, b)
    result = ot.simulate([a, b], steps=200, dt=3600.0, record_every=20,
                         integrator="rk4")
    assert result.pos.shape == (10, 2, 3)
    assert result.energy_drift < 1e-9


@pytest.mark.slow
def test_resume_from_cache_post_merge(tmp_path):
    """A cache written after merges holds fewer bodies; resuming must
    re-resolve the compiled force/step fns for the new N and keep stepping."""
    a = Object(6.0, 1.0, velocity=np.array([1.0, 0, 0]),
               coordinates=Coordinates(0, 0, 0), name="big")
    b = Object(3.0, 1.0, velocity=np.array([-1.0, 0, 0]),
               coordinates=Coordinates(5.0, 0, 0), name="small")
    c = Object(0.5, 0.1, velocity=np.zeros(3),
               coordinates=Coordinates(0, 50.0, 0), name="far")
    eng = SimulationEngine(ObjectCollection([a, b, c]), dt=0.05,
                           merge_on_capture=True, max_hist=None,
                           cache=True, cache_fp=str(tmp_path / "m.jsonl"),
                           cache_every_n=10, precision="f64")
    eng.run(200)
    assert len(eng.objects) == 2  # big+small merged, far survives

    a2 = Object(6.0, 1.0, velocity=np.array([1.0, 0, 0]),
                coordinates=Coordinates(0, 0, 0), name="big")
    b2 = Object(3.0, 1.0, velocity=np.array([-1.0, 0, 0]),
                coordinates=Coordinates(5.0, 0, 0), name="small")
    c2 = Object(0.5, 0.1, velocity=np.zeros(3),
                coordinates=Coordinates(0, 50.0, 0), name="far")
    eng2 = SimulationEngine(ObjectCollection([a2, b2, c2]), dt=0.05,
                            merge_on_capture=True, cache=False,
                            max_hist=None, precision="f64",
                            rescale=eng.rescale)
    assert eng2.resume_from_cache(eng.cache_fp)
    assert eng2.state.n_bodies == 2  # post-merge frame
    # the restored engine must be steppable at the new N (stale compiled
    # fns for N=3 would shape-error here)
    eng2.step()
    eng2.run(20)
    assert np.isfinite(np.asarray(eng2.state.pos)).all()


def test_resume_rejects_mismatched_dt_and_rescale(em_engine, tmp_path):
    ck = tmp_path / "s.npz"
    em_engine.run(5)
    em_engine.checkpoint(ck)
    # dt mismatch
    a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
               coordinates=Coordinates(0, 0, 0), name="earth")
    b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
               coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    set_circular_orbit(a, b)
    eng_dt = SimulationEngine(ObjectCollection([a, b]), dt=1800.0,
                              softening=1e3, cache=False, max_hist=None)
    with pytest.raises(ValueError, match="dt"):
        eng_dt.resume(ck)
    # rescale mismatch
    from orbital_tpu.engine.state import Rescale
    a2 = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
                coordinates=Coordinates(0, 0, 0), name="earth")
    b2 = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
                coordinates=Coordinates(3.844e8, 0, 0), name="moon")
    set_circular_orbit(a2, b2)
    eng_rs = SimulationEngine(ObjectCollection([a2, b2]), dt=3600.0,
                              softening=1e3, cache=False, max_hist=None,
                              precision="ds32",
                              rescale=Rescale(length=2.0, mass=3.0, time=5.0))
    with pytest.raises(ValueError, match="rescale"):
        eng_rs.resume(ck)


def test_history_stride_and_windowing(tmp_path):
    """history_every=k records every k-th step in run(); the windowed path
    is step-exact on the final state regardless of window splits."""
    def fresh(history_every):
        a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
                   coordinates=Coordinates(0, 0, 0), name="earth")
        b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
                   coordinates=Coordinates(3.844e8, 0, 0), name="moon")
        set_circular_orbit(a, b)
        return SimulationEngine(ObjectCollection([a, b]), dt=3600.0,
                                softening=1e3, cache=False, max_hist=None,
                                history_every=history_every)

    e1 = fresh(1)
    e5 = fresh(5)
    e1.run(50)
    e5.run(50)
    assert len(e1.history[e1.objects[0].uuid]) == 51   # seed + 50
    assert len(e5.history[e5.objects[0].uuid]) == 11   # seed + 10
    # strided entries match the dense ones at the same steps
    h1 = np.asarray(e1.history[e1.objects[1].uuid])    # [51, 3]
    h5 = np.asarray(e5.history[e5.objects[1].uuid])    # [11, 3]
    np.testing.assert_allclose(h5[1:], h1[5::5], rtol=1e-14)
    np.testing.assert_allclose(
        [o.position() for o in e1.objects],
        [o.position() for o in e5.objects], rtol=1e-14)

    # tiny windows force multi-window execution; result must be identical
    e_w = fresh(1)
    e_w._WINDOW_FLOAT_BUDGET = 6 * 2 * 3  # one record per window
    e_w.run(50)
    np.testing.assert_allclose(
        [o.position() for o in e_w.objects],
        [o.position() for o in e1.objects], rtol=1e-14)
    np.testing.assert_allclose(np.asarray(e_w.history[e_w.objects[0].uuid]),
                               np.asarray(h1 := np.asarray(
                                   e1.history[e1.objects[0].uuid])), rtol=1e-14)


def test_history_records_per_step_alive(tmp_path):
    """A body merged away mid-run stops accruing history at its merge
    record, not retroactively (per-record alive masks)."""
    a = Object(6.0, 1.0, velocity=np.array([1.0, 0, 0]),
               coordinates=Coordinates(0, 0, 0), name="big")
    b = Object(3.0, 1.0, velocity=np.array([-1.0, 0, 0]),
               coordinates=Coordinates(5.0, 0, 0), name="small")
    c = Object(0.5, 0.1, velocity=np.zeros(3),
               coordinates=Coordinates(0, 50.0, 0), name="far")
    coll = ObjectCollection([a, b, c])
    uuid_small = b.uuid
    eng = SimulationEngine(coll, dt=0.05, merge_on_capture=True,
                           cache=False, max_hist=None, precision="f64")
    eng.run(200)
    n_small = len(eng.history[uuid_small])
    n_far = len(eng.history[eng.objects[-1].uuid])
    assert 1 < n_small < n_far == 201


def test_history_stride_phase_survives_frame_segmentation(tmp_path):
    """Frame-boundary segmentation must not shift or drop strided history
    records (review finding: per-segment phase reset could record nothing
    when cache_every_n < stride)."""
    def fresh(cache, cache_every_n=5):
        a = Object(5.972e24, 6.371e6, velocity=np.zeros(3),
                   coordinates=Coordinates(0, 0, 0), name="earth")
        b = Object(7.348e22, 1.737e6, velocity=np.zeros(3),
                   coordinates=Coordinates(3.844e8, 0, 0), name="moon")
        set_circular_orbit(a, b)
        return SimulationEngine(
            ObjectCollection([a, b]), dt=3600.0, softening=1e3,
            cache=cache, cache_fp=str(tmp_path / "p.jsonl"),
            cache_every_n=cache_every_n, max_hist=None, history_every=7)

    e_framed = fresh(cache=True)     # segments of 5 < stride of 7
    e_plain = fresh(cache=False)
    e_framed.run(50)
    e_plain.run(50)
    h_f = np.asarray(e_framed.history[e_framed.objects[1].uuid])
    h_p = np.asarray(e_plain.history[e_plain.objects[1].uuid])
    assert h_f.shape == h_p.shape == (8, 3)  # seed + records at 7,14,...,49
    np.testing.assert_allclose(h_f, h_p, rtol=1e-14)


def test_nonfused_force_impls_keep_collisions(tmp_path):
    """force_impl without a fused-detect variant must stay on the chosen
    kernel with the unconditional sweep — not silently swap to dense, not
    raise (review findings on resolve_force_detect_fn)."""
    from orbital_tpu.engine.rollout import resolve_force_detect_fn
    from orbital_tpu.utils.config import SimConfig as SC

    for impl in ("mxu", "pm", "ring"):
        cfg = SC(dt=1e-3, G=1.0, eps2=1e-4, collisions="bounce",
                 force_impl=impl)
        assert resolve_force_detect_fn(cfg, 256) is None

    # end-to-end: a bouncing pair under pm forces (unfused sweep path)
    import orbital_tpu as ot
    from orbital_tpu.engine.state import make_state

    pos = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, 5.0, 0], [0, -5.0, 0]])
    vel = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0, 0], [0, 0, 0]])
    mass = np.array([1.0, 1.0, 1e-3, 1e-3])
    radius = np.array([0.3, 0.3, 0.01, 0.01])
    cfg = ot.SimConfig(dt=0.05, G=1e-4, eps2=0.25, collisions="bounce",
                       restitution=0.8, force_impl="pm", pm_grid=32)
    st = ot.init_forces(make_state(pos, vel, mass, radius, precision="f32"),
                        cfg)
    fin, _ = ot.rollout_jit(st, cfg, 80)
    assert np.isfinite(np.asarray(fin.pos)).all()
    assert float(np.asarray(fin.vel)[0, 0]) < 0  # the pair bounced


def test_hermite_rejects_pm():
    import orbital_tpu as ot
    from orbital_tpu.engine.rollout import resolve_accel_jerk_fn

    cfg = ot.SimConfig(dt=1e-3, G=1.0, eps2=1e-4, integrator="hermite",
                       force_impl="pm")
    with pytest.raises(ValueError, match="hermite"):
        resolve_accel_jerk_fn(cfg, 256)
