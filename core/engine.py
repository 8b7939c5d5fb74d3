"""Compat: reference core/engine.py surface — device-backed engine
(orbital_tpu.engine.engine)."""
from orbital_tpu.engine.engine import SimulationEngine, run_simulation  # noqa: F401
