"""Drop-in compatibility package: the reference's ``core.*`` import layout
backed by orbital-tpu.

Existing user code written against ``trevormcguire/orbital-physics``
(``from core.engine import SimulationEngine`` etc.) runs unchanged on the
device engine. New code should import from ``orbital_tpu`` directly.
"""
