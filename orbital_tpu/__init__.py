"""orbital-tpu: a JAX gravitational N-body framework for the GPU.

Rebuild of the capabilities of ``trevormcguire/orbital-physics`` as
accelerator array programs: Keplerian scene definition on host,
structure-of-arrays state in device memory, softened O(N^2) gravity as XLA
sweeps and a Pallas GPU kernel,
leapfrog (KDK) stepping under ``lax.scan``, masked collision handling,
vmappable ensembles, and shard_map ring sharding across chips.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .models.constants import (  # noqa: F401
    ASTRO,
    J2000_JD,
    STANDARD,
    IntegratorParams,
    UnitProfile,
    UnitSystem,
    get_unit_profile,
)
from .models.body import Body, System  # noqa: F401
from .models.datasets import solar_system, solar_system_v2  # noqa: F401
from .models.kepler import solve_kepler, state_to_elements  # noqa: F401
from .models.objects import (  # noqa: F401
    Coordinates,
    Object,
    ObjectCollection,
    collide_spheres,
    pairwise_accelerations,
    set_circular_orbit,
)
from .models.rigid import moment_of_inertia, random_angular_velocity  # noqa: F401
from .engine.state import NBodyState, Precision, Rescale, make_state  # noqa: F401
from .engine.rollout import (Trajectory, init_forces,  # noqa: F401
                             init_forces_staged, rollout, rollout_jit,
                             rollout_staged)
from .utils.config import SimConfig  # noqa: F401
from .simulate import SimResult, simulate  # noqa: F401

__all__ = [
    "__version__",
    "ASTRO", "J2000_JD", "STANDARD", "IntegratorParams", "UnitProfile",
    "UnitSystem", "get_unit_profile",
    "Body", "System", "solar_system", "solar_system_v2", "solve_kepler",
    "state_to_elements",
    "Coordinates", "Object", "ObjectCollection", "collide_spheres",
    "pairwise_accelerations", "set_circular_orbit",
    "moment_of_inertia", "random_angular_velocity",
    "NBodyState", "Precision", "Rescale", "make_state",
    "Trajectory", "init_forces", "init_forces_staged", "rollout",
    "rollout_jit", "rollout_staged", "SimConfig",
    "simulate", "SimResult", "SimulationEngine", "run_simulation",
    "pm_acc_potential", "p3m_acc_potential", "tree_acc_potential",
    "fit_initial_conditions", "fit_orbital_elements", "FitResult",
]


def __getattr__(name):
    # Lazy: the engine facade pulls in collision/viz machinery, the mesh
    # solvers are large-N specialty paths.
    if name in ("SimulationEngine", "run_simulation"):
        from .engine.engine import SimulationEngine, run_simulation

        return {"SimulationEngine": SimulationEngine, "run_simulation": run_simulation}[name]
    if name == "pm_acc_potential":
        from .ops.pm import pm_acc_potential

        return pm_acc_potential
    if name == "p3m_acc_potential":
        from .ops.p3m import p3m_acc_potential

        return p3m_acc_potential
    if name == "tree_acc_potential":
        from .ops.tree import tree_acc_potential

        return tree_acc_potential
    if name in ("fit_initial_conditions", "fit_orbital_elements",
                "FitResult"):
        from . import fitting

        return getattr(fitting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
