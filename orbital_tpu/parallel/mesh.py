"""Device mesh helpers.

Single entry point for building 1D/2D meshes over whatever devices exist
(the GPUs of a host, or `--xla_force_host_platform_device_count` virtual
CPU devices in tests). The mesh follows the algorithm alone: every GPU of
a host reaches every other over NVLink at the same rate, so no topology
enters. Axis conventions for this framework:

  * ``body``     — bodies sharded across devices; forces run as a
                   ppermute ring (the ring-attention analog for O(N^2)
                   interactions; see SURVEY §5).
  * ``ensemble`` — independent perturbed systems (Monte-Carlo); pure data
                   parallelism, no collectives inside the step.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "BODY_AXIS", "ENSEMBLE_AXIS"]

BODY_AXIS = "body"
ENSEMBLE_AXIS = "ensemble"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (BODY_AXIS,),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh. Default: all devices on one ``body`` axis."""
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.array(devs[: int(np.prod(shape))]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))
