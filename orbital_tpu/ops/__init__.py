"""Device compute kernels: pairwise gravity (XLA and the Pallas GPU kernel),
collision resolution, Kepler solver, and conservation diagnostics."""
from . import collisions, diagnostics, forces  # noqa: F401
