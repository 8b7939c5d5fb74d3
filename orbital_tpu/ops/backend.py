"""The one place that maps the JAX platform to kernel choices.

``"auto"`` force paths ask here which exact-sweep implementation to run:

* ``"gpu"``: the Pallas kernel on the Triton route (``ops.pallas_forces``);
* ``"cpu"``: the row-chunked XLA sweep (``ops.forces``).

Any other platform is an error rather than a silent default. Kernels never
choose interpret mode for themselves: :func:`check_kernel_platform` refuses
to build a GPU kernel off the GPU unless the caller asked for the Pallas
interpreter, which only tests do (``INTERPRET`` below, set by the CPU test
suite's conftest).
"""
from __future__ import annotations

import jax

__all__ = ["platform", "exact_sweep_impl", "check_kernel_platform",
           "DENSE_MAX_N", "INTERPRET"]

# Up to this many bodies a dense [N, N] sweep is cheapest on every
# platform; above it the O(N) memory sweeps take over.
DENSE_MAX_N = 4096

_SWEEP_BY_PLATFORM = {"gpu": "pallas", "cpu": "chunked"}

# Whether explicitly requested GPU kernels run in the Pallas interpreter.
# Tests set it on the CPU; library code only reads it.
INTERPRET = False


def platform() -> str:
    """The default JAX platform, checked against the ones this package
    has paths for."""
    p = jax.default_backend()
    if p not in _SWEEP_BY_PLATFORM:
        raise RuntimeError(
            f"orbital_tpu has no kernel choice for platform {p!r} "
            f"(supported: {sorted(_SWEEP_BY_PLATFORM)})")
    return p


def exact_sweep_impl(n: int) -> str:
    """What ``force_impl="auto"`` means for an exact O(N^2) sweep over
    ``n`` bodies: ``"dense"`` up to :data:`DENSE_MAX_N`, then the GPU
    kernel (``"pallas"``) on the GPU or ``"chunked"`` on the CPU."""
    if n <= DENSE_MAX_N:
        return "dense"
    return _SWEEP_BY_PLATFORM[platform()]


def check_kernel_platform(interpret: bool) -> None:
    """Raise unless a GPU kernel can run here: compiled on the GPU, or in
    the Pallas interpreter when the caller asked for it."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "this Pallas kernel is compiled for the GPU (Triton route); on "
            f"platform {jax.default_backend()!r} use the chunked XLA path, "
            "or pass interpret=True to run it in the Pallas interpreter")
