"""Chip tests: the compiled GPU kernels and paths, run on the card.

Unlike ``tests/conftest.py`` this does not force the CPU. Whether a GPU is
present is decided inside the ``gpu`` fixture, never at import, so every
worker collects the same tests; without a GPU each test skips with the
reason. Run them with ``python -m pytest gpu_tests/ -q`` on a machine with
a GPU (``chip_smoke.py`` runs them in its own process).
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.fixture(autouse=True)
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (default backend is "
                    f"{jax.default_backend()!r})")
