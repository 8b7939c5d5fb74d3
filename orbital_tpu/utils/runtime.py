"""Process set-up for the scripts that drive the GPU (bench, smoke test,
studies): the device check, the card's identity, the compile cache.

Nothing here runs at library import; scripts call it from ``main``.
"""
from __future__ import annotations

import os
import subprocess

__all__ = ["require_gpu", "card_info", "device_info", "setup_compile_cache",
           "REPO_ROOT"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def require_gpu():
    """Return the GPU devices, or raise: a measurement that finds no GPU
    fails instead of carrying on on the CPU."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError as e:
        raise RuntimeError(f"no GPU visible to JAX: {e}") from None
    if not devices or jax.default_backend() != "gpu":
        raise RuntimeError(
            f"no GPU visible to JAX (default backend "
            f"{jax.default_backend()!r})")
    return devices


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card, joined by ``; ``), or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def device_info() -> dict:
    """Platform, device kind and count, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed here. Otherwise the cache goes to ``.jax_cache``
    at the repository root (listed in ``.gitignore``): a fixed path, so a
    later process of the same checkout finds what an earlier one compiled.
    Returns the directory in use.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
