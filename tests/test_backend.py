"""The one place that maps the platform to kernel choices, the options that
went with the removed kernels, and the compile-cache helper."""
import os

import pytest

import orbital_tpu as ot
from orbital_tpu.ops import backend
from orbital_tpu.parallel import sharded
from orbital_tpu.utils import runtime


@pytest.fixture
def on_platform(monkeypatch):
    """Pretend JAX's default backend is ``name``."""
    def set_platform(name):
        monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    return set_platform


@pytest.mark.parametrize("platform,n,want", [
    ("gpu", 65536, "pallas"), ("gpu", 4097, "pallas"), ("gpu", 4096, "dense"),
    ("cpu", 65536, "chunked"), ("cpu", 4096, "dense"), ("cpu", 128, "dense"),
])
def test_exact_sweep_choice(on_platform, platform, n, want):
    on_platform(platform)
    assert backend.platform() == platform
    assert backend.exact_sweep_impl(n) == want


def test_unknown_platform_is_an_error(on_platform):
    on_platform("metal")
    with pytest.raises(RuntimeError, match="no kernel choice"):
        backend.exact_sweep_impl(65536)


@pytest.mark.parametrize("platform,block,want", [
    ("gpu", 65536, "pallas"), ("cpu", 65536, "chunked"), ("gpu", 1024, "dense"),
])
def test_ring_block_follows_the_exact_sweep(on_platform, platform, block,
                                            want):
    """The ring never uses a dense [B, B] block past 4096 bodies a shard."""
    on_platform(platform)
    cfg = ot.SimConfig(dt=1.0, eps2=1e-4, shard_axis="body")
    assert sharded._ring_block_impl(cfg, block) == want
    # the vma checker is off exactly when the Pallas block kernel runs
    assert sharded._check_vma(cfg.replace(force_impl="ring"), 4 * block,
                              4) == (want != "pallas")


def test_auto_force_resolves_through_backend(on_platform):
    from orbital_tpu.engine.rollout import _exact_impl

    cfg = ot.SimConfig(dt=1.0, eps2=1e-4)
    on_platform("gpu")
    assert _exact_impl(cfg, 65536) == "pallas"
    on_platform("cpu")
    assert _exact_impl(cfg, 65536) == "chunked"
    assert _exact_impl(cfg.replace(force_impl="dense"), 65536) == "dense"


def test_kernel_platform_check(on_platform):
    """Kernels never pick the interpreter for themselves."""
    on_platform("cpu")
    with pytest.raises(RuntimeError, match="compiled for the GPU"):
        backend.check_kernel_platform(False)
    backend.check_kernel_platform(True)
    on_platform("gpu")
    backend.check_kernel_platform(False)


@pytest.mark.parametrize("kwargs,exc", [
    ({"force_impl": "pallas_sym"}, ValueError),
    ({"force_impl": "pallas_mxu"}, ValueError),
    ({"tree_near": "kernel"}, ValueError),
    ({"ring_block_impl": "mosaic"}, ValueError),
    ({"respa_impl": "pallas_sb"}, TypeError),
    ({"respa_wl_entries": 64}, TypeError),
    ({"tree_wl_entries": 64}, TypeError),
    ({"tree_wl_rj": 8}, TypeError),
])
def test_removed_options_are_rejected(kwargs, exc):
    with pytest.raises(exc):
        ot.SimConfig(dt=1.0, **kwargs)


def test_compile_cache_env_is_honoured(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, nothing is set in code."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
    with open(os.path.join(runtime.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
