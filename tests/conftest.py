"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, also pinned here before
any backend initializes); sharding code is validated on host-platform
virtual devices as ``__graft_entry__.dryrun_multichip`` does, and the Pallas
decode kernel runs in interpret mode. Tests that need a GPU carry the
``gpu`` marker and skip without one (tests/test_gpu_parity.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# Interpret-mode Pallas executables hold host callbacks, which the
# persistent compilation cache cannot serialize; the CPU suite recompiles
# cheaply, so it runs without the cache.
try:
    jax.config.update("jax_enable_compilation_cache", False)
except Exception:
    pass

import numpy as np
import pytest

# Modules that compile many interpret-mode Pallas programs. Hundreds of
# accumulated XLA:CPU executables in one long-lived process have crashed
# inside backend_compile before (docs/DESIGN.md §7); dropping them at each
# such module's boundary costs a few recompiles.
_CLEAR_CACHES_BEFORE = {
    "test_batch",
    "test_differential",  # ~50 random-geometry interpret-Pallas compiles
    "test_isolation",
    "test_mesh",
    "test_more_coverage",
    "test_pallas_codec",
    "test_robustness",
    "test_stream",
    "test_tiled",
}
_last_module = [None]


@pytest.fixture(autouse=True)
def _clear_caches_between_heavy_modules(request):
    mod = getattr(request.module, "__name__", "")
    if mod != _last_module[0]:
        _last_module[0] = mod
        if mod in _CLEAR_CACHES_BEFORE:
            jax.clear_caches()
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
