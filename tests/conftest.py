"""Test configuration: force a virtual 8-device CPU mesh.

The reference's test harness runs vertices on a simulated IPUModel when no
hardware is present (reference: include/ipu/ipu_utils.hpp:98-106). Our
equivalent: JAX CPU backend with 8 virtual devices so sharding/collective
paths are exercised without a GPU. The rasterizer kernels run in the Pallas
interpreter on the CPU (render/kernels/__init__.py picks that build for the
"cpu" platform). The platform is pinned after importing jax, before any
backend initialises, so the suite runs on the CPU even on a GPU machine.

Tests marked `gpu` need the card; they skip here (from inside the test,
through the `gpu_device` fixture). A run whose `-m` expression selects
them and no unmarked test keeps the default platform instead, so on a GPU
machine `python -m pytest tests/ -m gpu -p no:cacheprovider` runs them
on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402
from _pytest.mark.expression import Expression  # noqa: E402

from gaussian_splat_ipu_tpu.runtime import engine  # noqa: E402


def _gpu_run(markexpr: str) -> bool:
    """True when `-m markexpr` selects gpu-marked tests and no unmarked
    one."""
    if not markexpr:
        return False
    expr = Expression.compile(markexpr)
    return (expr.evaluate(lambda name, **kw: name == "gpu")
            and not expr.evaluate(lambda name, **kw: False))


def pytest_configure(config):
    # Runs before any test module is imported, so before any backend
    # initialises.
    if not _gpu_run(config.getoption("markexpr")):
        jax.config.update("jax_platforms", "cpu")
        assert jax.default_backend() == "cpu"
        assert len(jax.devices()) == 8
    # Persistent XLA compile cache ($JAX_COMPILATION_CACHE_DIR, else the
    # checkout's .jax_cache): the suite's cost is dominated by CPU
    # compiles of the sharded/binning programs; repeat runs hit the cache.
    # Keyed by HLO + config hash, so code changes re-compile correctly.
    engine.enable_compilation_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


@pytest.fixture
def gpu_device():
    """The GPU for tests marked `gpu`; skips when the run has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with -m gpu on a GPU machine")
    return jax.devices()[0]
