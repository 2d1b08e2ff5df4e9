"""Test configuration: force a virtual 8-device CPU platform.

Multi-chip sharding is validated on a host-platform device mesh
(SURVEY.md §4: fake a multi-device mesh via XLA_FLAGS host device
count), so the suite runs identically with or without a GPU attached.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env vars)
import pytest  # noqa: E402

from procgen2_tpu.utils.cache import enable_compilation_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# Cold CPU compiles of the level generators take minutes per shape; the
# persistent cache (JAX_COMPILATION_CACHE_DIR, or .jax_cache in the
# checkout) makes re-runs seconds.
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices()
