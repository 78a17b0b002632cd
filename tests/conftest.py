"""Test configuration: run all tests on a virtual 8-device CPU mesh with
float64 enabled, so numerical-parity assertions against the scipy oracle are
exact and sharding tests exercise multi-device code paths without GPUs.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# NO persistent compilation cache on CPU: this jaxlib's XLA:CPU AOT
# serialization records compile-machine features (+prefer-no-gather, ...)
# that the host loader can reject — small entries reload with a SIGILL
# warning, large ones (scan bodies) can segfault on deserialize or
# CHECK-fail on serialize.  Cold compiles cost ~2x suite time but cannot
# crash the process.  The GPU programs (bench.py, chip_smoke.py) cache
# through lagrangiancoherence_tpu.utils.runtime.


def pytest_collection_modifyitems(config, items):
    """Mark the measured-slow tests (call time >= 20 s on the 8-device
    CPU mesh, tests/slow_tests.txt — regenerate from
    ``pytest --durations=0``) so build sessions can iterate on a quick
    tier with ``-m "not slow"`` (~5 min) while the full suite stays
    canonical.  Unmatched stale entries are ignored."""
    import os

    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            slow = {ln.strip() for ln in f if ln.strip()}
    except OSError:
        return
    import pytest as _pytest
    for item in items:
        nodeid = item.nodeid.replace("\\", "/")
        if nodeid in slow or f"tests/{nodeid}" in slow:
            item.add_marker(_pytest.mark.slow)
