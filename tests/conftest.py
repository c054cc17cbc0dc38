"""Test environment: force the virtual 8-device CPU mesh BEFORE jax backends
initialize.

Pallas kernels run in interpreter mode off-TPU (lightgrad_tpu.ops.runtime),
the analogue of the reference's POCL-on-CI trick (SURVEY.md §4): the full
kernel stack executes without physical TPU hardware.  Set
``LIGHTGRAD_TEST_TPU=1`` to run the same suite against a real attached TPU
instead (the env-var ``JAX_PLATFORMS`` is ignored by some TPU plugins, so we
use the config API).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate_timeout" not in _flags:
    # XLA:CPU in-process collectives SIGABRT ("rendezvous.cc Termination
    # timeout") when a virtual-device thread is starved >40 s -- routine on
    # this 1-core CI host under the heavier shard_map tests.  Raise the
    # limit; a genuinely hung rendezvous still aborts, just later.
    _flags += " --xla_cpu_collective_call_terminate_timeout_seconds=900"
os.environ["XLA_FLAGS"] = _flags

if os.environ.get("LIGHTGRAD_TEST_TPU") != "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (multi-minute interpret-mode workloads)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, skipped unless --runslow or LIGHTGRAD_RUN_SLOW=1")
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel; skips where no NVIDIA GPU is")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("LIGHTGRAD_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow: use --runslow (or LIGHTGRAD_RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
