"""Test configuration.

Tests run on CPU with 8 virtual devices so that multi-device sharding paths
compile and execute without accelerator hardware (SURVEY.md §4).  Must run
before the first ``import jax``.  The persistent compile cache stays off
(also for the subprocesses the tests start): parallel test workers would
otherwise all write into the one repo-level cache directory.
"""

import os
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "cpp", "build", "oracle")


def _ensure_native():
    if not os.path.exists(ORACLE):
        subprocess.run(["make", "-C", os.path.join(REPO, "cpp")], check=True)


_ensure_native()


@pytest.fixture(scope="session")
def oracle_path():
    return ORACLE
