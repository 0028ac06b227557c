"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding logic is exercised without an accelerator
(``chip_smoke.py`` checks the GPU path on the card)."""

import os

# Must be set before jax import anywhere in the test process.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_INPUTS = "/root/reference/inputs"

# Two test tiers (the full suite can exceed 30 min under host load,
# and a suite nobody runs stops being run):
#   quick: pytest -m "not slow"   (~5 min target on this machine)
#   full:  pytest                 (~15-30 min, load-dependent)
# Modules here are mesh-heavy (8-device shard_map compiles), spawn
# subprocesses, or compile dozens of jit variants; everything they
# guard also has thin coverage in the quick tier (test_seg_scan,
# test_gnn, test_native).
_SLOW_MODULES = {
    "test_ops",
    "test_shard_ell",
    "test_parallel",
    "test_multiprocess",
    "test_dp_saint",
    "test_bench_harness",
    "test_reference_parity",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.fspath.purebasename in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


def fixture_path(name: str) -> str:
    return os.path.join(REFERENCE_INPUTS, name)


@pytest.fixture(scope="session")
def citeseer():
    from graphaibench_tpu.graph.io import load_graph
    return load_graph(fixture_path("citeseer"), with_vlabels=True)


@pytest.fixture(scope="session")
def cora():
    from graphaibench_tpu.graph.io import load_graph
    return load_graph(fixture_path("cora"), with_vlabels=True)


@pytest.fixture(scope="session")
def tester():
    from graphaibench_tpu.graph.io import load_graph
    return load_graph(fixture_path("tester"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
