"""Test harness: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without accelerators."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--run-gpu", action="store_true", default=False,
        help="run tests marked 'gpu' — they start a child process on the "
             "GPU (one process per card; never run two at once)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a child process on the GPU; needs --run-gpu")
    config.addinivalue_line(
        "markers", "neo4j: integration tests against a live Neo4j server; "
                   "set NEO4J_URI to enable")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-gpu"):
        return
    skip = pytest.mark.skip(reason="needs --run-gpu (a GPU, one process)")
    for item in items:
        if item.get_closest_marker("gpu") is not None:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def cpu_mesh():
    from vidgraph_tpu.parallel import host_cpu_mesh
    return host_cpu_mesh(8)
