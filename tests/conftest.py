"""Test configuration. Unless JAX_PLATFORMS says otherwise, tests run on
the CPU with 8 virtual devices, so the multi-device paths run without
accelerators. Tests marked `gpu` need a GPU: they skip where JAX finds
none, and fail there when selected with `-m gpu`. Run them on a GPU host
with `JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist
tests/test_gpu.py`."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped where JAX finds none, unless selected"
    )


@pytest.fixture(scope="session")
def karate():
    from embiggen_tpu.graph import karate_club

    return karate_club()


@pytest.fixture(scope="session")
def ppi():
    from embiggen_tpu.graph import small_ppi

    return small_ppi()


@pytest.fixture(scope="session")
def er_graph():
    from embiggen_tpu.graph import erdos_renyi

    return erdos_renyi(200, 800, seed=7, weighted=True, n_edge_types=3, n_node_types=4)
