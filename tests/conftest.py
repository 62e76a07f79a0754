import numpy as np
import pytest

import jax


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (long system/train integration)")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers",
        "compiled_lowering: exercises the region-blocked compiled "
        "lowering of the fused arena kernels (CI runs these under "
        "REPRO_ALLOC_LOWERING=blocked as a dedicated job)")
    config.addinivalue_line(
        "markers",
        "defrag: exercises the live defragmentation subsystem "
        "(core/defrag.py, kernels/defrag_txn.py, DESIGN.md §10; wired "
        "into the forced-blocked and nightly CI jobs)")
    config.addinivalue_line(
        "markers",
        "serve: exercises the serving engine's fused decode mega-step "
        "(serve/engine.py, DESIGN.md §11; the forced-blocked CI job "
        "runs the mega-vs-host parity suite under this marker)")
    config.addinivalue_line(
        "markers",
        "ft: exercises crash-safe serving — engine snapshot/restore, "
        "layout-fingerprint validation, and exhaustion eviction "
        "(DESIGN.md §12; the forced-blocked CI job runs this marker, "
        "and the nightly job adds a kill-and-resume smoke on "
        "launch/serve.py)")
    config.addinivalue_line(
        "markers",
        "replay: exercises the traffic-replay harness — seeded trace "
        "generation, client abandonment/cancellation, mega-vs-host "
        "parity, and the all-archs serving smoke (serve/replay.py, "
        "DESIGN.md §13; the forced-blocked CI job runs this marker, "
        "and the nightly job adds the two-scenario fig9 benchmark "
        "smoke)")
    config.addinivalue_line(
        "markers",
        "obs: exercises the observability layer — in-kernel allocator "
        "telemetry word parity across lowerings, the metrics registry "
        "and Prometheus exposition, and the engine trace spans "
        "(obs/, DESIGN.md §14; the forced-blocked CI job runs this "
        "marker, and the nightly job validates the replay-emitted "
        "trace + metrics artifacts with scripts/obs_dump.py)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
