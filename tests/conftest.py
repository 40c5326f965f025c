"""Shared pytest config: the ``slow`` marker.

Tier-1 (``PYTHONPATH=src python -m pytest -x -q``) must finish in well under
two minutes, so anything heavier — full compile sweeps, long training runs —
is marked ``@pytest.mark.slow`` and only runs with ``--runslow``.
"""
import pytest


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked @pytest.mark.slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy test (compile sweep / long training), "
                   "skipped unless --runslow is given")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (a hand-written kernel has no "
                   "CPU mode); skipped where there is none")


@pytest.fixture
def runslow(request):
    """For runtime skips of heavy cases inside otherwise-fast parametrized
    tests (collection-time marks can't see the fixture parameter)."""
    return request.config.getoption("--runslow")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
