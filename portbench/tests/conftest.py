"""Shared fixtures of the benchmark's tests: the checkout's root on the
path, the ``chip`` marker, and the small copy of the benchmark."""

import sys

import pytest

from portbench_small import ROOT, make_small

for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def chip():
    """Skip unless a CUDA device is there (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """The small copy, its generated data cached in a directory of its
    own."""
    from portbench.harness import store
    store.CACHE_DIR = tmp_path_factory.mktemp("portbench_cache")
    return make_small(tmp_path_factory.mktemp("portbench_small"))
