"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here --
smoke tests and benches must see the 1 real CPU device; only
launch/dryrun.py fakes 512 devices (and only in its own process)."""
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

try:                                   # pragma: no cover
    import hypothesis  # noqa: F401
except ImportError:
    # Hermetic containers lack hypothesis; install the deterministic
    # sampling shim so the property-test files still collect and run.
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_shim",
        os.path.join(os.path.dirname(__file__), "_hypothesis_shim.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    _mod.register()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def profile():
    """Baseline-hardware characterization profile (cached on disk because
    profiling is the paper's one-time cost)."""
    from repro.core.characterization import default_profile
    return default_profile()


@pytest.fixture(scope="session")
def mibench_runs():
    """(kernel, final_state, trace) for the five MiBench kernels."""
    from repro.apps import mibench
    out = []
    for k in mibench.all_kernels():
        final, trace = k.run()
        out.append((k, final, trace))
    return out


@pytest.fixture(scope="session")
def conv_runs():
    from repro.apps import conv
    out = []
    for k in conv.all_mappings():
        final, trace = k.run()
        out.append((k, final, trace))
    return out
