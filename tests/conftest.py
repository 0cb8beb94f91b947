import os
import sys

# Tests run single-device (the 512-device dry-run sets XLA_FLAGS itself,
# in a subprocess — never here; see src/repro/launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The property tests use hypothesis; the container may not ship it.  Fall
# back to the deterministic stub (no pip installs at test time).
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub
    _hypothesis_stub.install()

import pytest


@pytest.fixture(autouse=True)
def _trace_contracts_checked():
    """Every test runs with the trace-contract checker armed: any
    ``cost_many``/``arch.cost`` call validates the block stream it consumes
    (monotonic instruction ids, carry chains, shapes, address bounds) for
    free — a malformed trace fails loudly instead of mis-costing."""
    from repro.analysis.contracts import checking
    with checking():
        yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skips on a machine without one")
