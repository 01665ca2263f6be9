import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running smoke tests (excluded from the fast CI lane "
        "via -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "requires_accelerator: compiled-mode (non-interpret) kernel tests; "
        "auto-skipped when no TPU/GPU is present so the CPU CI lane stays "
        "green while the suite runs unchanged on real hardware")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's CUDA kernels have no CPU "
        "mode); the test skips itself when torch sees no card")


def pytest_collection_modifyitems(config, items):
    marked = [it for it in items
              if it.get_closest_marker("requires_accelerator")]
    if not marked:
        return
    from repro.kernels import default_interpret
    if default_interpret():
        skip = pytest.mark.skip(
            reason="no TPU/GPU: compiled Pallas mode unavailable")
        for it in marked:
            it.add_marker(skip)
