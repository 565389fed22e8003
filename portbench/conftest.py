"""pytest settings of the benchmark's tests (``portbench/tests``): the
checkout's root and ``src`` on the path, and the marker of the tests that
need a CUDA card, which decide inside the test whether one is there."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "portbench_chip: needs a CUDA card; skips without one (run on the "
        "card: python -m pytest -m portbench_chip portbench/tests)")


def pytest_runtest_setup(item):
    """One intra-op thread for the benchmark's tests, as the suite runs
    several test processes on few cores; restored after each test."""
    if "portbench" in str(item.fspath):
        import torch
        item._portbench_threads = torch.get_num_threads()
        torch.set_num_threads(1)


def pytest_runtest_teardown(item):
    n = getattr(item, "_portbench_threads", None)
    if n is not None:
        import torch
        torch.set_num_threads(n)
