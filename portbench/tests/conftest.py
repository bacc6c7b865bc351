"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repository's root (the card-marked ones skip without a card)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on a host without one")
