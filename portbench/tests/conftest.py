"""portbench's own tests: `python3 -m pytest portbench/tests -q` from the
repository's root.  They import neither JAX nor the JAX package.  Tests
marked `card` need a CUDA device and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
