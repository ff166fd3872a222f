import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny(tmp_path):
    """(root, bench) of the tiny copy of the benchmark."""
    from benchmark.tests.tiny import make_tiny

    return make_tiny(tmp_path)


@pytest.fixture
def cuda():
    """Skips a test that needs the card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
