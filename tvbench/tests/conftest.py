"""CPU tests of the benchmark (tvbench/). Run from the repository root:

    python -m pytest tvbench/tests -q

They drive the cells at tiny sizes on the CPU (the port's plain
versions); the one test that needs a card decides so inside a fixture
and skips here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The first CUDA card, or a skip when this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return "cuda"


@pytest.fixture(autouse=True)
def _restore_environment():
    """A run sets the configuration's TVT_* knobs in os.environ; give
    every test the environment it started with."""
    import os

    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
    try:
        from thinvids_tpu_torch.core.config import get_settings
    except ImportError:
        return
    get_settings(refresh=True)
