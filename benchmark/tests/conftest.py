"""The benchmark's tests: the `card` fixture (test sizes are in `sizes.py`).

Run with `python3 -m pytest benchmark/tests -q`; the cases marked `cuda`
need a card and skip without one.
"""

from __future__ import annotations

import pytest


@pytest.fixture
def card():
    """Skip unless a CUDA card is present, decided inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
