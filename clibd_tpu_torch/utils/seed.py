# A copy of clibd_tpu/utils/seed.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Seeding (reference util/util.py:129-138 set_seed)."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def set_seed(seed: Optional[int] = None) -> int:
    if seed is None:
        seed = random.randint(0, 1_000_000)
    random.seed(seed)
    np.random.seed(seed)
    return seed
