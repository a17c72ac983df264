"""Seeding of the host RNGs (a copy of `efg_tpu/utils/seed.py`).

Only python `random` and numpy are seeded: the data pipeline draws from
them. The model's initial weights come from an explicit torch.Generator
(`engine/trainer.py`), so torch's global RNG is left alone.
"""

from __future__ import annotations

import os
import random
from datetime import datetime

import numpy as np


def seed_all_rng(seed: int | None = None) -> int:
    """Seed numpy + python random. With None, derive a fresh seed from time/pid."""
    if seed is None or seed < 0:
        seed = (
            os.getpid()
            + int(datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        ) % (2**31)
    np.random.seed(seed)
    random.seed(seed)
    return seed
