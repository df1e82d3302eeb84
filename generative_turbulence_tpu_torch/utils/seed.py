"""Seed handling.

Copy of ``generative_turbulence_tpu/utils/seed.py``.  Seeds are stored and
passed as STRINGS at the config boundary because experiment trackers
float-mangle large integers; ``resolve_seed`` accepts strings, ints, or None
(fresh entropy) and returns a plain int.
"""

from __future__ import annotations

import secrets
from typing import Union


def resolve_seed(seed: Union[str, int, None]) -> int:
    if seed is None:
        return secrets.randbits(31)
    if isinstance(seed, str):
        seed = int(seed)
    return int(seed)


def seed_to_config_value(seed: int) -> str:
    return str(int(seed))
