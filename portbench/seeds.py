"""Streams of random numbers derived from the run's ``--seed``."""
from __future__ import annotations

import hashlib


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from the run's seed
    (any whole number) and a stream name."""
    h = hashlib.sha256(repr((int(seed),) + tuple(str(p) for p in parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1
