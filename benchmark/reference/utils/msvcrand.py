"""MSVC CRT ``rand()`` replication.

The reference seeds its SSAO offset vectors and random-vector texture with
plain C ``rand()`` (never calling ``srand``, i.e. seed 1) via
``MathHelper::RandF`` (Common/MathHelper.h:17,
Ssao.cpp:352-461). Replicating the MSVC LCG lets the SSAO
randomness match the reference bit-for-bit, which makes golden-image
comparison against the D3D12 build meaningful.

MSVC LCG: state = state * 214013 + 2531011 (mod 2^32); rand() returns
(state >> 16) & 0x7fff. RAND_MAX = 32767.
"""
from __future__ import annotations

import numpy as np


class MsvcRand:
    RAND_MAX = 0x7FFF

    def __init__(self, seed: int = 1):
        self._state = np.uint32(seed)

    def rand(self) -> int:
        self._state = np.uint32(
            (np.uint64(self._state) * np.uint64(214013) + np.uint64(2531011))
            & np.uint64(0xFFFFFFFF)
        )
        return int((self._state >> np.uint32(16)) & np.uint32(0x7FFF))

    def randf(self) -> float:
        """MathHelper::RandF(): rand() / (float)RAND_MAX in [0, 1]."""
        return np.float32(self.rand()) / np.float32(self.RAND_MAX)

    def randf_range(self, a: float, b: float) -> float:
        """MathHelper::RandF(a, b): a + RandF() * (b - a)."""
        return float(np.float32(a) + self.randf() * np.float32(b - a))
