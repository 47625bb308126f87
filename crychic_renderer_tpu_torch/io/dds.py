"""Texture asset helpers (host-side numpy).

Only the mip-chain generator is carried over so far: the pair pool build
(ops.sampling.PairPool.build) needs it for every texture, including the
white 1x1 fallback. The DDS/BMP decoders of ``crychic_renderer_tpu.io.dds``
are still to be ported; ``load_dds`` says so by name.
"""
from __future__ import annotations

import numpy as np


def generate_mips(base: np.ndarray) -> list:
    """Box-filter mip chain down to 1x1 (for textures shipped mipless)."""
    mips = [base]
    cur = base.astype(np.float32)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        cur2 = cur[: h * 2, : w * 2]
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = 0.25 * (cur2[0::2, 0::2] + cur2[1::2, 0::2]
                          + cur2[0::2, 1::2] + cur2[1::2, 1::2])
        elif cur.shape[0] > 1:
            cur = 0.5 * (cur2[0::2] + cur2[1::2])
        else:
            cur = 0.5 * (cur2[:, 0::2] + cur2[:, 1::2])
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


def load_dds(path: str):
    raise NotImplementedError(
        f"{path}: DDS decoding (io/dds.py load_dds) is not ported yet")
