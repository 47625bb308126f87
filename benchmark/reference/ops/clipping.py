"""Near-plane triangle clipping (torch counterpart of
``crychic_renderer_tpu.ops.clipping``).

D3D clips primitives against 0 <= z <= w in clip space; the consequential
plane for a renderer is the near plane z = 0. This module clips in
homogeneous clip space against z >= 0 with static shapes: every input
triangle yields exactly two output slots (main + extra), each valid or not:

  - all 3 vertices in front  -> (original, invalid)
  - 2 in front (quad case)   -> (tri A-B-J, tri A-J-I)
  - 1 in front               -> (tri A-I-K, invalid)
  - none                     -> (invalid, invalid)

Clipped vertices interpolate the full per-vertex record (clip position +
world-space attributes) linearly in clip space.
"""
from __future__ import annotations

import torch

from .consts import device_constant

# per inside-bitmask (bit i = vertex i inside): rotation r (new0 = old_r)
# and case id (0 drop, 1 one-inside, 2 two-inside, 3 keep)
_ROT = (0, 0, 1, 0, 2, 1, 1, 0)
_CASE = (0, 1, 1, 2, 1, 2, 2, 3)


def clip_near(tri_attr: torch.Tensor, valid_in: torch.Tensor):
    """tri_attr: (T, 3, C) with [..., :4] = clip-space position (z at
    index 2). valid_in: (T,) bool. Returns (out (2T, 3, C), valid (2T,)).
    """
    dev = tri_attr.device
    z = tri_attr[..., 2]
    inside = (z >= 0.0).long()
    bits = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
    rot = device_constant(_ROT, torch.int64, dev)[bits]
    case = device_constant(_CASE, torch.int64, dev)[bits]

    # rotate: new_i = old_(i + rot) % 3 (rolls: a list index is host data)
    r1 = torch.roll(tri_attr, -1, dims=1)
    r2 = torch.roll(tri_attr, -2, dims=1)
    rt = torch.where((rot == 1)[:, None, None], r1,
                     torch.where((rot == 2)[:, None, None], r2, tri_attr))
    A, B, C = rt[:, 0], rt[:, 1], rt[:, 2]
    zA, zB, zC = A[..., 2], B[..., 2], C[..., 2]

    def lerp(p, q, zp, zq):
        t = zp / torch.where(zp == zq, torch.ones_like(zp), zp - zq)
        return p + t[:, None] * (q - p)

    # two-inside (canonical: C out): crossings on A->C and B->C
    I = lerp(A, C, zA, zC)
    J = lerp(B, C, zB, zC)
    # one-inside (canonical: A in): crossings on A->B and A->C
    Ib = lerp(A, B, zA, zB)
    Kb = lerp(A, C, zA, zC)

    is_keep = (case == 3)[:, None, None]
    is_two = (case == 2)[:, None, None]

    main = torch.where(
        is_keep, rt,
        torch.where(is_two, torch.stack([A, B, J], dim=1),
                    torch.stack([A, Ib, Kb], dim=1)))
    extra = torch.stack([A, J, I], dim=1)

    valid_main = valid_in & (case != 0)
    valid_extra = valid_in & (case == 2)
    out = torch.cat([main, extra], dim=0)
    valid = torch.cat([valid_main, valid_extra], dim=0)
    return out, valid
