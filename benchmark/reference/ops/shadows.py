"""Cascaded shadow lookup: cascade selection by view distance, the 16-tap
rotated-Poisson PCF with a bilinear comparison sampler, cross-cascade
blend (torch counterpart of ``crychic_renderer_tpu.ops.shadows``).

Re-implements Shaders/Common.hlsl:135-316 and the cascade-selection loop of
DeferredShading.hlsl:53-76. The shadow sampler is D3D comparison
LESS_EQUAL with linear filtering and OPAQUE_BLACK border
(CRYCHIC.cpp:2649-2658).

The reference's Poisson radius compiles to 0 (``5 / width / 2.0f`` is an
int/uint division, Common.hlsl:301 — see the JAX package's
``compiled_poisson_radius_uv``), so its 16-tap PCF is ONE bilinear
comparison tap. The port evaluates that tap from 16-bit-quantized 2x2 quad
rows, as the JAX package does: the u16 quantization changes pixels, so it
is carried over. ``pcf_radius_texels`` (2.5) restores the intended soft
disk; its 16 taps run in the CUDA kernel of ``ops.pcf`` (plain PyTorch on
the CPU) over the same 16-bit depths, in one window-ready buffer that
holds every receiver's superwindow as a 16x16 rectangle
(``ops.pcf.quantize_map``). The cascade-parity table split, the
per-receiver superwindow tables and the gather spread masks of the JAX
package only move gather indices and are left out.

Deferred-path quirk replicated: the blend condition
``abs(distance - radius[j] < 5.0f)`` (DeferredShading.hlsl:60) casts the
comparison to bool before abs, so the deferred shader ALWAYS blends
cascades j and j+1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.cascades import CASCADE_RADII
from . import pcf
from .pcf import N_SAMPLE, POISSON_DISK, nrand  # noqa: F401 (as in JAX)
from .shading import rowmat


def _quad_rows_from_u16(qi: torch.Tensor) -> torch.Tensor:
    """(C, S, S) integer 16-bit depth values -> (C*(S+2)^2, 2) int64 quad
    rows: for every texel of the zero-PADDED map (1-texel border of depth
    0 = the gsamShadow OPAQUE_BLACK border), its 2x2 neighborhood packed as
    two x-pair lanes [t00|t10<<16, t01|t11<<16]. The words are the JAX
    package's uint32 values, held in int64 so no shift overflows."""
    qi = qi.to(torch.int64)
    p = F.pad(qi, (1, 1, 1, 1))
    x1 = F.pad(p[:, :, 1:], (0, 1))
    top = p | (x1 << 16)
    y1 = F.pad(top[:, 1:, :], (0, 0, 0, 1))
    return torch.stack([top, y1], dim=-1).reshape(-1, 2)


def quad_maps_u16(shadow_maps: torch.Tensor) -> torch.Tensor:
    """(C, S, S) f32 depth -> (C*(S+2)^2, 2) quad rows of 16-bit UNORM
    depth (round(clip(d, 0, 1) * 65535)). Maps that are the int16 bits of
    ops.pcf.quantize_bits already (the band frame's u16-packed atlas) are
    read as they are, as the JAX package's quad_from_packed reads
    them."""
    if shadow_maps.dtype == torch.int16:
        return _quad_rows_from_u16(shadow_maps.to(torch.int64) & 0xFFFF)
    q = torch.round(torch.clamp(shadow_maps, 0.0, 1.0) * 65535.0)
    return _quad_rows_from_u16(q)


def pcf_single_tap(qrows: torch.Tensor, cascade: torch.Tensor,
                   shadow_pos: torch.Tensor, smap_size: int) -> torch.Tensor:
    """One bilinear comparison tap from the quad rows — the compiled
    reference's ENTIRE Poisson PCF. The receiver compares in 16-bit steps,
    depth*65535 - 0.5 <= texel; the black border reads depth 0, and a
    receiver whose quad lies fully outside the padded ring reads 0."""
    S = smap_size
    P = S + 2
    inv_w = 1.0 / torch.clamp(shadow_pos[..., 3], min=1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    u, v, depth = uvz[..., 0], uvz[..., 1], uvz[..., 2]
    cx = u * S - 0.5
    cy = v * S - 0.5
    # floor, saturated far outside the map (an out-of-range float -> int
    # cast is undefined in torch); such receivers read 0 either way
    x0 = torch.clamp(torch.floor(cx), -2.0 ** 30, 2.0 ** 30).long()
    y0 = torch.clamp(torch.floor(cy), -2.0 ** 30, 2.0 ** 30).long()
    fx = cx - x0.to(torch.float32)
    fy = cy - y0.to(torch.float32)
    xq = torch.clamp(x0 + 1, 0, P - 1)
    yq = torch.clamp(y0 + 1, 0, P - 1)
    row = qrows[(cascade * P + yq) * P + xq]  # (..., 2) — ONE gather
    dq = depth * 65535.0 - 0.5

    def lit_of(word, shift):
        texel = ((word >> shift) & 0xFFFF).to(torch.float32)
        return (dq <= texel).to(torch.float32)

    c00 = lit_of(row[..., 0], 0)
    c10 = lit_of(row[..., 0], 16)
    c01 = lit_of(row[..., 1], 0)
    c11 = lit_of(row[..., 1], 16)
    lit = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    far = (x0 < -1) | (x0 > S - 1) | (y0 < -1) | (y0 > S - 1)
    return torch.where(far, torch.zeros_like(lit), lit)


def cascade_select(shadow_transforms, pos_w, eye_pos):
    """Per-receiver cascade selection (DeferredShading.hlsl:53-76).

    Returns (dist (...,), no_shadow (...,) past the last cascade,
    cascades (..., 2) = (c, min(c + 1, 3)) with c the first cascade whose
    radius exceeds the view distance, and their shadow-space positions
    (..., 2, 4))."""
    dist = torch.sqrt(((eye_pos - pos_w) ** 2).sum(-1))
    # first cascade whose radius exceeds the distance; 4 = none (the radii
    # are scalars: a tensor of them would be a host-to-device copy, which
    # waits for the device)
    past = sum((dist >= r).to(torch.int64) for r in CASCADE_RADII)
    c = torch.clamp(past, 0, 3)
    no_shadow = past >= 4

    ph = torch.cat([pos_w, torch.ones_like(pos_w[..., :1])], dim=-1)
    # project by ALL cascades and select per pixel with a one-hot sum
    # (the JAX package's form: the selected row is summed with exact zeros)
    all_pos = torch.stack([rowmat(ph, shadow_transforms[ci])
                           for ci in range(4)])  # (4, ..., 4)
    arange4 = torch.arange(4, device=pos_w.device).reshape(
        (4,) + (1,) * (c.dim() + 1))

    def shadow_pos_for(cascade_idx):
        sel = (arange4 == cascade_idx[None, ..., None]).to(all_pos.dtype)
        return (all_pos * sel).sum(dim=0)

    c_next = torch.clamp(c + 1, max=3)
    cascades = torch.stack([c, c_next], dim=-1)
    shadow_pos = torch.stack([shadow_pos_for(c), shadow_pos_for(c_next)],
                             dim=-2)
    return dist, no_shadow, cascades, shadow_pos


def cascade_shadow_factor(shadow_maps, shadow_transforms, pos_w, eye_pos,
                          smap_size: int, deferred_blend_quirk: bool,
                          soft_radius_texels: float = None, dead=None):
    """Per-pixel cascade select + PCF + blend.

    shadow_maps: (4, S, S) depth; shadow_transforms: (4, 4, 4) row-vector
    world->uv/depth; pos_w: (..., 3); eye_pos: (3,). Deferred quirk:
    always blend cascades c and c+1 below the last. Distance >= 100 -> no
    shadow (factor 1); ``dead`` receivers (sky pixels) get 1.0.
    soft_radius_texels: None = the compiled reference's zero Poisson
    radius (one comparison tap); 2.5 = the intended soft disk, one launch
    of the ops.pcf kernel for both cascades of every receiver.
    """
    dist, no_shadow, cascades, shadow_pos = cascade_select(
        shadow_transforms, pos_w, eye_pos)
    c = cascades[..., 0]
    if soft_radius_texels is None:
        q = quad_maps_u16(shadow_maps)
        f_c = pcf_single_tap(q, c, shadow_pos[..., 0, :],
                             smap_size)
        f_n = pcf_single_tap(q, cascades[..., 1], shadow_pos[..., 1, :],
                             smap_size)
    else:
        params = pcf.receiver_params(shadow_pos.reshape(-1, 4),
                                     cascades.reshape(-1), smap_size)
        f = pcf.soft_pcf(pcf.quantize_map(shadow_maps), params,
                         float(soft_radius_texels)).reshape(cascades.shape)
        f_c, f_n = f[..., 0], f[..., 1]
    if deferred_blend_quirk:
        blend = c < 3
    else:
        radius = torch.full_like(dist, CASCADE_RADII[-1])
        for i in range(len(CASCADE_RADII) - 2, -1, -1):
            radius = torch.where(c == i, CASCADE_RADII[i], radius)
        blend = (c < 3) & (torch.abs(dist - radius) < 10.0)
    factor = torch.where(blend, 0.5 * (f_c + f_n), f_c)
    one = torch.ones_like(factor)
    if dead is not None:
        factor = torch.where(dead, one, factor)
    return torch.where(no_shadow, one, factor)
