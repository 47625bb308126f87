"""G-buffer encode/decode in torch (the port's counterpart of
``crychic_renderer_tpu.ops.gbuffer``).

Explicit 4-MRT representation matching the reference's
Shaders/GBuffer.hlsl: GB0 = (posW, metalness), GB1 = (albedo,
roughness), GB2 = (normalW, 1), GB3 = 0 (:22-31); decode renormalizes the
normal (:33-43).

The frame (passes.frame.resolve_gbuffer) keeps these channels as a dict
and never materializes the MRTs; the explicit tensors are for tooling,
G-buffer dumps and image comparison against the reference's RGBA32F
targets.
"""
from __future__ import annotations

import torch


def encode(pos_w, metalness, albedo, roughness, normal_w):
    """-> (gb0, gb1, gb2, gb3), each (H, W, 4) float32."""
    gb0 = torch.cat([pos_w, metalness], dim=-1)
    gb1 = torch.cat([albedo[..., :3], roughness], dim=-1)
    gb2 = torch.cat([normal_w, torch.ones_like(metalness)], dim=-1)
    gb3 = torch.zeros_like(gb0)
    return gb0, gb1, gb2, gb3


def decode(gb0, gb1, gb2, gb3):
    """-> dict(pos_w, metalness, albedo, roughness, normal_w[normalized],
    shininess_alpha)."""
    n = gb2[..., :3]
    n = n / torch.clamp(torch.sqrt((n * n).sum(-1, keepdim=True)),
                        min=1e-20)
    return dict(
        pos_w=gb0[..., :3],
        metalness=gb0[..., 3:4],
        albedo=gb1[..., :3],
        roughness=gb1[..., 3:4],
        normal_w=n,
        shininess_alpha=gb2[..., 3:4],
    )


def from_resolve(g: dict):
    """Pack the frame's resolve output into the reference's MRTs."""
    return encode(g["pos_w"], g["metalness"], g["albedo"], g["roughness"],
                  g["normal_w"])
