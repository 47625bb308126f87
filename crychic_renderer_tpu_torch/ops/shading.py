"""Lighting math: Cook-Torrance GGX PBR, Schlick Fresnel, normal mapping,
tonemap (torch counterpart of ``crychic_renderer_tpu.ops.shading``).

Vectorized re-implementation of Shaders/PBR.hlsl and the lighting tails of
Default.hlsl / DeferredShading.hlsl. All functions operate on (..., 3)
pixel tensors.

Reference quirks replicated deliberately (for image parity):
- PBR.hlsl:58 assigns nDotv = hDotv, so the Fresnel term and the specular
  denominator both use h·v where n·v was intended.
- Only directional lights contribute in PBRShading (the point/spot loops'
  accumulations are commented out, PBR.hlsl:122,145); the Blinn-Phong
  ComputeLighting (LightingUtil.hlsl) evaluates directional, point and
  spot lights.
- Directional shadow factors enter as pow(shadow, 5) (PBR.hlsl:105).
- Direct light is tonemapped (x/(x+1), gamma 1/2.2) BEFORE ambient and sky
  reflection are added (Default.hlsl:167-179).
"""
from __future__ import annotations

import torch

PI = 3.1415926


def rowmat(v, M):
    """Row-vector transform ``v @ M`` (optionally batched over leading
    dims of either side) as a broadcast multiply + sum over the shared
    axis — the JAX package's summation form, so the port rounds the same
    products in the same order instead of handing K=3/4 to a GEMM."""
    return (v[..., :, None] * M).sum(dim=-2)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def normalize(v, eps=1e-20):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=eps)


def reflect(i, n):
    """HLSL reflect(i, n) = i - 2*dot(i,n)*n."""
    return i - 2.0 * (i * n).sum(-1, keepdim=True) * n


def schlick_fresnel(r0, normal, light_vec):
    """LightingUtil.hlsl:52-60 (used for the sky reflection)."""
    cos_t = saturate((normal * light_vec).sum(-1, keepdim=True))
    f0 = 1.0 - cos_t
    return r0 + (1.0 - r0) * f0 ** 5


def normal_sample_to_world(normal_sample, unit_normal_w, tangent_w):
    """Common.hlsl:112-128: TBN transform of a [0,1] normal map sample."""
    n_t = 2.0 * normal_sample - 1.0
    N = unit_normal_w
    T = normalize(tangent_w - (tangent_w * N).sum(-1, keepdim=True) * N)
    B = torch.linalg.cross(N, T, dim=-1)
    return n_t[..., 0:1] * T + n_t[..., 1:2] * B + n_t[..., 2:3] * N


# ---------------------------------------------------------------------------
# Cook-Torrance GGX (PBR.hlsl)
# ---------------------------------------------------------------------------

def _ndf_ggx(n_dot_h, a):
    a2 = a * a
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * d * d)


def _geometry_smith(n_dot_v, n_dot_l, roughness):
    k = 0.125 * (roughness + 1.0) ** 2
    g1 = n_dot_v / (n_dot_v * (1 - k) + k)
    g2 = n_dot_l / (n_dot_l * (1 - k) + k)
    return g1 * g2


def _fresnel_schlick(cos_t, f0):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - cos_t, 0.0, 1.0) ** 5


def pbr_brdf(normal, view, light_dir, albedo, roughness, metalness):
    """GetBRDF (PBR.hlsl:45-70) with GetPBRDesc's clamped dot products.

    All inputs (..., 3) / (..., 1). Returns ((..., 3) brdf, n·l).
    """
    half_vec = normalize(view + light_dir)
    h_dot_v = torch.clamp((half_vec * view).sum(-1, keepdim=True), min=0.001)
    n_dot_l = torch.clamp((normal * light_dir).sum(-1, keepdim=True),
                          min=0.001)
    n_dot_h = torch.clamp((normal * half_vec).sum(-1, keepdim=True),
                          min=0.001)
    f0 = 0.04 * (1.0 - metalness) + albedo * metalness

    D = _ndf_ggx(n_dot_h, roughness)
    # reference bug kept: nDotv := hDotv (PBR.hlsl:58)
    n_dot_v = h_dot_v
    F = _fresnel_schlick(n_dot_v, f0)
    G = _geometry_smith(
        torch.clamp((normal * view).sum(-1, keepdim=True), min=0.001),
        n_dot_l, roughness,
    )
    fs = 0.25 * D * G * F / (n_dot_l * n_dot_v)
    fd = albedo / PI
    ks = F
    kd = (1.0 - F) * (1.0 - metalness)
    return kd * fd + ks * fs, n_dot_l


def pbr_shading(lights, normal, view, pos_w, albedo, roughness, metalness,
                shadow_factor):
    """PBRShading (PBR.hlsl:91-149): directional lights only contribute.

    lights: anything with ``direction``/``strength`` (16, 3) tensors and a
    static ``num_dir`` (passes.frame._LightsView).
    shadow_factor: (..., 1) — applies to light 0 with pow 5.
    Returns (..., 3) direct light (pre-tonemap).
    """
    result = torch.zeros_like(albedo[..., :3])
    for i in range(lights.num_dir):
        light_dir = -lights.direction[i]
        brdf, n_dot_l = pbr_brdf(normal, view, light_dir, albedo[..., :3],
                                 roughness, metalness)
        irradiance = lights.strength[i] * n_dot_l
        sf = shadow_factor ** 5 if i == 0 else 1.0
        result = result + sf * brdf * irradiance
    return result


def tonemap_direct(direct):
    """Default.hlsl:167-168: x/(x+1) then gamma 1/2.2 on direct light only."""
    t = direct / (direct + 1.0)
    return torch.clamp(t, min=0.0) ** (1.0 / 2.2)


# ---------------------------------------------------------------------------
# Blinn-Phong (LightingUtil.hlsl) — the book's forward path
# ---------------------------------------------------------------------------

def _blinn_phong(light_strength, light_vec, normal, to_eye, diffuse_albedo,
                 fresnel_r0, shininess):
    m = shininess * 256.0
    half_vec = normalize(to_eye + light_vec)
    n_dot_h = torch.clamp((half_vec * normal).sum(-1, keepdim=True), min=0.0)
    roughness_factor = (m + 8.0) * n_dot_h ** m / 8.0
    fres = schlick_fresnel(fresnel_r0, half_vec, light_vec)
    spec = fres * roughness_factor
    spec = spec / (spec + 1.0)
    return (diffuse_albedo + spec) * light_strength


def _attenuation(d, falloff_start, falloff_end):
    return saturate((falloff_end - d) / (falloff_end - falloff_start))


def _local_light(lights, i, pos_w, normal):
    """Point/spot light i at the pixels: (unit light vector, distance,
    attenuated n.l strength, in-range mask as 0/1)."""
    lv = lights.position[i] - pos_w
    d = torch.sqrt((lv * lv).sum(-1, keepdim=True))
    lvn = lv / torch.clamp(d, min=1e-8)
    ndl = torch.clamp((normal * lvn).sum(-1, keepdim=True), min=0.0)
    strength = (lights.strength[i] * ndl
                * _attenuation(d, lights.falloff_start[i],
                               lights.falloff_end[i]))
    in_range = (d <= lights.falloff_end[i]).to(strength.dtype)
    return lvn, strength, in_range


def compute_lighting(lights, normal, to_eye, pos_w, diffuse_albedo,
                     fresnel_r0, shininess, shadow_factor, in_reach=None):
    """ComputeLighting (LightingUtil.hlsl:156-186): num_dir directional,
    then num_point point, then num_spot spot lights, the light index
    running on across the three loops; only light 0 takes the shadow
    factor, and a local light adds nothing past its falloff_end.

    lights: passes.frame._LightsView (the (16, ...) light tensors with
    static counts). in_reach (optional, (..., 1) float): each local
    light's in-range mask (1.0 within its falloff_end) is added to it in
    place. Returns (..., 3) direct light (pre-tonemap)."""
    result = torch.zeros_like(diffuse_albedo[..., :3])
    albedo = diffuse_albedo[..., :3]
    i = 0
    for _ in range(lights.num_dir):
        lv = -lights.direction[i]
        ndl = torch.clamp((normal * lv).sum(-1, keepdim=True), min=0.0)
        contrib = _blinn_phong(lights.strength[i] * ndl, lv, normal, to_eye,
                               albedo, fresnel_r0, shininess)
        sf = shadow_factor if i == 0 else 1.0
        result = result + sf * contrib
        i += 1
    for _ in range(lights.num_point):
        lvn, strength, in_range = _local_light(lights, i, pos_w, normal)
        contrib = _blinn_phong(strength, lvn, normal, to_eye, albedo,
                               fresnel_r0, shininess)
        result = result + in_range * contrib
        if in_reach is not None:
            in_reach.add_(in_range)
        i += 1
    for _ in range(lights.num_spot):
        lvn, strength, in_range = _local_light(lights, i, pos_w, normal)
        spot = torch.clamp((-lvn * lights.direction[i]).sum(
            -1, keepdim=True), min=0.0) ** lights.spot_power[i]
        contrib = _blinn_phong(strength * spot, lvn, normal, to_eye, albedo,
                               fresnel_r0, shininess)
        result = result + in_range * contrib
        if in_reach is not None:
            in_reach.add_(in_range)
        i += 1
    return result
