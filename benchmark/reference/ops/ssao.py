"""SSAO: 14-sample hemisphere occlusion at half resolution + edge-preserving
separable bilateral blur (torch counterpart of
``crychic_renderer_tpu.ops.ssao``).

Re-implements Shaders/Ssao.hlsl (view-ray reconstruction, random-vector
reflection, linear occlusion falloff, pow-6 sharpening) and SsaoBlur.hlsl
(radius-5 Gaussian, normal/depth edge stop, weight renormalization). The
host-side tables are numpy and equal the JAX package's bit for bit: the
14 offset vectors with MSVC-rand lengths (Ssao.cpp:423-461), the 256x256
random-vector texture (:352-421), the per-pixel random field and the
sigma-2.5 Gaussian weights (:37-68). There is no randomness at run time.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.msvcrand import MsvcRand
from .shading import rowmat


def build_offset_vectors() -> np.ndarray:
    """14 offsets: 8 cube corners + 6 face centers, random length
    [0.25, 1] from the MSVC rand stream (Ssao.cpp:423-461)."""
    base = np.array(
        [
            [+1, +1, +1], [-1, -1, -1], [-1, +1, +1], [+1, -1, -1],
            [+1, +1, -1], [-1, -1, +1], [-1, +1, -1], [+1, -1, +1],
            [-1, 0, 0], [+1, 0, 0], [0, -1, 0], [0, +1, 0],
            [0, 0, -1], [0, 0, +1],
        ],
        dtype=np.float32,
    )
    rnd = MsvcRand(seed=1)
    out = np.zeros((14, 3), np.float32)
    for i in range(14):
        s = rnd.randf_range(0.25, 1.0)
        v = base[i] / np.linalg.norm(base[i])
        out[i] = s * v
    return out


def build_random_vector_texture(size: int = 256, seed: int = 1,
                                skip_draws: int = 14) -> np.ndarray:
    """256^2 RGBA8-quantized random vectors in [0,1] (Ssao.cpp:352-421).

    The reference fills it from the same global MSVC rand stream right
    after the 14 offset-vector draws; XMCOLOR quantizes to 8 bits per
    channel. Evaluated exactly as the JAX package's native helper does
    (crychic_renderer_tpu/native/asset_pipeline.cpp msvc_random_texture):
    v = rand() * (1/32767) in f32, then roundf(v * 255) / 255 with halves
    rounded away from zero."""
    state = seed & 0xFFFFFFFF
    draws = np.empty(skip_draws + size * size * 3, np.int64)
    for i in range(draws.shape[0]):
        state = (state * 214013 + 2531011) & 0xFFFFFFFF
        draws[i] = (state >> 16) & 0x7FFF
    inv = np.float32(1.0) / np.float32(32767.0)
    v = draws[skip_draws:].astype(np.float32) * inv
    w = (v * np.float32(255.0)).astype(np.float64)  # exact widening
    fl = np.floor(w)
    rounded = (fl + (w - fl >= 0.5)).astype(np.float32)
    return (rounded / np.float32(255.0)).reshape(size, size, 3)


def calc_gauss_weights(sigma: float = 2.5) -> np.ndarray:
    """Ssao.cpp:37-68: normalized Gaussian, radius = ceil(2*sigma) = 5."""
    radius = int(np.ceil(2.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    w = np.exp(-x * x / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def build_random_field(tex: np.ndarray, h: int, w: int) -> np.ndarray:
    """Precompute the per-pixel random VECTORS for an (h, w) SSAO grid.

    The random-vector fetch (Ssao.hlsl:138: gRandomVecMap sampled with
    gsamLinearWrap at 4x-tiled screen uv) has frame-constant indices, so
    the whole field is built once: RGBA8 quantization of the texture, then
    BILINEAR filtering with WRAP addressing at u = 4*TexC, then the 2x-1
    decode."""
    t = np.asarray(tex, np.float32)
    q = np.floor(np.clip(t * 255.0 + 0.5, 0, 255)).astype(np.float32) / 255.0
    S = q.shape[0]
    U = ((np.arange(w, dtype=np.float32) + np.float32(0.5))
         / np.float32(w)).astype(np.float32)
    V = ((np.arange(h, dtype=np.float32) + np.float32(0.5))
         / np.float32(h)).astype(np.float32)
    x = U * np.float32(4.0) * np.float32(S) - np.float32(0.5)
    y = V * np.float32(4.0) * np.float32(S) - np.float32(0.5)
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0).astype(np.float32)[None, :, None]
    fy = (y - y0).astype(np.float32)[:, None, None]
    xa = x0.astype(np.int64) % S
    ya = y0.astype(np.int64) % S
    xb = (xa + 1) % S
    yb = (ya + 1) % S
    c00 = q[ya][:, xa]
    c10 = q[ya][:, xb]
    c01 = q[yb][:, xa]
    c11 = q[yb][:, xb]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    samp = top * (1 - fy) + bot * fy
    return (2.0 * samp - 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def ndc_depth_to_view(z_ndc, proj_22, proj_32):
    """Ssao.hlsl:110-115: viewZ = B / (z_ndc - A), A=proj[2][2], B=proj[3][2]."""
    return proj_32 / (z_ndc - proj_22)


def _quad_rows(depth_map: torch.Tensor):
    """(H, W) -> ((H*W, 4), W): each texel's 2x2 neighborhood as one row
    (the JAX package's layout; one row gather per bilinear tap)."""
    f = depth_map
    fx = torch.roll(f, -1, dims=1)
    fy = torch.roll(f, -1, dims=0)
    fxy = torch.roll(fx, -1, dims=0)
    rows = torch.stack([f.reshape(-1), fx.reshape(-1), fy.reshape(-1),
                        fxy.reshape(-1)], dim=-1)
    return rows, depth_map.shape[1]


def _pad_border_white(depth_map: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H+2, W+2): one texel of opaque-white border on every
    side, so the bilinear tap's border-white addressing is free."""
    return F.pad(depth_map, (1, 1, 1, 1), value=1.0)


def _tap_depth_bilinear_white(rows, H, W, u, v):
    """One gsamDepthMap tap (MIN_MAG_MIP_LINEAR, ADDRESS_BORDER,
    OPAQUE_WHITE): bilinear depth with off-screen texels reading 1.0.

    rows: quad rows of the PADDED map; H, W: the UNPADDED map size; u, v in
    [0,1] texture space."""
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0, -2.0 ** 30, 2.0 ** 30).long()
    y0i = torch.clamp(y0, -2.0 ** 30, 2.0 ** 30).long()
    # padded-map quad at (x0+1, y0+1) covers unpadded corners x0..x0+1
    xq = torch.clamp(x0i + 1, 0, W + 1)
    yq = torch.clamp(y0i + 1, 0, H + 1)
    q = rows[yq * (W + 2) + xq]  # (..., 4) — ONE row gather per tap
    top = q[..., 0] * (1 - fx) + q[..., 1] * fx
    bot = q[..., 2] * (1 - fx) + q[..., 3] * fx
    d = top * (1 - fy) + bot * fy
    far = (x0i < -1) | (x0i > W) | (y0i < -1) | (y0i > H)
    return torch.where(far, torch.ones_like(d), d)


def ssao_occlusion(normal_v, depth_ndc, proj, inv_proj, offsets,
                   random_field, occlusion_radius=0.5, fade_start=0.2,
                   fade_end=1.0, surface_eps=0.05, tap_depth=None,
                   row_offset: int = 0, full_height: int = None,
                   pixel_uv=None):
    """Half-res SSAO occlusion pass (Ssao.hlsl PS), random-field path.

    normal_v: (h, w, 3) view-space normals (half-res); depth_ndc: (h, w)
    main depth downsampled to half-res; proj/inv_proj: (4, 4) row-vector;
    offsets: (14, 3); random_field: (h, w, 3) precomputed random vectors.
    tap_depth: the FULL-RESOLUTION NDC depth the 14 occluder taps sample
    (bilinear, border white); None falls back to depth_ndc. Returns (h, w)
    ambient access in [0, 1].

    Band rendering (parallel.sharded): the inputs are rows [row_offset,
    row_offset + h) of a full_height-row map, so the view rays use global
    rows; random_field is the band's rows and tap_depth the whole screen's
    depth (the taps land anywhere on it).

    pixel_uv: optional (U, V), the texture-space uv of each evaluated
    pixel, for inputs whose array grid is not the pixel grid (the
    tile-compacted caller, passes.frame._ssao_occlusion_compacted, hands
    in (CB, LANES) tiles); normal_v, depth_ndc and random_field then share
    U's leading shape.
    """
    if tap_depth is None:
        tap_depth = depth_ndc
    A22, B32 = proj[2, 2], proj[3, 2]
    dev = depth_ndc.device

    if pixel_uv is not None:
        U, V = pixel_uv
    else:
        h, w = depth_ndc.shape
        if full_height is None:
            full_height = h
        # view-space ray through each pixel (quad corners -> inv proj)
        uu = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        vv = (torch.arange(h, dtype=torch.float32, device=dev) + row_offset
              + 0.5) / full_height
        U, V = torch.meshgrid(uu, vv, indexing="xy")  # both (h, w)
    ndc = torch.stack([2 * U - 1, 1 - 2 * V, torch.zeros_like(U),
                       torch.ones_like(U)], dim=-1)
    ph = rowmat(ndc, inv_proj)
    pos_v_ray = ph[..., :3] / ph[..., 3:4]

    pz = ndc_depth_to_view(depth_ndc, A22, B32)
    p = (pz / pos_v_ray[..., 2])[..., None] * pos_v_ray
    rand_vec = random_field

    n = normal_v / torch.clamp(
        torch.sqrt((normal_v ** 2).sum(-1, keepdim=True)), min=1e-8)

    occlusion_sum = torch.zeros_like(pz)
    fade_len = fade_end - fade_start
    tap_rows, _ = _quad_rows(_pad_border_white(tap_depth))
    th, tw = tap_depth.shape
    for i in range(offsets.shape[0]):
        off = offsets[i]
        # reflect(offset, randVec) = off - 2*dot(off, rv)*rv
        refl = off - 2.0 * (rand_vec * off).sum(-1, keepdim=True) * rand_vec
        flip = torch.sign((refl * n).sum(-1, keepdim=True))
        q = p + flip * occlusion_radius * refl
        # project q with proj, into texture space (u = x*0.5+0.5, v flip)
        qh = rowmat(torch.cat([q, torch.ones_like(q[..., :1])], -1), proj)
        qn = qh[..., :3] / torch.clamp(qh[..., 3:4], min=1e-8)
        qu = qn[..., 0] * 0.5 + 0.5
        qv = -qn[..., 1] * 0.5 + 0.5
        rz_ndc = _tap_depth_bilinear_white(tap_rows, th, tw, qu, qv)
        rz = ndc_depth_to_view(rz_ndc, A22, B32)
        qz = q[..., 2]
        r = (rz / torch.where(qz == 0, torch.full_like(qz, 1e-8), qz)
             )[..., None] * q
        dist_z = p[..., 2] - r[..., 2]
        rp = r - p
        dp = torch.clamp(
            (n * rp).sum(-1)
            / torch.clamp(torch.sqrt((rp ** 2).sum(-1)), min=1e-8), min=0.0)
        occ = torch.where(dist_z > surface_eps,
                          torch.clamp((fade_end - dist_z) / fade_len,
                                      0.0, 1.0),
                          torch.zeros_like(dist_z))
        occlusion_sum = occlusion_sum + dp * occ

    access = 1.0 - occlusion_sum / offsets.shape[0]
    return torch.clamp(access, 0.0, 1.0) ** 6


def bilateral_blur(ambient, normal_v, depth_view, weights, horizontal: bool,
                   border_depth_view=None):
    """SsaoBlur.hlsl PS: radius-5 separable Gaussian with edge stopping
    (reject neighbor if dot(normals) < 0.8 or |view depth diff| > 0.2),
    renormalized by accepted weight.

    border_depth_view: the view depth a neighbor tap reads PAST the screen
    edge (gsamDepthMap's opaque-white border -> the far plane); ambient and
    normals use pointClamp (edge clamp). None keeps clamp-to-edge depth.
    """
    radius = (weights.shape[0] - 1) // 2
    axis = 1 if horizontal else 0
    acc = weights[radius] * ambient
    total = torch.zeros_like(ambient) + weights[radius]
    n_c = normal_v
    d_c = depth_view
    n = ambient.shape[axis]
    idx = torch.arange(n, device=ambient.device)
    for i in range(-radius, radius + 1):
        if i == 0:
            continue
        a_n = _shift_clamp(ambient, i, axis)
        n_n = _shift_clamp(normal_v, i, axis)
        d_n = _shift_clamp(depth_view, i, axis)
        if border_depth_view is not None:
            off = (idx + i < 0) | (idx + i >= n)
            off = off[:, None] if axis == 0 else off[None, :]
            d_n = torch.where(off, border_depth_view, d_n)
        ok = (((n_n * n_c).sum(-1) >= 0.8)
              & (torch.abs(d_n - d_c) <= 0.2)).to(ambient.dtype)
        wgt = weights[i + radius] * ok
        acc = acc + wgt * a_n
        total = total + wgt
    return acc / total


def _shift_clamp(img, offset, axis):
    """Shift with clamp-to-edge (the blur samples with pointClamp)."""
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + offset, 0, n - 1)
    return torch.index_select(img, axis, idx)
