"""Texture sampling: the (diffuse, normal) pair pool with dual-mip rows,
the anisotropic probe schedule, and the procedural sky (torch counterpart
of ``crychic_renderer_tpu.ops.sampling``).

Replaces the D3D12 sampler hardware used by the reference's shaders
(gsamAnisotropicWrap, static samplers at CRYCHIC.cpp:2601). The pool keeps
the JAX package's layout, because it changes pixels: one row carries the
2x2 bilinear quads of BOTH maps a G-buffer pixel samples, at mip m and
(dual rows) the mip-(m+1) quads of the parent texel, whose midpoint-parent
evaluation is an approximation the image depends on.

The host-side functions (``PairPool.build`` and its helpers, ``pack_cubemap``,
``procedural_sky_cubemap``) are the JAX package's numpy code. On the
device the RGBA8 words are held as int32 (the uint32 bits reinterpreted):
torch shifts are arithmetic, so every channel is masked after its shift.

Device functions: ``unpack_rgba8``, the analytic row addressing,
``sample_pair_bilinear`` (single-mip rows), ``sample_pair_dual``,
``class_lod``, ``sample_pair_trilinear``, ``lod_from_derivatives``,
``sample_pair_aniso`` (both pool layouts), the reference-quality
``sample_pair_aniso_ref``, ``sample_cubemap`` and ``procedural_sky_color``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .consts import device_constant

# Two-class pool geometry: "big" textures (material maps) are stored at
# POOL_SIZE^2 with full mip chains; "small" textures (the 64x64 animation
# frames) at POOL_SIZE_SMALL^2. Class membership is by index (big
# textures first), so per-pixel addressing stays fully ANALYTIC.
POOL_SIZE = 512
POOL_MIPS = 10  # 512 .. 1
POOL_SIZE_SMALL = 64
POOL_MIPS_SMALL = 7  # 64 .. 1


def _mip_offset(mip):
    """Flat texel offset of mip level `mip` within one big-class chain:
    sum_{k<m} (512>>k)^2 = (4^10 - 4^(10-m)) / 3."""
    return (1048576 - (1 << (20 - 2 * mip))) // 3


def _mip_offset_small(mip):
    """sum_{k<m} (64>>k)^2 = (4^7 - 4^(7-m)) / 3."""
    return (16384 - (1 << (14 - 2 * mip))) // 3


TEX_STRIDE = _mip_offset(POOL_MIPS)  # texels per big chain
TEX_STRIDE_SMALL = _mip_offset_small(POOL_MIPS_SMALL)


def _mip_offset_dyn(mip: torch.Tensor) -> torch.Tensor:
    return torch.div(1048576 - (torch.ones_like(mip) << (20 - 2 * mip)), 3,
                     rounding_mode="floor")


def _mip_offset_small_dyn(mip: torch.Tensor) -> torch.Tensor:
    return torch.div(16384 - (torch.ones_like(mip) << (14 - 2 * mip)), 3,
                     rounding_mode="floor")


def unpack_rgba8(packed: torch.Tensor) -> torch.Tensor:
    """(…,) int32 (RGBA8 bits) -> (…, 4) float32 in [0, 1]."""
    p = packed
    r = (p & 0xFF).to(torch.float32)
    g = ((p >> 8) & 0xFF).to(torch.float32)
    b = ((p >> 16) & 0xFF).to(torch.float32)
    a = ((p >> 24) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b, a], dim=-1) * (1.0 / 255.0)


PAIR_ROW = 8       # u32 lanes per single-mip pair row
PAIR_ROW_DUAL = 16  # u32 lanes per dual-mip pair row


@dataclasses.dataclass
class PairPool:
    """data: (rows, 8 | 16) — uint32 numpy on the host (``build``), the
    same bits as int32 on the device (DeviceScene.pair_data); pairs
    [0, n_big) are POOL_SIZE^2 chains of POOL_MIPS levels, the rest
    POOL_SIZE_SMALL^2 / POOL_MIPS_SMALL.

    Dual-mip rows (dual=True, lanes 8:16): the row for (pair, mip m, y, x)
    additionally carries the mip-(m+1) quads of parent texel (y>>1, x>>1)
    — [diff_m | nrm_m | diff_m+1 | nrm_m+1] — so a trilinear sample needs
    ONE row. The last level stores itself as parent (its blend weight is
    0)."""

    data: object
    n_big: int
    dual: bool = False

    @staticmethod
    def build(pair_chains, n_big: int, dual: bool = False) -> "PairPool":
        """pair_chains: list of (diffuse_mips, normal_mips) where each is a
        list of (H, W, 4) uint8 mip levels; pairs [0, n_big) are resampled
        to the big class, the rest to the small class."""
        chunks = []
        for pi, (dmips, nmips) in enumerate(pair_chains):
            size = POOL_SIZE if pi < n_big else POOL_SIZE_SMALL
            levels = POOL_MIPS if pi < n_big else POOL_MIPS_SMALL
            dchain = _resample_chain(dmips, size, levels)
            nchain = _resample_chain(nmips, size, levels)
            for level in range(levels):
                dq = _quad_pack_wrap(dchain[level])
                nq = _quad_pack_wrap(nchain[level])
                row = [dq.reshape(-1, 4), nq.reshape(-1, 4)]
                if dual:
                    lp = min(level + 1, levels - 1)
                    s = dchain[level].shape[0]
                    dp = _parent_quads(dchain[lp], s, level != lp)
                    npq = _parent_quads(nchain[lp], s, level != lp)
                    row += [dp.reshape(-1, 4), npq.reshape(-1, 4)]
                chunks.append(np.concatenate(row, axis=-1))
        data = np.concatenate(chunks, axis=0)
        return PairPool(data=data, n_big=int(n_big), dual=bool(dual))


def _parent_quads(parent_level: np.ndarray, child_size: int,
                  is_real_parent: bool) -> np.ndarray:
    """(S1, S1, 4) uint8 parent mip -> (child_size, child_size, 4) uint32:
    for each child texel (y, x), the parent's wrap-quad at (y>>1, x>>1).
    When the child is the last level the 'parent' is itself (quad
    repeated), kept only so the row layout is uniform."""
    q = _quad_pack_wrap(parent_level)  # (S1, S1, 4)
    if not is_real_parent:
        return q[:child_size, :child_size]
    return np.repeat(np.repeat(q, 2, axis=0), 2, axis=1)[:child_size,
                                                         :child_size]


def _resample_chain(mips, size: int, levels: int):
    """Resample a mip chain so level 0 is (size, size); regenerate the
    chain down to 1x1 by box filtering."""
    from ..io.dds import generate_mips

    img = mips[0]
    h, w = img.shape[:2]
    if (h, w) != (size, size):
        if h > size or w > size:  # downsample via mip chain
            chain0 = generate_mips(img)
            for m in chain0:
                if max(m.shape[:2]) <= size:
                    img = m
                    break
            h, w = img.shape[:2]
        ry = max(size // max(h, 1), 1)
        rx = max(size // max(w, 1), 1)
        img = np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)
        img = img[:size, :size]
        if img.shape[0] < size or img.shape[1] < size:
            img = np.pad(img, ((0, size - img.shape[0]),
                               (0, size - img.shape[1]),
                               (0, 0)), mode="edge")
    chain = generate_mips(img)[:levels]
    while len(chain) < levels:
        chain.append(chain[-1])
    return chain


def _quad_pack_wrap(m: np.ndarray) -> np.ndarray:
    """(S, S, 4) uint8 -> (S, S, 4) uint32: per texel, its WRAP-addressed
    2x2 neighborhood quad, each RGBA8-packed."""
    u = m.astype(np.uint32)
    packed = (u[..., 0] | (u[..., 1] << 8)
              | (u[..., 2] << 16) | (u[..., 3] << 24))
    xp = np.roll(packed, -1, axis=1)
    yp = np.roll(packed, -1, axis=0)
    xyp = np.roll(xp, -1, axis=0)
    return np.stack([packed, xp, yp, xyp], axis=-1)


def _pair_row_offset(pool: PairPool, pair, mip_b, mip_s):
    """Flat row index of (pair, mip) chain starts (analytic two-class
    addressing: big pairs first, then small; no metadata gathers)."""
    is_big = pair < pool.n_big
    small_base = pool.n_big * TEX_STRIDE
    return torch.where(
        is_big, pair * TEX_STRIDE + _mip_offset_dyn(mip_b),
        small_base + (pair - pool.n_big) * TEX_STRIDE_SMALL
        + _mip_offset_small_dyn(mip_s))


def _bilerp_quad(quad, fx, fy):
    c00 = unpack_rgba8(quad[..., 0])
    c10 = unpack_rgba8(quad[..., 1])
    c01 = unpack_rgba8(quad[..., 2])
    c11 = unpack_rgba8(quad[..., 3])
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, saturating far outside any texture (a float ->
    int cast of an out-of-range value is undefined in torch; the clamp
    keeps wrap addressing in range for garbage coordinates)."""
    return torch.clamp(torch.floor(x), -2.0 ** 30, 2.0 ** 30).long()


def _pair_texel(pool: PairPool, pair, uv, mip):
    """Shared addressing of one bilinear fetch: the row index of the
    texel's quad at the pair's (class-clamped) mip and the bilinear
    fractions. Returns (row, fx (..., 1), fy (..., 1), xa, ya)."""
    is_big = pair < pool.n_big
    mip_b = torch.clamp(mip, 0, POOL_MIPS - 1)
    mip_s = torch.clamp(mip, 0, POOL_MIPS_SMALL - 1)
    size = torch.where(is_big, POOL_SIZE >> mip_b, POOL_SIZE_SMALL >> mip_s)
    fsize = size.to(torch.float32)
    x = uv[..., 0] * fsize - 0.5
    y = uv[..., 1] * fsize - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xa = torch.remainder(_floor_int(x), size)
    ya = torch.remainder(_floor_int(y), size)
    off = _pair_row_offset(pool, pair, mip_b, mip_s)
    return off + ya * size + xa, fx, fy, xa, ya


def sample_pair_bilinear(pool: PairPool, pair: torch.Tensor,
                         uv: torch.Tensor, mip: torch.Tensor):
    """One bilinear fetch of both maps: ONE row gather per sample.

    pair/mip: (...,) int64; uv: (..., 2). Returns (diffuse, normal), each
    (..., 4) float32. WRAP addressing (the reference samples material
    maps with the Wrap samplers). Reads the first 8 lanes of a row, so it
    serves both pool layouts."""
    idx, fx, fy, _, _ = _pair_texel(pool, pair, uv, mip)
    row = pool.data[idx]
    return _bilerp_quad(row[..., 0:4], fx, fy), \
        _bilerp_quad(row[..., 4:8], fx, fy)


def sample_pair_dual(pool: PairPool, pair: torch.Tensor, uv: torch.Tensor,
                     mip: torch.Tensor, f: torch.Tensor):
    """ONE row gather -> the full trilinear blend of both maps.

    Requires a dual-mip pool. pair/mip: (...,) int64; f: (...,) float32
    blend toward mip+1. Returns (diffuse, normal), each (..., 4).

    The mip-m bilinear is exact; the mip-(m+1) bilinear comes from the
    midpoint-parent quad stored in the row (fractional parent coordinate
    fx1 = fx/2 - 0.25 + 0.5*(x0 odd), which extrapolates by <= 0.25 texel
    on even child texels)."""
    idx, fx, fy, xa, ya = _pair_texel(pool, pair, uv, mip)
    row = pool.data[idx]  # (..., 16) — ONE gather

    d0 = _bilerp_quad(row[..., 0:4], fx, fy)
    n0 = _bilerp_quad(row[..., 4:8], fx, fy)
    fx1 = 0.5 * fx - 0.25 + 0.5 * (xa & 1).to(torch.float32)[..., None]
    fy1 = 0.5 * fy - 0.25 + 0.5 * (ya & 1).to(torch.float32)[..., None]
    # the parent-quad extrapolation can leave [0, 1] by a hair; the TRUE
    # bilinear of UNORM texels never does, so clamp (keeps shininess
    # = (1-rough)*alpha from seeing a negative alpha)
    d1 = torch.clamp(_bilerp_quad(row[..., 8:12], fx1, fy1), 0.0, 1.0)
    n1 = torch.clamp(_bilerp_quad(row[..., 12:16], fx1, fy1), 0.0, 1.0)
    fb = f[..., None]
    return d0 * (1 - fb) + d1 * fb, n0 * (1 - fb) + n1 * fb


def class_lod(pool: PairPool, pair: torch.Tensor, lod_uv: torch.Tensor):
    """uv-space lod (log2 of the uv footprint) -> mip level for the pair's
    own class (a 64^2 chain at 1:1 screen scale samples mip 0)."""
    is_big = pair < pool.n_big
    bits = torch.where(is_big, float(np.log2(POOL_SIZE)),
                       float(np.log2(POOL_SIZE_SMALL)))
    max_mip = torch.where(is_big, POOL_MIPS - 1.0, POOL_MIPS_SMALL - 1.0)
    return torch.minimum(torch.clamp(lod_uv + bits, min=0.0), max_mip)


def sample_pair_trilinear(pool: PairPool, pair: torch.Tensor,
                          uv: torch.Tensor, lod_uv: torch.Tensor):
    """Trilinear fetch of both maps: ONE row gather on a dual-mip pool,
    two on a single-mip pool. lod_uv is the uv-space footprint log2 (see
    class_lod)."""
    lod = class_lod(pool, pair, lod_uv)
    m0 = torch.floor(lod).long()
    f = lod - m0.to(torch.float32)
    if pool.dual:
        return sample_pair_dual(pool, pair, uv, m0, f)
    d0, n0 = sample_pair_bilinear(pool, pair, uv, m0)
    d1, n1 = sample_pair_bilinear(pool, pair, uv, m0 + 1)  # class-clamped
    fb = f[..., None]
    return d0 * (1 - fb) + d1 * fb, n0 * (1 - fb) + n1 * fb


def uv_derivatives(uv: torch.Tensor):
    """Screen-space uv derivatives of a (H, W, 2) uv image by finite
    differences — the software analogue of pixel-quad derivatives. Edges
    reuse their neighbor's derivative (like HW helper lanes)."""
    dx = torch.diff(uv, dim=1)
    dy = torch.diff(uv, dim=0)
    return (torch.cat([dx, dx[:, -1:]], dim=1),
            torch.cat([dy, dy[-1:]], dim=0))


def lod_from_derivatives(dx: torch.Tensor, dy: torch.Tensor):
    """Isotropic (trilinear) uv-space lod: log2 of the larger footprint."""
    rho = torch.maximum(torch.sqrt((dx * dx).sum(-1)),
                        torch.sqrt((dy * dy).sum(-1)))
    return torch.log2(torch.clamp(rho, min=1e-12))


def _aniso_footprint(pool: PairPool, pair, dx, dy, max_aniso: int,
                     probes: int = None):
    """Footprint decomposition (EXT_texture_filter_anisotropic): M =
    min(ceil(p_max / p_min), max_aniso[, probes]) probes along the
    major-axis uv derivative, at lod = log2(p_max / M). Returns (M, duv,
    m0, f): the probe count, the major axis, the floor mip and the blend
    toward m0 + 1."""
    lx2 = (dx * dx).sum(-1)
    ly2 = (dy * dy).sum(-1)
    major_is_x = lx2 >= ly2
    p_max = torch.sqrt(torch.clamp(torch.maximum(lx2, ly2), min=1e-24))
    p_min = torch.sqrt(torch.clamp(torch.minimum(lx2, ly2), min=1e-24))
    ratio = torch.clamp(p_max / p_min, 1.0, float(max_aniso))
    M = torch.ceil(ratio - 1e-4)
    if probes is not None:
        M = torch.clamp(M, max=float(probes))
    lod_uv = torch.log2(p_max / M)
    duv = torch.where(major_is_x[..., None], dx, dy)  # (..., 2) major axis
    lod = class_lod(pool, pair, lod_uv)
    m0 = torch.floor(lod).long()
    return M, duv, m0, lod - m0.to(torch.float32)


def sample_pair_aniso(pool: PairPool, pair: torch.Tensor, uv: torch.Tensor,
                      dx: torch.Tensor, dy: torch.Tensor, max_aniso: int,
                      probes: int = 4):
    """Anisotropic filtering of both maps (D3D12_FILTER_ANISOTROPIC with
    MaxAnisotropy=8, the reference's gsamAnisotropicWrap), with a static
    schedule of ``probes`` probes spread over the M active slots along the
    major axis (see _aniso_footprint). On a dual-mip pool each probe is a
    full trilinear blend from its single dual-row gather; on a single-mip
    pool the probes alternate between mips m0 and m0 + 1 with weights
    (1 - f) and f, so the mip blend and the line footprint are sampled
    jointly (M = 1 collapses to exact trilinear)."""
    M, duv, m0, f = _aniso_footprint(pool, pair, dx, dy, max_aniso, probes)
    d_acc = 0.0
    n_acc = 0.0
    w_acc = 0.0
    for i in range(probes):
        fi = float(i)
        # slot within the active probes (wraps if probes > M)
        j = torch.clamp(M - 1.0, max=fi)
        j = torch.where(fi >= M, fi - M, j)
        s = ((j + 0.5) / M - 0.5) * ((M - 1.0) / M)
        puv = uv + duv * s[..., None]
        if pool.dual:
            wgt = (fi < M).to(torch.float32)
            d, n = sample_pair_dual(pool, pair, puv, m0, f)
        else:
            # probes beyond 2M duplicate earlier slots and drop out of the
            # normalization; with one active slot, probe 1 still brings
            # the m0 + 1 term
            use_m1 = i % 2 == 1
            active = (fi < torch.clamp(2.0 * M, min=2.0)).to(torch.float32)
            wgt = (f if use_m1 else 1.0 - f) * active
            d, n = sample_pair_bilinear(pool, pair, puv,
                                        m0 + 1 if use_m1 else m0)
        wgt = wgt[..., None]
        d_acc = d_acc + wgt * d
        n_acc = n_acc + wgt * n
        w_acc = w_acc + wgt
    w_acc = torch.clamp(w_acc, min=1e-8)
    return d_acc / w_acc, n_acc / w_acc


def sample_pair_aniso_ref(pool: PairPool, pair: torch.Tensor,
                          uv: torch.Tensor, dx: torch.Tensor,
                          dy: torch.Tensor, max_aniso: int):
    """Reference-quality anisotropic evaluation (``aniso_probes=0``): M <=
    max_aniso probes, each an exact two-gather trilinear — the quality bar
    the probe schedules are measured against (experiments/aniso_quality.py),
    2*max_aniso row gathers per pixel."""
    M, duv, m0, f = _aniso_footprint(pool, pair, dx, dy, max_aniso)
    f = f[..., None]
    d_acc = 0.0
    n_acc = 0.0
    w_acc = 0.0
    for i in range(max_aniso):
        s = ((i + 0.5) / M - 0.5) * ((M - 1.0) / M)
        puv = uv + duv * s[..., None]
        active = (float(i) < M).to(torch.float32)[..., None]
        d0, n0 = sample_pair_bilinear(pool, pair, puv, m0)
        d1, n1 = sample_pair_bilinear(pool, pair, puv, m0 + 1)
        d_acc = d_acc + active * (d0 * (1 - f) + d1 * f)
        n_acc = n_acc + active * (n0 * (1 - f) + n1 * f)
        w_acc = w_acc + active
    w_acc = torch.clamp(w_acc, min=1e-8)
    return d_acc / w_acc, n_acc / w_acc


# ---------------------------------------------------------------------------
# Sky
# ---------------------------------------------------------------------------

def pack_cubemap(faces: np.ndarray) -> np.ndarray:
    """(6, S, S, 4) float [0,1] -> (6, S, S, 4) uint32: per texel, the
    clamp-addressed 2x2 neighborhood quad, RGBA8-packed."""
    u = np.clip(np.asarray(faces) * 255.0 + 0.5, 0, 255).astype(np.uint32)
    packed = (u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
              | (u[..., 3] << 24))  # (6, S, S)
    xp = packed[:, :, np.minimum(np.arange(packed.shape[2]) + 1,
                                 packed.shape[2] - 1)]
    yp = packed[:, np.minimum(np.arange(packed.shape[1]) + 1,
                              packed.shape[1] - 1), :]
    xyp = yp[:, :, np.minimum(np.arange(packed.shape[2]) + 1,
                              packed.shape[2] - 1)]
    return np.stack([packed, xp, yp, xyp], axis=-1)


def sample_cubemap(faces: torch.Tensor,
                   direction: torch.Tensor) -> torch.Tensor:
    """faces: (6, S, S, 4) int32 quad-packed RGBA8 bits (pack_cubemap) in
    D3D face order (+X -X +Y -Y +Z -Z); direction: (..., 3). Bilinear
    within the face, edges clamped; one quad gather per sample."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    # major axis selection (D3D TextureCube convention)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(on_x, on_y, on_z):
        return torch.where(is_x, on_x, torch.where(is_y, on_y, on_z))

    def sgn(cond, a, b):
        return torch.where(cond, a, b)

    face = pick(sgn(x >= 0, 0, 1), sgn(y >= 0, 2, 3), sgn(z >= 0, 4, 5))
    ma = torch.clamp(pick(ax, ay, az), min=1e-20)
    sc = pick(sgn(x >= 0, -z, z), x, sgn(z >= 0, x, -x))
    tc = torch.where(is_y, sgn(y >= 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)

    S = faces.shape[1]
    fx = u * S - 0.5
    fy = v * S - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = torch.clamp(_floor_int(fx), 0, S - 1)
    y0i = torch.clamp(_floor_int(fy), 0, S - 1)
    quad = faces[face.long(), y0i, x0i]  # (..., 4) — ONE gather
    return _bilerp_quad(quad, wx, wy)


SKY_ZENITH = (0.18, 0.32, 0.65)
SKY_HORIZON = (0.82, 0.88, 0.95)
SKY_GROUND = (0.35, 0.33, 0.30)


def procedural_sky_color(direction: torch.Tensor) -> torch.Tensor:
    """Analytic evaluation of the procedural sky (the same function
    procedural_sky_cubemap discretizes into faces): direction (..., 3)
    -> (..., 3) color."""
    d = direction / torch.clamp(
        torch.sqrt((direction ** 2).sum(-1, keepdim=True)), min=1e-20)
    h = d[..., 1:2]
    t = torch.clamp(h, 0.0, 1.0) ** 0.6
    dev = direction.device
    zenith = device_constant(SKY_ZENITH, torch.float32, dev)
    horizon = device_constant(SKY_HORIZON, torch.float32, dev)
    ground = device_constant(SKY_GROUND, torch.float32, dev)
    sky = horizon * (1.0 - t) + zenith * t
    g = torch.clamp(-h, 0.0, 1.0) ** 0.5
    return sky * (1.0 - g) + ground * g


def procedural_sky_cubemap(size: int = 256) -> np.ndarray:
    """Substitute for the missing snowcube1024.dds asset
    (LoadTextures requests it, CRYCHIC.cpp:960): a horizon-graded sky —
    deep blue zenith, pale horizon, dark ground."""
    S = size
    faces = np.zeros((6, S, S, 4), dtype=np.float32)
    uv = (np.arange(S, dtype=np.float32) + 0.5) / S * 2.0 - 1.0
    u, v = np.meshgrid(uv, uv, indexing="xy")
    dirs = {
        0: lambda u, v: np.stack([np.ones_like(u), -v, -u], -1),
        1: lambda u, v: np.stack([-np.ones_like(u), -v, u], -1),
        2: lambda u, v: np.stack([u, np.ones_like(u), v], -1),
        3: lambda u, v: np.stack([u, -np.ones_like(u), -v], -1),
        4: lambda u, v: np.stack([u, -v, np.ones_like(u)], -1),
        5: lambda u, v: np.stack([-u, -v, -np.ones_like(u)], -1),
    }
    zenith = np.array(SKY_ZENITH)
    horizon = np.array(SKY_HORIZON)
    ground = np.array(SKY_GROUND)
    for f in range(6):
        d = dirs[f](u, v)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        h = d[..., 1]
        t = np.clip(h, 0.0, 1.0) ** 0.6
        sky = horizon * (1 - t[..., None]) + zenith * t[..., None]
        g = np.clip(-h, 0.0, 1.0) ** 0.5
        col = sky * (1 - g[..., None]) + ground * g[..., None]
        faces[f, ..., :3] = col
        faces[f, ..., 3] = 1.0
    return faces
