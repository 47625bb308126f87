"""A synthetic asset set in the reference's published formats and counts,
written from a seed (the reference's Textures/ and Models/ are not in
this repository).

A frozen copy of the port's ``experiments/synthetic_assets.py``, so that
a change there does not move the benchmark's inputs. ``write_asset_set``
writes OUT/Textures and OUT/Models with ``struct`` headers and numpy
payloads, no encoder: every BC block's endpoints are the texture's smooth
pattern at the block's first and last texel (quantized), its indices a
fixed diagonal ramp between them. The content is smooth and consistent
across mips (each level is the pattern box-filtered at that level's texel
size), so a derivative that differs in its last ulp between two devices
moves a sample only a little. Random blocks belong in the decoder tests.

| file | format | full size (FULL) |
|---|---|---|
| Textures/bricks2.dds | DXT5 (BC3), 10 mips | 512² (published: DXT5 512², 10 mips) |
| Textures/tile.dds | DXT1 (BC1), full chain | 512² |
| Textures/bricks2_nmap.dds, tile_nmap.dds | RGBA8 with masks, full chain | 512² |
| Textures/white1x1.dds, default_nmap.dds | RGBA8 with masks | 1x1 |
| Textures/WireFence.dds | RGBA8 with masks, full chain: the fence scene's wire grid (wire_fence_chain) | 64² |
| Textures/BoltAnim/*.bmp | 60 frames, 24 bpp, bottom-up | 64x64 |
| Textures/FireAnim/*.bmp | 120 frames, 24 bpp, bottom-up | 64x64 |
| Textures/snowcube1024.dds | cubemap, DXT1, full chain per face | 6 x 1024² |
| Models/skull.txt | 31,076 vertices, 60,339 triangles | as published |
| Models/car.txt | 1,860 vertices, 1,850 triangles | as published |

The meshes are perturbed ellipsoids in the triangle order of the
reference's GeometryGenerator::CreateSphere, trimmed at the south cap to
the published triangle count; the vertices the trimmed sphere does not
use are copies of its first vertices, referenced by no triangle, so the
vertex count is the published one too. SMALL is the CPU tests' set: 64²
textures, 32² cube faces and a skull of 1,040 vertices and 2,000
triangles (the car and the animation frames as in FULL).
"""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from ..reference.io.dds import generate_mips

DDS_MAGIC = 0x20534444
_DDSD = 0x1 | 0x2 | 0x4 | 0x1000  # CAPS | HEIGHT | WIDTH | PIXELFORMAT
_DDSD_MIPMAPCOUNT = 0x20000
_DDSCAPS_TEXTURE = 0x1000
_DDSCAPS_COMPLEX_MIPMAP = 0x8 | 0x400000
_DDSCAPS2_CUBEMAP_ALLFACES = 0x200 | 0xFC00
RGBA8_MASKS = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)


@dataclasses.dataclass(frozen=True)
class AssetSizes:
    texture: int  # side of the 2D textures
    cube: int  # side of the sky cube's faces
    skull: tuple  # (vertices, triangles)


FULL = AssetSizes(texture=512, cube=1024, skull=(31076, 60339))
SMALL = AssetSizes(texture=64, cube=32, skull=(1040, 2000))
CAR = (1860, 1850)  # (vertices, triangles), in both sets
ANIM_SIDE = 64
ANIM_FRAMES = {"BoltAnim": 60, "FireAnim": 120}
SKY_CUBE = "snowcube1024.dds"


# -- DDS and BMP containers ------------------------------------------------

def dds_header(width, height, mip_count=1, fourcc=None, bpp=32,
               masks=RGBA8_MASKS, cube=False, dx10=None) -> bytes:
    """The 128-byte DDS header (magic included), followed by the 20-byte
    DX10 header when `dx10` = (dxgiFormat, resourceDimension, miscFlag,
    arraySize, miscFlags2) is given (then fourcc is b"DX10")."""
    flags = _DDSD | (_DDSD_MIPMAPCOUNT if mip_count > 1 else 0)
    head = struct.pack("<I7I", DDS_MAGIC, 124, flags, height, width, 0, 0,
                       mip_count)
    head += b"\0" * 44
    if fourcc is not None:
        head += struct.pack("<II4sIIIII", 32, 0x4, fourcc, 0, 0, 0, 0, 0)
    else:
        head += struct.pack("<II4sIIIII", 32, 0x40 | (0x1 if masks[3] else 0),
                            b"\0" * 4, bpp, *masks)
    caps = _DDSCAPS_TEXTURE | (_DDSCAPS_COMPLEX_MIPMAP if mip_count > 1
                               else 0)
    caps2 = _DDSCAPS2_CUBEMAP_ALLFACES if cube else 0
    head += struct.pack("<II", caps, caps2) + b"\0" * 12
    if dx10 is not None:
        head += struct.pack("<5I", *dx10)
    return head


def bmp_bytes(rgb: np.ndarray, bpp: int = 24, top_down: bool = False,
              alpha: np.ndarray = None) -> bytes:
    """An uncompressed BMP (BITMAPINFOHEADER) of an (H, W, 3) uint8 image,
    rows padded to 4 bytes, bottom-up unless top_down."""
    h, w = rgb.shape[:2]
    px = rgb[..., ::-1]  # BGR
    if bpp == 32:
        a = np.full((h, w, 1), 255, np.uint8) if alpha is None else \
            alpha[..., None]
        px = np.concatenate([px, a], axis=-1)
    row = w * (bpp // 8)
    pad = (-row) % 4
    rows = px if top_down else px[::-1]
    raw = np.concatenate([rows.reshape(h, row),
                          np.zeros((h, pad), np.uint8)], axis=1).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, len(raw), 2835, 2835, 0, 0)
    return struct.pack("<2sIHHI", b"BM", 54 + len(raw), 0, 0, 54) + info + raw


# -- BC blocks from a pattern, no encoder ------------------------------------

def _blocks(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (bh*bw, 16, C) 4x4 blocks, row-major; a level smaller
    than a block is padded by repeating its edge."""
    h, w, c = img.shape
    ph, pw = -(-h // 4) * 4, -(-w // 4) * 4
    img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    b = img.reshape(ph // 4, 4, pw // 4, 4, c).transpose(0, 2, 1, 3, 4)
    return b.reshape(-1, 16, c)


# diagonal ramp: texel (x, y) of a block sits at t = (x + y) / 6 between
# the endpoint at texel 0 (t = 0) and the one at texel 15 (t = 1)
_RAMP = (np.arange(16) % 4 + np.arange(16) // 4) / 6.0


def _ramp_indices(order, swap, steps):
    """Per block, the palette index of each texel's ramp position: `order`
    maps the rounded position 0..steps to the palette index, `swap` (per
    block) runs the ramp backwards."""
    t = np.where(swap[:, None], 1.0 - _RAMP[None, :], _RAMP[None, :])
    return np.asarray(order)[np.rint(t * steps).astype(np.int64)]


def _pack_bits(idx, width):
    """(N, 16) indices of `width` bits -> (N,) little-endian bit field."""
    shifts = (np.arange(16, dtype=np.uint64) * np.uint64(width))[None, :]
    return (idx.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)


def _rgb565(c):
    c = np.clip(np.rint(c), 0, 255).astype(np.uint32)
    return ((c[..., 0] * 31 + 127) // 255 << 11
            | (c[..., 1] * 63 + 127) // 255 << 5
            | (c[..., 2] * 31 + 127) // 255).astype(np.uint16)


def _color_block(blocks):
    """(N, 16, >=3) float texels -> (N,) BC1-layout 8-byte color blocks in
    the 4-color mode (c0 > c1; a flat block uses index 0 only)."""
    e0, e1 = _rgb565(blocks[:, 0, :3]), _rgb565(blocks[:, 15, :3])
    swap = e0 < e1
    c0, c1 = np.where(swap, e1, e0), np.where(swap, e0, e1)
    idx = _ramp_indices([0, 2, 3, 1], swap, 3)
    idx[c0 == c1] = 0
    out = np.zeros(len(blocks), dtype=[("c0", "<u2"), ("c1", "<u2"),
                                       ("bits", "<u4")])
    out["c0"], out["c1"] = c0, c1
    out["bits"] = _pack_bits(idx, 2).astype(np.uint32)
    return out


def _alpha_block(alpha):
    """(N, 16) float alphas -> (N, 8) uint8 BC3 alpha blocks in the
    8-value mode (a0 > a1; a flat block uses index 0 only)."""
    e0 = np.clip(np.rint(alpha[:, 0]), 0, 255).astype(np.uint8)
    e1 = np.clip(np.rint(alpha[:, 15]), 0, 255).astype(np.uint8)
    swap = e0 < e1
    a0, a1 = np.where(swap, e1, e0), np.where(swap, e0, e1)
    idx = _ramp_indices([0, 2, 3, 4, 5, 6, 7, 1], swap, 7)
    idx[a0 == a1] = 0
    bits = _pack_bits(idx, 3)
    out = np.zeros((len(alpha), 8), np.uint8)
    out[:, 0], out[:, 1] = a0, a1
    for k in range(6):
        out[:, 2 + k] = (bits >> np.uint64(8 * k)) & np.uint64(0xFF)
    return out


def _encode_level(fmt: str, level: np.ndarray) -> bytes:
    """One mip level, (h, w, 4) float RGBA in [0, 255], as DDS payload:
    'DXT1', 'DXT5' or 'RGBA8'."""
    if fmt == "RGBA8":
        return np.clip(np.rint(level), 0, 255).astype(np.uint8).tobytes()
    b = _blocks(level)
    color = _color_block(b)
    if fmt == "DXT1":
        return color.tobytes()
    alpha = _alpha_block(b[..., 3])
    return np.concatenate([alpha, color.view(np.uint8).reshape(-1, 8)],
                          axis=1).tobytes()


def _dds_file(fmt: str, levels: list, cube_faces: list = None) -> bytes:
    """A DDS file of a mip chain (or of six face chains, a cubemap)."""
    chains = cube_faces if cube_faces is not None else [levels]
    h, w = chains[0][0].shape[:2]
    fourcc = None if fmt == "RGBA8" else fmt.encode()
    head = dds_header(w, h, len(chains[0]), fourcc=fourcc,
                      cube=cube_faces is not None)
    return head + b"".join(_encode_level(fmt, lv) for chain in chains
                           for lv in chain)


# -- smooth patterns ---------------------------------------------------------

def _terms(rng, n, max_freq):
    """n periodic cosine products: (amplitude, fx, fy, phase x, phase y)."""
    return [(rng.uniform(0.4, 1.0) / n, int(rng.integers(1, max_freq + 1)),
             int(rng.integers(1, max_freq + 1)), rng.random(), rng.random())
            for _ in range(n)]


def _pattern(terms, w, h, phase=0.0):
    """The sum of the terms box-filtered over the texels of a (h, w) level,
    at its texel centres, with value and u/v derivatives: a cosine of
    frequency f averaged over a texel of width 1/w is itself times
    sinc(f / w). Returns (value, d/du, d/dv), each (h, w), value in
    [-1, 1]."""
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    val = np.zeros((h, w))
    du = np.zeros((h, w))
    dv = np.zeros((h, w))
    for a, fx, fy, px, py in terms:
        a = a * np.sinc(fx / w) * np.sinc(fy / h)
        ax = 2 * np.pi * (fx * u + px + phase)
        ay = 2 * np.pi * (fy * v + py)
        val += a * np.outer(np.cos(ay), np.cos(ax))
        du += -a * 2 * np.pi * fx * np.outer(np.cos(ay), np.sin(ax))
        dv += -a * 2 * np.pi * fy * np.outer(np.sin(ay), np.cos(ax))
    return val, du, dv


def _chain_sizes(size):
    return [max(size >> k, 1) for k in range(int(np.log2(size)) + 1)]


def _diffuse_chain(rng, size, base, alpha=(255.0, 255.0)):
    """A full mip chain of a smooth diffuse map around colour `base`, alpha
    between the two given values."""
    t1, t2, t3 = _terms(rng, 3, 4), _terms(rng, 2, 3), _terms(rng, 2, 2)
    tint1, tint2 = np.array([1.0, 0.8, 0.6]), np.array([0.3, 0.6, 1.0])
    out = []
    for s in _chain_sizes(size):
        p1, p2, p3 = (_pattern(t, s, s)[0] for t in (t1, t2, t3))
        lv = np.empty((s, s, 4))
        lv[..., :3] = (np.asarray(base) + 50.0 * p1[..., None] * tint1
                       + 25.0 * p2[..., None] * tint2)
        lv[..., 3] = alpha[0] + (alpha[1] - alpha[0]) * (0.5 + 0.5 * p3)
        out.append(np.clip(lv, 0.0, 255.0))
    return out


def _normal_chain(rng, size, slope=0.35):
    """A full mip chain of a tangent-space normal map of a smooth height
    field (x, y, z encoded as n * 127.5 + 127.5), shininess in alpha."""
    th, ta = _terms(rng, 3, 3), _terms(rng, 2, 2)
    out = []
    for s in _chain_sizes(size):
        _, du, dv = _pattern(th, s, s)
        k = slope / (2 * np.pi * 3)
        n = np.stack([-k * du, -k * dv, np.ones_like(du)], axis=-1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        lv = np.empty((s, s, 4))
        lv[..., :3] = n * 127.5 + 127.5
        lv[..., 3] = 160.0 + 80.0 * _pattern(ta, s, s)[0]
        out.append(np.clip(lv, 0.0, 255.0))
    return out


def _anim_frame(terms, size, base, i, n):
    """Frame i of n of an animated slot: the pattern's phase advances one
    period over the sequence. (size, size, 3) uint8."""
    p = _pattern(terms, size, size, phase=i / n)[0]
    rgb = np.asarray(base) + 70.0 * p[..., None] * np.array([1.0, 0.9, 0.7])
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


# the face directions of a D3D cubemap texel grid (+X -X +Y -Y +Z -Z),
# as in ops.sampling.procedural_sky_cubemap
_FACE_DIRS = (
    lambda u, v: np.stack([np.ones_like(u), -v, -u], -1),
    lambda u, v: np.stack([-np.ones_like(u), -v, u], -1),
    lambda u, v: np.stack([u, np.ones_like(u), v], -1),
    lambda u, v: np.stack([u, -np.ones_like(u), -v], -1),
    lambda u, v: np.stack([u, -v, np.ones_like(u)], -1),
    lambda u, v: np.stack([-u, -v, -np.ones_like(u)], -1),
)


def _sky_faces(rng, size):
    """Six full face chains of a snowy sky: the procedural sky's gradient
    with smooth cloud bands, a function of direction only."""
    from ..reference.ops.sampling import SKY_GROUND, SKY_HORIZON, SKY_ZENITH

    freqs = rng.normal(size=(4, 3)) * 2.0
    phases = rng.random(4) * 2 * np.pi
    zenith, horizon, ground = (np.array(c) for c in
                               (SKY_ZENITH, SKY_HORIZON, SKY_GROUND))
    faces = []
    for f in range(6):
        chain = []
        for s in _chain_sizes(size):
            c = (np.arange(s) + 0.5) / s * 2.0 - 1.0
            u, v = np.meshgrid(c, c, indexing="xy")
            d = _FACE_DIRS[f](u, v)
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            h = d[..., 1:2]
            t = np.clip(h, 0.0, 1.0) ** 0.6
            col = horizon * (1 - t) + zenith * t
            g = np.clip(-h, 0.0, 1.0) ** 0.5
            col = col * (1 - g) + ground * g
            cloud = np.cos(d @ freqs.T + phases).mean(-1, keepdims=True)
            col = col + 0.12 * np.clip(cloud, 0.0, 1.0) * (1 - g)
            lv = np.empty((s, s, 4))
            lv[..., :3] = np.clip(col, 0.0, 1.0) * 255.0
            lv[..., 3] = 255.0
            chain.append(lv)
        faces.append(chain)
    return faces


# -- meshes -----------------------------------------------------------------

def ellipsoid_mesh(rng, vertices, triangles, radii):
    """(positions (V, 3), normals (V, 3), indices (T, 3)) of a perturbed
    ellipsoid with exactly `vertices` vertices and `triangles` triangles
    (see the module doc)."""
    k = max(2, int(round(np.sqrt(triangles / 4.0))))  # stacks - 1
    n = -(-triangles // (2 * k))  # slices
    used = 2 + k * (n + 1)
    if used > vertices:
        raise ValueError(f"{vertices} vertices cannot carry {triangles} "
                         f"triangles on a sphere of {k + 1} stacks")
    phi = np.arange(1, k + 1) * np.pi / (k + 1)
    theta = np.arange(n + 1) * 2 * np.pi / n
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    ring = np.stack([sp * np.cos(theta), np.broadcast_to(cp, (k, n + 1)),
                     sp * np.sin(theta)], axis=-1).reshape(-1, 3)
    d = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    freqs = rng.normal(size=(5, 3)) * 2.5
    phases = rng.random(5) * 2 * np.pi
    r = 1.0 + 0.08 * np.cos(d @ freqs.T + phases).mean(-1)
    pos = d * r[:, None] * np.asarray(radii)

    idx = [np.stack([np.zeros(n, int), np.arange(2, n + 2),
                     np.arange(1, n + 1)], -1)]
    for i in range(k - 1):
        a = 1 + i * (n + 1) + np.arange(n)
        b = a + (n + 1)
        idx.append(np.stack([a, a + 1, b, b, a + 1, b + 1], -1).reshape(-1, 3))
    south = used - 1
    base = south - (n + 1)
    idx.append(np.stack([np.full(n, south), base + np.arange(n),
                         base + np.arange(n) + 1], -1))
    idx = np.concatenate(idx)[:triangles]

    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    face = np.cross(p1 - p0, p2 - p0)
    nrm = np.zeros_like(pos)
    for c in range(3):
        np.add.at(nrm, idx[:, c], face)
    if (nrm * d).sum() < 0:  # orient the normals outward
        nrm = -nrm
    lens = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(lens > 0, nrm / np.maximum(lens, 1e-30), d)
    pad = vertices - used
    pos = np.concatenate([pos, pos[:pad]])
    nrm = np.concatenate([nrm, nrm[:pad]])
    return pos, nrm, idx


def mesh_txt(pos, nrm, idx) -> str:
    """The Models/*.txt text of a mesh (CRYCHIC.cpp:1447-1516 format)."""
    v = np.concatenate([pos, nrm], axis=1)
    lines = [f"VertexCount: {len(pos)}", f"TriangleCount: {len(idx)}",
             "VertexList (pos, normal)", "{"]
    lines += ["\t" + " ".join(f"{x:.6f}" for x in row) for row in v]
    lines += ["}", "TriangleList", "{"]
    lines += [f"\t{a} {b} {c}" for a, b, c in idx]
    lines += ["}", ""]
    return "\n".join(lines)


# -- the set -----------------------------------------------------------------

def write_asset_set(root: str, sizes: AssetSizes = FULL, seed: int = 0):
    """Write the set under `root` (see the module doc). Returns dict(
    textures=root/Textures (a Renderer's asset_dir), models=root/Models
    (the meshes), sky_cube=the cubemap's path)."""
    rng = np.random.default_rng(seed)
    tex = os.path.join(root, "Textures")
    models = os.path.join(root, "Models")
    os.makedirs(tex, exist_ok=True)
    os.makedirs(models, exist_ok=True)

    def write(name, data):
        with open(os.path.join(tex, name), "wb") as f:
            f.write(data)

    s = sizes.texture
    write("bricks2.dds", _dds_file("DXT5", _diffuse_chain(
        rng, s, (150, 70, 50), alpha=(224.0, 255.0))))
    write("tile.dds", _dds_file("DXT1", _diffuse_chain(rng, s,
                                                       (170, 165, 155))))
    write("bricks2_nmap.dds", _dds_file("RGBA8", _normal_chain(rng, s)))
    write("tile_nmap.dds", _dds_file("RGBA8", _normal_chain(rng, s, 0.2)))
    write("white1x1.dds", _dds_file("RGBA8", [np.full((1, 1, 4), 255.0)]))
    write("default_nmap.dds", _dds_file(
        "RGBA8", [np.array([[[128.0, 128.0, 255.0, 255.0]]])]))
    write("WireFence.dds", _dds_file("RGBA8", [
        lv.astype(np.float64) for lv in wire_fence_chain()]))
    for subdir, base in (("BoltAnim", (120, 150, 230)),
                         ("FireAnim", (230, 120, 40))):
        os.makedirs(os.path.join(tex, subdir), exist_ok=True)
        terms = _terms(rng, 3, 2)
        n = ANIM_FRAMES[subdir]
        for i in range(n):
            write(os.path.join(subdir, f"{subdir}{i + 1:03d}.bmp"),
                  bmp_bytes(_anim_frame(terms, ANIM_SIDE, base, i, n)))
    write(SKY_CUBE, _dds_file("DXT1", None, _sky_faces(rng, sizes.cube)))
    for name, (nv, nt), radii in (("skull.txt", sizes.skull, (3.0, 3.6, 4.2)),
                                  ("car.txt", CAR, (2.5, 0.9, 1.2))):
        with open(os.path.join(models, name), "w") as f:
            f.write(mesh_txt(*ellipsoid_mesh(rng, nv, nt, radii)))
    return dict(textures=tex, models=models,
                sky_cube=os.path.join(tex, SKY_CUBE))


def wire_fence_chain(seed: int = 0, size: int = 64) -> list:
    """A (size, size) RGBA8 wire grid (bars 5 texels wide every 16, alpha
    255; holes alpha 0, a seeded tenth of the hole texels opaque too) with
    random bar colours, and its box-filtered mip chain, as a list of
    (h, w, 4) uint8 levels."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:size, :size]
    bar = (x % 16 < 5) | (y % 16 < 5) | (rng.random((size, size)) < 0.1)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = rng.integers(96, 256, (size, size, 3))
    img[..., 3] = np.where(bar, 255, 0)
    return generate_mips(img)
