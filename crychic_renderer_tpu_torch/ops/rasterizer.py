"""Triangle setup and exact tile binning (torch counterpart of
``crychic_renderer_tpu.ops.rasterizer``).

Replaces the D3D12 rasterization hardware the reference gets for free from
``DrawIndexedInstanced``: screen-space triangles are binned to pixel tiles,
and the raster kernel (``ops.raster``) runs a coverage + depth test per
tile, producing a visibility buffer (per-pixel depth + winning triangle id).

D3D11/12 rasterization rules replicated:
- viewport transform ``x = (ndc.x*0.5+0.5)*W``, ``y = (0.5-ndc.y*0.5)*H``,
  pixel centers at integer+0.5, NDC z in [0,1];
- front faces are clockwise in screen space (y down); back faces culled;
- top-left fill convention on shared edges;
- depth is interpolated linearly in screen space, depth test LESS, depth
  cleared to 1.0.

Binning is exact and static-shaped: per-triangle tile-bbox counts ->
exclusive cumsum -> fixed-capacity pair expansion -> stable sort of pairs by
tile -> contiguous per-tile runs (start, count), for the full screen, a
contiguous band of tile rows, or one owner's interleaved tile rows (the
band-sharded frame, ``parallel/sharded.py``). Integer tensors stay int32
as in the JAX package (``cumsum`` is given the dtype).

The pure-tensor rasterizer of the JAX package (``RenderConfig.use_pallas``
False) is here too: ``rasterize_binned`` evaluates each tile's first
``bin_cap`` binned triangles over its pixels on XLA_TILE_H-row tiles, and
``rasterize_bruteforce`` every triangle over every pixel. Neither is a
kernel or a fallback: only an explicit ``use_pallas=False`` selects them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# The raster kernel's tiles are (8, 128) pixels; the kernel path's
# binning and capacity counts use this tiling.
TILE_H = 8
TILE_W = 128
# The pure-tensor rasterizer's tiles are (32, 128) pixels (the JAX
# package's rz.TILE_H): it bins and truncates each tile's run at bin_cap
# on this tiling, so every caller of that path passes it explicitly.
XLA_TILE_H = 32


class ScreenTris(NamedTuple):
    """Screen-space triangle setup (one record per triangle)."""

    xy: torch.Tensor  # (T, 3, 2) screen coords
    z: torch.Tensor  # (T, 3) NDC z at each vertex
    inv_w: torch.Tensor  # (T, 3) 1/clip.w (for perspective-correct interp)
    valid: torch.Tensor  # (T,) bool (in front of near plane, front-facing)


class Bins(NamedTuple):
    order: torch.Tensor  # (P,) int32 pair -> triangle id (sorted by tile)
    starts: torch.Tensor  # (num_tiles,) int32 first pair of each tile
    counts: torch.Tensor  # (num_tiles,) int32 pairs per tile
    sorted_tile: torch.Tensor  # (P,) int32 tile id per sorted pair
    num_valid: torch.Tensor  # () int32 total valid pairs
    overflowed: torch.Tensor  # () bool — pair capacity exceeded
    total: torch.Tensor  # () int32 pairs expanded, past the capacity too


def viewport_transform(clip: torch.Tensor, width: int, height: int):
    """clip: (..., 4) row-vector clip-space positions -> screen xy, z, 1/w.

    Returns (xy(..., 2), z(...,), inv_w(...,), in_front(...,) bool).
    """
    w = clip[..., 3]
    in_front = w > 1e-6
    safe_w = torch.where(in_front, w, torch.ones_like(w))
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return torch.stack([sx, sy], dim=-1), ndc[..., 2], inv_w, in_front


def setup_triangles(clip_verts: torch.Tensor, indices: torch.Tensor,
                    width: int, height: int,
                    cull_backface: bool = True) -> ScreenTris:
    """clip_verts: (V, 4); indices: (T*3,) -> per-triangle screen setup.
    Triangles with a vertex behind the near plane are culled; callers
    that need the near plane right clip first (ops.clipping) and call
    setup_tri_verts."""
    v = clip_verts[indices.long().reshape(-1, 3)]  # (T, 3, 4)
    return setup_tri_verts(v, None, width, height, cull_backface)


SUBPIXEL = 256.0  # 1/256-pixel snapping (the D3D subpixel grid)


def snap_xy(xy: torch.Tensor) -> torch.Tensor:
    # torch.round and jnp.round both round half to even
    return torch.round(xy * SUBPIXEL) / SUBPIXEL


def setup_tri_verts(v: torch.Tensor, valid_in, width: int, height: int,
                    cull_backface: bool = True) -> ScreenTris:
    """Per-triangle screen setup from explicit clip-space vertices
    (T, 3, 4) — the entry point for pre-clipped geometry. Vertex xy snaps
    to the 1/256 subpixel grid here so binning, capacity counts and the
    raster kernel all see identical edge functions."""
    xy, z, inv_w, in_front = viewport_transform(v, width, height)
    xy = snap_xy(xy)
    valid = in_front.all(dim=-1)
    if valid_in is not None:
        valid = valid & valid_in

    # signed doubled area in y-down screen space; front (CW) => positive
    x0, y0 = xy[:, 0, 0], xy[:, 0, 1]
    x1, y1 = xy[:, 1, 0], xy[:, 1, 1]
    x2, y2 = xy[:, 2, 0], xy[:, 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    if cull_backface:
        valid = valid & (area2 > 0.0)
    else:
        # flip winding of back faces so edge tests stay consistent
        flip = area2 < 0.0
        xy = torch.where(flip[:, None, None], xy.flip(1), xy)
        z = torch.where(flip[:, None], z.flip(1), z)
        inv_w = torch.where(flip[:, None], inv_w.flip(1), inv_w)
        valid = valid & (area2 != 0.0)
    return ScreenTris(xy=xy, z=z, inv_w=inv_w, valid=valid)


def _floor_to_int(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """floor(x) clipped to [lo, hi] as int32. The clip happens in float:
    a float -> int cast of an out-of-range value is undefined in torch,
    while XLA saturates; clipping first gives the same integers."""
    return torch.clamp(torch.floor(x), lo, hi).to(torch.int32)


def _tile_bbox(tris: ScreenTris, width: int, height: int,
               tile_h: int, tile_w: int):
    """Per-triangle inclusive tile bbox (tx0, ty0, bw, bh); bw/bh==0 if culled."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    xmin = tris.xy[..., 0].amin(dim=-1)
    xmax = tris.xy[..., 0].amax(dim=-1)
    ymin = tris.xy[..., 1].amin(dim=-1)
    ymax = tris.xy[..., 1].amax(dim=-1)
    # pixel centers are at +0.5: a triangle covers pixel columns
    # ceil(xmin-0.5)..floor(xmax-0.5); conservative tile bounds below.
    tx0 = _floor_to_int(xmin / tile_w, 0, ntx - 1)
    tx1 = _floor_to_int((xmax - 1e-6) / tile_w, 0, ntx - 1)
    ty0 = _floor_to_int(ymin / tile_h, 0, nty - 1)
    ty1 = _floor_to_int((ymax - 1e-6) / tile_h, 0, nty - 1)
    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    # subpixel cull: a triangle whose bbox straddles no pixel CENTER can
    # produce no coverage (far cascades shrink meshes to a few texels).
    # The 1/256 margin keeps the test conservative under the subpixel snap.
    eps = 1.0 / 256.0
    no_center = ((torch.floor(xmax - 0.5 + eps) < torch.ceil(xmin - 0.5 - eps))
                 | (torch.floor(ymax - 0.5 + eps)
                    < torch.ceil(ymin - 0.5 - eps)))
    keep = tris.valid & ~offscreen & ~no_center
    zero = torch.zeros_like(tx0)
    bw = torch.where(keep, tx1 - tx0 + 1, zero)
    bh = torch.where(keep, ty1 - ty0 + 1, zero)
    return tx0, ty0, bw, bh, ntx, nty


def bin_triangles(tris: ScreenTris, width: int, height: int,
                  pair_capacity: int, tile_h: int = TILE_H,
                  tile_w: int = TILE_W, ty_lo: int = None,
                  num_rows: int = None, row_stride=None) -> Bins:
    """Exact tile binning with static shapes.

    Expands each triangle into (tile, tri) pairs via an exclusive cumsum
    (no per-triangle loop, no per-triangle cap), sorts pairs by tile id
    with a STABLE sort, and returns per-tile contiguous runs. Stability
    keeps each tile run's triangle ids strictly ascending, which the
    raster kernel's exact-z tie rule relies on. Pairs beyond
    ``pair_capacity`` are dropped and reported in ``overflowed``.

    Contiguous band (``ty_lo`` and ``num_rows``): only pairs whose tile
    row lies in [ty_lo, ty_lo + num_rows) are expanded. Tile ids stay
    global, and every in-band tile's run holds the same triangles in the
    same order as the full-screen binning.

    Interleaved rows (``row_stride=(n_dev, owner)``): only tile rows ty
    with ty % n_dev == owner are expanded, and pairs are sorted by the
    OWNER-MAJOR key (owner * rpd + ty // n_dev) * ntx + tx, rpd =
    ceil(nty / n_dev), so each owner's tiles are one contiguous key range
    [owner * rpd * ntx, (owner + 1) * rpd * ntx) while every run's
    contents and order stay those of the full-screen binning. ``starts``,
    ``counts`` and ``sorted_tile`` are indexed by that key (key space
    rpd * n_dev * ntx); key row kr is true tile row
    (kr % rpd) * n_dev + kr // rpd.
    """
    tx0, ty0, bw, bh, ntx, nty = _tile_bbox(tris, width, height,
                                            tile_h, tile_w)
    dev = tx0.device
    zero = torch.zeros_like(bw)
    if ty_lo is not None:
        ty1 = ty0 + bh - 1
        ty0 = torch.clamp(ty0, min=ty_lo)
        bh = torch.clamp(torch.clamp(ty1, max=ty_lo + num_rows - 1)
                         - ty0 + 1, min=0)
        bw = torch.where(bh > 0, bw, zero)
        bh = torch.where(bw > 0, bh, zero)
    row_mult = 1
    num_keys = ntx * nty
    if row_stride is not None:
        n_dev, owner = row_stride
        rpd = -(-nty // n_dev)
        # owned rows of the bbox: ty0 <= ty <= ty1 with ty % n_dev == owner
        ty1 = ty0 + bh - 1
        first = ty0 + torch.remainder(owner - ty0, n_dev)
        bh = torch.where(first > ty1, zero,
                         torch.div(ty1 - first, n_dev,
                                   rounding_mode="floor") + 1)
        ty0 = first
        bw = torch.where(bh > 0, bw, zero)
        bh = torch.where(bw > 0, bh, zero)
        row_mult = n_dev
        num_keys = rpd * n_dev * ntx
    counts = bw * bh
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets = ends - counts  # exclusive
    total = (ends[-1] if counts.shape[0]
             else torch.zeros((), dtype=torch.int32, device=dev))

    pair_idx = torch.arange(pair_capacity, dtype=torch.int32, device=dev)
    # triangle of each pair: the last triangle whose offset <= pair index
    # (the JAX package's scatter-add + cumsum of offset marks, written as
    # the equivalent search over the nondecreasing offsets)
    tri_of_pair = torch.searchsorted(offsets, pair_idx, right=True,
                                     out_int32=True) - 1
    tri_of_pair = torch.clamp(tri_of_pair, 0, max(counts.shape[0] - 1, 0))
    packed = torch.stack([offsets, bw, tx0, ty0], dim=-1)  # (T, 4)
    pp = packed[tri_of_pair.long()]  # (P, 4)
    slot = pair_idx - pp[:, 0]
    bw_p = torch.clamp(pp[:, 1], min=1)
    ty = pp[:, 3] + torch.div(slot, bw_p, rounding_mode="floor") * row_mult
    tx = pp[:, 2] + torch.remainder(slot, bw_p)
    valid_pair = pair_idx < torch.clamp(total, max=pair_capacity)
    key_row = ty
    if row_stride is not None:
        key_row = owner * rpd + torch.div(ty, n_dev, rounding_mode="floor")
    tile_id = torch.where(valid_pair, key_row * ntx + tx,
                          torch.full_like(ty, num_keys))

    sorted_tile, perm = torch.sort(tile_id, stable=True)
    order = tri_of_pair[perm]

    # per-tile (start, count) via histogram + exclusive cumsum; the
    # out-of-range key num_keys (invalid pairs) is counted and cut off.
    # scatter_add rather than bincount, which syncs to size its output.
    hist = torch.zeros(num_keys + 1, dtype=torch.int32, device=dev)
    hist = hist.scatter_add_(0, tile_id.long(),
                             torch.ones_like(tile_id))[:num_keys]
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    return Bins(order=order, starts=starts, counts=hist,
                sorted_tile=sorted_tile,
                num_valid=torch.clamp(total, max=pair_capacity),
                overflowed=total > pair_capacity, total=total)


# ---------------------------------------------------------------------------
# Coverage / depth core (shared math)
# ---------------------------------------------------------------------------

def _edge_coeffs(xy: torch.Tensor):
    """Edge-function coefficients for the 3 edges of each triangle.

    xy: (T, 3, 2). Edge i runs a=v_{(i+1)%3} -> b=v_{(i+2)%3} and weights
    vertex i. E_i(p) = A_i*px + B_i*py + C_i, interior (front face) > 0.
    Returns A, B, C: (T, 3), area2: (T,) and the top-left flags (T, 3).
    """
    # vertices (1, 2, 0) and (2, 0, 1) by rolls, as in barycentrics_at
    a = torch.roll(xy, -1, dims=1)
    b = torch.roll(xy, -2, dims=1)
    # edge(a,b,p) = (bx-ax)(py-ay) - (by-ay)(px-ax)
    A = -(b[..., 1] - a[..., 1])
    B = b[..., 0] - a[..., 0]
    C = -(A * a[..., 0] + B * a[..., 1])
    x0, y0 = xy[:, 0, 0], xy[:, 0, 1]
    x1, y1 = xy[:, 1, 0], xy[:, 1, 1]
    x2, y2 = xy[:, 2, 0], xy[:, 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    # top-left rule: count E == 0 as inside only for top (dy==0, dx>0)
    # and left (dy<0) edges, in y-down screen space with CW front faces.
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    top_left = (dy < 0) | ((dy == 0) & (dx > 0))
    return A, B, C, area2, top_left


def barycentrics_at(xy: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Screen-space barycentric weights of each triangle at points (px, py).

    xy: (..., 3, 2); px/py broadcastable against xy[..., 0, 0].
    Returns (..., 3) weights summing to 1 (unnormalized by w).
    """
    # vertices (1, 2, 0) and (2, 0, 1) by rolls: indexing with a list
    # copies the list to the device, which waits for it
    a = torch.roll(xy, -1, dims=-2)
    b = torch.roll(xy, -2, dims=-2)
    E = ((b[..., 0] - a[..., 0]) * (py[..., None] - a[..., 1])
         - (b[..., 1] - a[..., 1]) * (px[..., None] - a[..., 0]))
    area2 = E.sum(dim=-1, keepdim=True)
    return E / torch.where(area2 == 0, torch.ones_like(area2), area2)


# ---------------------------------------------------------------------------
# The pure-tensor rasterizer (the JAX package's XLA path, use_pallas=False)
# ---------------------------------------------------------------------------

# Pixel-pair evaluations per step of rasterize_binned: 4,096 binned pairs
# against their tile's 32 x 128 pixels, one f32 plane 64 MiB (a step's
# transients stay under ~1 GiB)
XLA_STEP_ELEMS = 1 << 24


def _depth_planes(z: torch.Tensor, A, B, C, area2):
    """The depth plane z(p) = zA*px + zB*py + zC of each triangle: the
    vertex depths weighted by the edge functions over the doubled area."""
    inv_a2 = 1.0 / torch.where(area2 == 0, torch.ones_like(area2), area2)
    return ((A * z * inv_a2[:, None]).sum(-1),
            (B * z * inv_a2[:, None]).sum(-1),
            (C * z * inv_a2[:, None]).sum(-1))


def rasterize_bruteforce(tris: ScreenTris, width: int, height: int,
                         tri_block: int = 64):
    """All triangles against all pixels (tests and tiny scenes), blocks of
    tri_block triangles in order: the nearest z wins, and on a tie the
    earliest triangle. Returns (depth (H, W) f32 cleared to 1.0, tri_id
    (H, W) i32, -1 = none)."""
    A, B, C, area2, top_left = _edge_coeffs(tris.xy)
    dev = A.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev)
          + 0.5)[:, None]
    depth = torch.ones((height, width), dtype=torch.float32, device=dev)
    tid = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    inf = float("inf")
    for b0 in range(0, A.shape[0], tri_block):
        b1 = min(A.shape[0], b0 + tri_block)

        def blk(x):  # (T, ...) -> (TB, ..., 1, 1)
            return x[b0:b1, ..., None, None]

        E = blk(A) * px + blk(B) * py + blk(C)  # (TB, 3, H, W)
        inside = (E > 0) | ((E == 0) & blk(top_left))
        cov = inside.all(dim=1) & blk(tris.valid)
        zpix = (E * blk(tris.z)).sum(dim=1) / blk(area2)
        zpix = torch.where(cov & (zpix >= 0.0) & (zpix <= 1.0), zpix, inf)
        zmin = zpix.amin(dim=0)
        amin = torch.argmin(zpix, dim=0).to(torch.int32)  # first on ties
        better = zmin < depth
        depth = torch.where(better, zmin, depth)
        tid = torch.where(better, b0 + amin, tid)
    return depth, tid


def rasterize_binned(tris: ScreenTris, bins: Bins, width: int, height: int,
                     bin_cap: int, with_ids: bool = True,
                     tile_row_offset: int = None, num_tile_rows: int = None,
                     row_stride=None):
    """The pure-tensor tiled rasterizer over pairs binned on XLA_TILE_H-row
    tiles (``bin_triangles(..., tile_h=XLA_TILE_H)`` with the same band
    arguments): the JAX package's rasterize_binned, with its output.

    Each tile takes the first ``bin_cap`` triangles of its run in
    ``bins.order`` (the rest are dropped: the JAX package's truncation,
    which capacity_requirements' max tile counts guard) and evaluates
    them over its pixel centres at global coordinates, ((A*px) + (B*py))
    + C with every op rounded, as the JAX package does; each pixel keeps
    the nearest z below the 1.0 clear, and on a tie the triangle first in
    bin order (the JAX package's argmin within a block and strict <
    across blocks). Runs are in ascending triangle order, so that is the
    smallest id.

    The JAX package loops every tile over bin_cap // tri_block blocks, so
    its work is tiles x bin_cap whatever the runs hold (a far cascade's
    tile can hold most of the scene, and bin_cap is twice the largest
    run). Here the binned pairs are evaluated instead, each against its
    own tile's pixels, XLA_STEP_ELEMS pixel-pairs a step, and one
    scatter-min per step keeps the per-pixel winner: the key (z bits <<
    32) | pair index orders by depth, then by bin order. The loop covers
    the fixed pair capacity on the card, so no count is read back and a
    CUDA graph captures it; on the CPU it stops after the valid pairs
    (one host read), which changes no pixel.

    Contiguous band: tile_row_offset + num_tile_rows rasterize those tile
    rows of the full screen's binning into (num_tile_rows * XLA_TILE_H,
    W). Interleaved: row_stride=(n_dev, owner) with the matching
    owner-major binning gives (rpd * XLA_TILE_H, W), whose row
    s * XLA_TILE_H + r is in true tile row s * n_dev + owner. Tile origins
    stay the full screen's, so band pixels equal the full raster's.

    Returns (depth (rows, W) f32, tri_id (rows, W) i32 or None)."""
    TH, TW = XLA_TILE_H, TILE_W
    lanes = TH * TW
    ntx = -(-width // TW)
    nty = -(-height // TH)
    if row_stride is not None:
        n_dev, owner = row_stride
        rpd = -(-nty // n_dev)
        out_rows, full_keys = rpd, rpd * n_dev * ntx
        off = owner * rpd * ntx
    else:
        out_rows = nty if num_tile_rows is None else num_tile_rows
        off = 0 if num_tile_rows is None else tile_row_offset * ntx
        full_keys = ntx * nty
    grid = out_rows * ntx
    keys = bins.starts.shape[0]
    if keys != full_keys or off < 0 or off + grid > keys:
        raise ValueError(
            f"bins hold {keys} tiles; a {width}x{height} screen binned on "
            f"{TH}-row tiles has {full_keys}, and this grid reads keys "
            f"[{off}, {off + grid})")
    A, B, C, area2, top_left = _edge_coeffs(tris.xy)
    zA, zB, zC = _depth_planes(tris.z, A, B, C, area2)
    planes = torch.cat([A, B, C, torch.stack([zA, zB, zC], -1)], dim=-1)
    dev = planes.device
    col = torch.arange(TW, dtype=torch.float32, device=dev) + 0.5
    row = torch.arange(TH, dtype=torch.float32, device=dev) + 0.5
    lane = torch.arange(lanes, device=dev)
    P = bins.order.shape[0]
    n_eval = P if dev.type != "cpu" else int(bins.num_valid)
    step = max(1, XLA_STEP_ELEMS // lanes)
    none = torch.iinfo(torch.int64).max
    best = torch.full((grid * lanes,), none, dtype=torch.int64, device=dev)
    depth = torch.ones((grid * lanes,), dtype=torch.float32, device=dev)
    for c0 in range(0, n_eval, step):
        c1 = min(n_eval, c0 + step)
        j = torch.arange(c0, c1, device=dev)
        key = bins.sorted_tile[c0:c1].long()
        at = bins.starts.long()[torch.clamp(key, max=keys - 1)]
        ok = (j < bins.num_valid) & (key >= off) & (key < off + grid) \
            & (j - at < bin_cap)
        kr = torch.div(key, ntx, rounding_mode="floor")
        if row_stride is not None:  # key row -> true tile row
            kr = (torch.remainder(kr, rpd) * n_dev
                  + torch.div(kr, rpd, rounding_mode="floor"))
        px = (torch.remainder(key, ntx) * TW).to(torch.float32)[:, None] \
            + col  # (n, TW)
        py = (kr * TH).to(torch.float32)[:, None] + row  # (n, TH)
        tri = bins.order[c0:c1].long()
        p = planes[tri]  # (n, 12)
        tl = top_left[tri]

        def plane(a, b, c):  # ((a*px) + (b*py)) + c over (n, TH, TW)
            return ((p[:, a, None] * px)[:, None, :]
                    + (p[:, b, None] * py)[:, :, None]) + p[:, c, None, None]

        hit = (ok & tris.valid[tri])[:, None, None]
        for e in range(3):
            E = plane(e, 3 + e, 6 + e)
            hit = hit & ((E > 0) | ((E == 0) & tl[:, e, None, None]))
        z = plane(9, 10, 11)
        hit = hit & (z >= 0.0) & (z < 1.0)  # z = 1.0 never beats the clear
        pix = ((key - off).clamp(0, grid - 1)[:, None] * lanes
               + lane).reshape(-1)
        if with_ids:
            # +0.0 makes -0.0 the +0.0 it ties with; z >= 0, so its bits
            # order as the floats do
            zbits = (z + 0.0).view(torch.int32).to(torch.int64)
            cand = torch.where(hit, (zbits << 32) | j[:, None, None], none)
            best.scatter_reduce_(0, pix, cand.reshape(-1), "amin")
        else:
            depth.scatter_reduce_(0, pix, torch.where(
                hit, z, float("inf")).reshape(-1), "amin")

    tid = None
    if with_ids:
        won = best != none
        depth = torch.where(
            won, (best >> 32).to(torch.int32).view(torch.float32), 1.0)
        pair = torch.where(won, best & 0xFFFFFFFF, 0)
        tid = torch.where(won, bins.order[pair], -1)

    def assemble(flat):
        img = flat.reshape(out_rows, ntx, TH, TW).permute(0, 2, 1, 3)
        img = img.reshape(out_rows * TH, ntx * TW)
        if num_tile_rows is None and row_stride is None:
            img = img[:height]
        return img[:, :width]

    return assemble(depth), (assemble(tid) if with_ids else None)


def binned_raster(tris: ScreenTris, width: int, height: int,
                  pair_capacity: int, bin_cap: int, with_ids: bool = True,
                  row_stride=None, occupancy: dict = None):
    """bin_triangles on XLA_TILE_H-row tiles + rasterize_binned, the
    frame's use_pallas=False raster (full screen, or one owner's
    interleaved rows). Returns (depth, tid or None, pairs_overflowed () bool
    — pairs past pair_capacity were dropped, tiles_overflowed () bool — a
    tile's run outran bin_cap and was truncated). occupancy (optional
    dict) receives "pairs", the binning's total (Bins.total)."""
    bins = bin_triangles(tris, width, height, pair_capacity,
                         tile_h=XLA_TILE_H, row_stride=row_stride)
    if occupancy is not None:
        occupancy["pairs"] = bins.total
    depth, tid = rasterize_binned(tris, bins, width, height, bin_cap,
                                  with_ids=with_ids, row_stride=row_stride)
    return depth, tid, bins.overflowed, (bins.counts > bin_cap).any()


def raster_stats(tris: ScreenTris, width: int, height: int,
                 pair_capacity: int, tile_h: int = XLA_TILE_H,
                 tile_w: int = TILE_W) -> dict:
    """Capacity diagnostics of one binning: total pairs, the overflow flag
    and the largest per-tile triangle count (which must stay <= bin_cap
    for rasterize_binned, which truncates; the raster kernel takes every
    pair of a run). Reads the counts back to the host."""
    bins = bin_triangles(tris, width, height, pair_capacity, tile_h, tile_w)
    return dict(num_valid=int(bins.num_valid),
                overflowed=bool(bins.overflowed),
                max_tile_count=int(bins.counts.max()))


def rasterize(clip_verts: torch.Tensor, indices: torch.Tensor, width: int,
              height: int, pair_capacity: int = 1 << 19,
              bin_cap: int = 1024, with_ids: bool = True,
              backend: str = "binned"):
    """End to end: clip-space vertices + indices -> (depth, tri_id) by the
    pure-tensor rasterizer, backend "binned" (rasterize_binned) or
    "brute" (rasterize_bruteforce)."""
    tris = setup_triangles(clip_verts, indices, width, height)
    if backend == "brute":
        return rasterize_bruteforce(tris, width, height)
    if backend != "binned":
        raise ValueError(f"backend {backend!r}: 'binned' or 'brute'")
    bins = bin_triangles(tris, width, height, pair_capacity,
                         tile_h=XLA_TILE_H)
    return rasterize_binned(tris, bins, width, height, bin_cap,
                            with_ids=with_ids)
