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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# The raster kernel's tiles are (8, 128) pixels; every binning of the port
# (both raster launches and the capacity counts) uses this tiling.
TILE_H = 8
TILE_W = 128


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
                overflowed=total > pair_capacity)


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
