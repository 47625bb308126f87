"""Tile rasterization: pair records, the CUDA raster kernel and its plain
PyTorch version.

This module is the port's counterpart of
``crychic_renderer_tpu/ops/raster_pallas.py``. The Pallas kernel
``_raster_kernel`` becomes the hand-written CUDA C++ kernel in
``csrc/raster.cu`` (built for sm_90a at first use, bound with ctypes), and
the XLA helpers around it (``tri_records``, ``build_records``) port as
torch code that both the kernel and the plain version read.

- ``rasterize`` is the entry point the frame calls: bin, build records,
  raster. It returns (depth, tid, overflowed), for the full screen (K1,
  K2) or one band of it (K3: one owner's interleaved tile rows, or a
  contiguous run of tile rows, with the full screen's tile anchors).
- ``raster_tiles`` is the kernel wrapper. A CPU tensor goes to
  ``rasterize_plain``; a CUDA tensor launches the kernel or raises.
- ``raster_tiles_field`` launches the same function on field-major (16, P)
  records (K4, the layout probe of ``experiments/fma_kernel_probe.py``).
- ``rasterize_plain`` evaluates every pair against its tile's 1024 pixels
  with plain tensor ops. On the card it equals the kernel bit for bit:
  both evaluate ((A*px) + (B*py)) + C with each operation rounded on its
  own.
- ``warp_rejects`` mirrors the kernel's warp-level reject (which records
  each warp's 16x8 rectangle skips), and ``warp_covers`` says which
  records cover a pixel of each rectangle: the tests hold that the first
  never skips what the second covers.

Record layout (``build_records``, one (16,) f32 row per sorted pair): 0-2
edge A, 3-5 edge B, 6-8 TILE-LOCAL edge C (evaluated at the pair's tile
origin, which keeps |E| small inside the tile; top-left bias folded in),
9-11 tile-local depth plane (zA, zB, zC), 12 triangle id as f32, 13-14
tile-local xlo/xhi column guard, 15 padding.

Fill-rule note: vertex coordinates are snapped to 1/256-pixel fixed point
in setup (like D3D's 8-bit subpixel rasterizer), so the top-left rule is an
exact epsilon bias on C for in-tile coordinates.
"""
from __future__ import annotations

import ctypes

import torch

from . import rasterizer as rz
from .build import KernelLibrary

TILE_H = rz.TILE_H  # 8
TILE_W = rz.TILE_W  # 128
TRI_BLOCK = 128  # pair capacities are multiples of this
# exact epsilon: snapped edge values are multiples of 1/SUBPIXEL^2
EDGE_EPS = 0.5 / (rz.SUBPIXEL * rz.SUBPIXEL)
REC_ROWS = 16
# the kernel's warps: warp w of a tile's block owns columns
# WARP_W * w .. + WARP_W - 1, all TILE_H rows
WARP_W = 16
WARPS = TILE_W // WARP_W


def tri_records(tris: rz.ScreenTris, xrange=None) -> torch.Tensor:
    """Per-TRIANGLE records (T, 16) f32 with global-origin planes and the
    top-left bias folded into C.

    xrange: optional (xlo (T,), xhi (T,)) viewport columns — coverage is
    masked to pixel centers with xlo <= x < xhi. Used by the shadow ATLAS,
    where each cascade owns a column and triangles extending past their
    cascade's viewport must not bleed into the neighbor."""
    xy = rz.snap_xy(tris.xy)
    A, B, C, area2, top_left = rz._edge_coeffs(xy)
    inv_a2 = 1.0 / torch.where(area2 == 0, torch.ones_like(area2), area2)
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    zC = (C * tris.z * inv_a2[:, None]).sum(-1)
    Cb = C - torch.where(top_left, 0.0, EDGE_EPS)
    ids = torch.arange(A.shape[0], dtype=torch.float32, device=A.device)
    pad = torch.zeros_like(ids)
    if xrange is None:
        xlo = torch.full_like(ids, -3e7)
        xhi = torch.full_like(ids, 3e7)
    else:
        xlo, xhi = xrange
    return torch.stack(
        [A[:, 0], A[:, 1], A[:, 2],
         B[:, 0], B[:, 1], B[:, 2],
         Cb[:, 0], Cb[:, 1], Cb[:, 2],
         zA, zB, zC, ids, xlo, xhi, pad], dim=-1)  # (T, 16)


def build_records(tris: rz.ScreenTris, bins: rz.Bins, ntx: int,
                  num_tiles: int, xrange=None,
                  row_unperm=None) -> torch.Tensor:
    """Tile-anchored pair records (P, 16), in sorted pair order.

    One row gather per pair from the per-triangle records, then C, zC and
    the column guard are re-anchored at the pair's tile origin. Rows past
    the valid pairs ride along; no tile run reaches them.

    row_unperm=(n_dev, rpd): ``bins`` holds owner-major keys (interleaved
    binning); key row kr is true tile row (kr % rpd) * n_dev + kr // rpd,
    and the anchors stay those of the full screen."""
    trecs = tri_records(tris, xrange)
    rec = trecs[bins.order.long()]  # (P, 16)
    tile_of = torch.clamp(bins.sorted_tile, max=num_tiles - 1)
    x0 = (torch.remainder(tile_of, ntx) * TILE_W).to(torch.float32)[:, None]
    ty = torch.div(tile_of, ntx, rounding_mode="floor")
    if row_unperm is not None:
        n_dev, rpd = row_unperm
        ty = (torch.remainder(ty, rpd) * n_dev
              + torch.div(ty, rpd, rounding_mode="floor"))
    y0 = (ty * TILE_H).to(torch.float32)[:, None]
    A, B = rec[:, 0:3], rec[:, 3:6]
    C = rec[:, 6:9] + A * x0 + B * y0
    zC = rec[:, 11:12] + rec[:, 9:10] * x0 + rec[:, 10:11] * y0
    xr = rec[:, 13:15] - x0  # xlo/xhi re-anchored at the tile origin
    rec = torch.cat([A, B, C, rec[:, 9:11], zC, rec[:, 12:13], xr,
                     torch.zeros_like(rec[:, :1])], dim=-1)
    if rec.shape[0] % TRI_BLOCK:
        raise ValueError(f"pair capacity {rec.shape[0]} is not a multiple "
                         f"of {TRI_BLOCK}")
    return rec.contiguous()


def binned_records(tris: rz.ScreenTris, width: int, height: int,
                   pair_capacity: int, xrange=None, row_stride=None,
                   tile_row_offset: int = None, num_tile_rows: int = None,
                   occupancy: dict = None):
    """Bin + record build: the raster kernel's inputs, for the full screen
    or one band (``row_stride`` or ``tile_row_offset``/``num_tile_rows``,
    see rz.bin_triangles). occupancy (optional dict) receives "pairs",
    the pairs the binning expanded (Bins.total, a 0-d int32 tensor).

    Returns (records (P, 16) f32, starts (keys,) i32, counts (keys,) i32,
    overflowed () bool)."""
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    bins = rz.bin_triangles(tris, width, height, pair_capacity,
                            ty_lo=tile_row_offset, num_rows=num_tile_rows,
                            row_stride=row_stride)
    if occupancy is not None:
        occupancy["pairs"] = bins.total
    row_unperm = None
    if row_stride is not None:
        row_unperm = (row_stride[0], -(-nty // row_stride[0]))
    records = build_records(tris, bins, ntx, bins.starts.shape[0], xrange,
                            row_unperm)
    return records, bins.starts, bins.counts, bins.overflowed


def band_grid(width: int, height: int, row_stride=None,
              tile_row_offset: int = None, num_tile_rows: int = None):
    """(tile_offset, rows) of one raster launch over a width x height
    screen: (None, height) for the full screen; for a band, the first key
    of its grid and its output rows, whole tiles and not cropped to the
    screen. Interleaved output row s * TILE_H + r is true tile row
    s * n_dev + owner."""
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    if row_stride is not None:
        n_dev, owner = row_stride
        rpd = -(-nty // n_dev)
        return owner * rpd * ntx, rpd * TILE_H
    if num_tile_rows is not None:
        return tile_row_offset * ntx, num_tile_rows * TILE_H
    return None, height


def rasterize(tris: rz.ScreenTris, width: int, height: int,
              pair_capacity: int, with_ids: bool = True, xrange=None,
              row_stride=None, tile_row_offset: int = None,
              num_tile_rows: int = None, occupancy: dict = None):
    """Full pipeline: bin + record build + raster (kernel on CUDA).

    Band modes: ``row_stride=(n_dev, owner)`` rasterizes the owner's
    interleaved tile rows into (rpd * TILE_H, W) slot-major stripes;
    ``tile_row_offset``/``num_tile_rows`` rasterizes that contiguous run of
    tile rows into (num_tile_rows * TILE_H, W). Binning and anchors stay
    those of the full width x height screen, so band pixels equal the
    full-screen raster's bit for bit.

    Returns (depth f32, tid i32 or None, overflowed () bool — True when
    pairs beyond pair_capacity were dropped); (H, W) for the full screen.
    occupancy (optional dict) receives "pairs" (binned_records)."""
    records, starts, counts, overflowed = binned_records(
        tris, width, height, pair_capacity, xrange, row_stride,
        tile_row_offset, num_tile_rows, occupancy)
    tile_offset, rows = band_grid(width, height, row_stride,
                                  tile_row_offset, num_tile_rows)
    depth, tid = raster_tiles(records, starts, counts, width, rows,
                              with_ids, xrange is not None, tile_offset)
    return depth, tid, overflowed


def _launch_grid(starts: torch.Tensor, counts: torch.Tensor, width: int,
                 height: int, tile_offset):
    """(ntx, first key, grid tiles) of a launch, or ValueError. A band
    (tile_offset given) is whole tile rows read from keys [tile_offset,
    tile_offset + grid) of the binning's key space."""
    if starts.dim() != 1 or counts.shape != starts.shape:
        raise ValueError("starts and counts must be 1-D tensors of one "
                         "length")
    ntx = -(-width // TILE_W)
    rows = -(-height // TILE_H)
    keys = starts.shape[0]
    if tile_offset is None:
        if keys != ntx * rows:
            raise ValueError(f"starts/counts hold {keys} tiles, the "
                             f"{width}x{height} screen has {ntx * rows}")
        return ntx, 0, ntx * rows
    grid = ntx * rows
    if (height % TILE_H or not isinstance(tile_offset, int)
            or tile_offset < 0 or tile_offset % ntx or keys % ntx
            or tile_offset + grid > keys):
        raise ValueError(
            f"band of {height} rows from key {tile_offset!r}: need whole "
            f"{TILE_H}-row tiles and a row-aligned tile_offset with "
            f"tile_offset + {grid} <= {keys} keys (ntx {ntx})")
    return ntx, tile_offset, grid


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

# pairs per evaluation chunk: 16k pairs x 1024 pixels = 16M elements per
# temporary, so the 1080p shadow atlas stays within a few GB
_PLAIN_CHUNK = 1 << 14


def _assemble(flat: torch.Tensor, ntx: int, nty: int, width: int,
              height: int) -> torch.Tensor:
    img = flat.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3)
    return img.reshape(nty * TILE_H, ntx * TILE_W)[:height, :width]


def warp_rejects(records: torch.Tensor, with_xrange: bool) -> torch.Tensor:
    """(P, WARPS) bool: which records the raster kernel's warps skip.
    Warp w owns the tile-local rectangle of pixel centres x in [16w + 0.5,
    16w + 15.5], y in [0.5, 7.5], and skips a record when (a) with the
    column guard, all its column centres lie outside [xlo, xhi), (b) an
    edge's plane at the rectangle's maximising corner is below -m, or (c)
    the depth plane's maximum is below -m or its minimum above 1 + m, with
    m = 2^-20 * (|A|*128 + |B|*8 + |C|) + 2^-120 of that plane.

    The mirror of csrc/raster.cu may_cover, op for op in f32 (see its
    note for why no skipped record covers a pixel of the warp)."""
    x0 = (torch.arange(WARPS, dtype=torch.float32, device=records.device)
          * WARP_W + 0.5)
    x1 = x0 + (WARP_W - 1)
    y0, y1 = 0.5, TILE_H - 0.5

    def col(k):
        return records[:, k:k + 1]

    def margin(a, b, c):
        return ((a.abs() * 128.0 + b.abs() * 8.0) + c.abs()) * 2.0 ** -20 \
            + 2.0 ** -120

    def corner(a, b, c, hi):  # the plane at the max (hi) / min corner
        x = torch.where((a >= 0.0) == hi, x1, x0)
        y = torch.where((b >= 0.0) == hi, y1, y0)
        return (a * x + b * y) + c

    out = torch.zeros((records.shape[0], WARPS), dtype=torch.bool,
                      device=records.device)
    if with_xrange:
        out |= (x1 < col(13)) | (x0 >= col(14))
    for e in range(3):
        a, b, c = col(e), col(3 + e), col(6 + e)
        out |= corner(a, b, c, True) < -margin(a, b, c)
    a, b, c = col(9), col(10), col(11)
    mz = margin(a, b, c)
    out |= corner(a, b, c, True) < -mz
    out |= corner(a, b, c, False) > 1.0 + mz
    return out


def warp_covers(records: torch.Tensor, with_xrange: bool) -> torch.Tensor:
    """(P, WARPS) bool: which records cover a pixel of each warp's
    rectangle (pair_hits, in chunks of pairs): what warp_rejects must
    never skip."""
    return torch.cat([
        pair_hits(records[c0:c0 + _PLAIN_CHUNK], with_xrange)[1]
        .reshape(-1, TILE_H, WARPS, WARP_W).any(dim=3).any(dim=1)
        for c0 in range(0, records.shape[0], _PLAIN_CHUNK)])


def pair_hits(records: torch.Tensor, with_xrange: bool):
    """Each record against its tile's 8x128 pixel centres, as the kernel
    evaluates it: (z (P, 8, 128) f32, hit (P, 8, 128) bool), hit = all
    edges >= 0, inside the column guard and z in [0, 1]."""
    px = torch.arange(TILE_W, dtype=torch.float32,
                      device=records.device).reshape(1, 1, TILE_W) + 0.5
    py = torch.arange(TILE_H, dtype=torch.float32,
                      device=records.device).reshape(1, TILE_H, 1) + 0.5

    def col(k):
        return records[:, k].reshape(-1, 1, 1)

    # ((A*px) + (B*py)) + C: A*px and B*py are multiplied once per pair
    # and column or row, then broadcast-added over the tile, as the kernel
    # does
    def plane(a, b, c):
        return (col(a) * px + col(b) * py) + col(c)

    hit = plane(0, 3, 6) >= 0.0
    hit &= plane(1, 4, 7) >= 0.0
    hit &= plane(2, 5, 8) >= 0.0
    if with_xrange:
        hit &= (px >= col(13)) & (px < col(14))
    z = plane(9, 10, 11)
    return z, hit & (z >= 0.0) & (z <= 1.0)


def rasterize_plain(records: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, width: int, height: int,
                    with_ids: bool = True, with_xrange: bool = False,
                    tile_offset: int = None):
    """What the raster kernel computes, in plain tensor ops, with
    raster_tiles' arguments (a band when tile_offset is given).

    Every pair of the grid's runs is evaluated against its tile's pixels
    in chunks of pairs; the per-pixel min z (clear 1.0) is a
    scatter_reduce(amin), and the id is the smallest id among the pairs
    whose z equals that min (below the 1.0 clear). Reads the grid's pair
    range back to the host."""
    dev = records.device
    ntx, off, num_tiles = _launch_grid(starts, counts, width, height,
                                       tile_offset)
    nty = num_tiles // ntx
    P = TILE_H * TILE_W
    lane = torch.arange(P, device=dev)
    # the grid's runs are one contiguous pair range, tile by tile
    ends = (starts + counts)[off:off + num_tiles]
    first = int(starts[off])
    n_valid = int(ends[-1])

    def chunks():
        for c0 in range(first, n_valid, _PLAIN_CHUNK):
            c1 = min(c0 + _PLAIN_CHUNK, n_valid)
            j = torch.arange(c0, c1, dtype=torch.int32, device=dev)
            tile = torch.searchsorted(ends, j, right=True).long()
            r = records[c0:c1]
            z, hit = pair_hits(r, with_xrange)
            pix = tile[:, None] * P + lane  # flat (tile, lane) index
            yield r, z.reshape(-1, P), hit.reshape(-1, P), pix

    depth = torch.ones(num_tiles * P, dtype=torch.float32, device=dev)
    for _, z, hit, pix in chunks():
        zm = torch.where(hit, z, torch.full_like(z, float("inf")))
        depth.scatter_reduce_(0, pix.reshape(-1), zm.reshape(-1), "amin")
    tid = None
    if with_ids:
        none = torch.iinfo(torch.int32).max
        best = torch.full((num_tiles * P,), none, dtype=torch.int32,
                          device=dev)
        for r, z, hit, pix in chunks():
            win = hit & (z == depth[pix]) & (z < 1.0)
            ids = r[:, 12:13].to(torch.int32).expand_as(z)
            cand = torch.where(win, ids, torch.full_like(ids, none))
            best.scatter_reduce_(0, pix.reshape(-1), cand.reshape(-1),
                                 "amin")
        tid = torch.where(best == none, torch.full_like(best, -1), best)
        tid = _assemble(tid, ntx, nty, width, height)
    return _assemble(depth, ntx, nty, width, height), tid


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("raster.cu", "crychic_raster", {
    "crychic_raster": ([_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp,
                        _ci, _vp], _ci),
    "crychic_raster_field": ([_vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _vp,
                              _vp, _ci, _vp], _ci),
}, error="crychic_raster_error")


def _check_cuda_inputs(fn: str, records: torch.Tensor, field_axis: int,
                       starts: torch.Tensor, counts: torch.Tensor):
    """Raise ValueError unless the kernel can take these tensors: records
    a contiguous, 16-byte aligned 2-D f32 tensor with its REC_ROWS fields
    along field_axis and a multiple of TRI_BLOCK pairs along the other,
    starts and counts contiguous int32 on the same device."""
    if records.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {records.device}")
    if (records.dtype != torch.float32 or records.dim() != 2
            or records.shape[field_axis] != REC_ROWS
            or not records.is_contiguous() or records.data_ptr() % 16):
        shape = ("(P, 16)", "(16, P)")[1 - field_axis]
        raise ValueError(f"records must be a contiguous, 16-byte aligned "
                         f"{shape} float32 tensor")
    pairs = records.shape[1 - field_axis]
    if pairs % TRI_BLOCK:
        raise ValueError(f"pair capacity {pairs} is not a multiple of "
                         f"{TRI_BLOCK}")
    for name, t in (("starts", starts), ("counts", counts)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != records.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{records.device}")


def _launch(entry: str, variant: str, records: torch.Tensor, args,
            width: int, height: int, with_ids: bool, with_xrange: bool):
    """Allocate the outputs and launch the C entry (records pointer, then
    args, then the output pointers and the column-guard flag), counted in
    the tally as "raster.<variant>" (ops/tally.RASTER_VARIANTS). Returns
    (depth, tid)."""
    dev = records.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = (torch.empty((height, width), dtype=torch.int32, device=dev)
           if with_ids else None)
    LIBRARY.launch(entry, dev, records.data_ptr(), *args, depth.data_ptr(),
                   tid.data_ptr() if with_ids else None, int(with_xrange),
                   key="raster." + variant)
    return depth, tid


def raster_tiles(records: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, width: int, height: int,
                 with_ids: bool = True, with_xrange: bool = False,
                 tile_offset: int = None):
    """The raster kernel's wrapper: (depth (height, width) f32, tid
    (height, width) i32 or None). CPU tensors take rasterize_plain; CUDA
    tensors launch the kernel of csrc/raster.cu on the current stream, or
    raise.

    tile_offset None: the full screen, starts/counts indexed by tile.
    tile_offset an int: a band launch (K3) of height / TILE_H whole tile
    rows, whose tile b reads key tile_offset + b of the band binning's
    starts/counts and lands at row (b // ntx) * TILE_H (see band_grid)."""
    if records.device.type == "cpu":
        return rasterize_plain(records, starts, counts, width, height,
                               with_ids, with_xrange, tile_offset)
    _check_cuda_inputs("raster_tiles", records, 1, starts, counts)
    ntx, off, grid = _launch_grid(starts, counts, width, height, tile_offset)
    variant = "ids" if with_ids else "depth"
    if tile_offset is not None:
        variant = "band_" + variant
    return _launch("crychic_raster", variant, records,
                   (starts.data_ptr(), counts.data_ptr(), off, grid, ntx,
                    width, height), width, height, with_ids, with_xrange)


def raster_tiles_field(records_t: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, width: int, height: int,
                       with_ids: bool = True, with_xrange: bool = False):
    """The field-major launch (K4) of the full screen: records_t is the
    (16, P) transpose of build_records' (P, 16), the layout the Pallas
    kernels read. Same outputs as raster_tiles, bit for bit. CPU tensors
    take rasterize_plain on the pair-major view; CUDA tensors launch
    csrc/raster.cu's field-major kernel, or raise."""
    if records_t.device.type == "cpu":
        return rasterize_plain(records_t.t(), starts, counts, width, height,
                               with_ids, with_xrange)
    _check_cuda_inputs("raster_tiles_field", records_t, 0, starts, counts)
    ntx, _, grid = _launch_grid(starts, counts, width, height, None)
    return _launch("crychic_raster_field",
                   "field_ids" if with_ids else "field_depth", records_t,
                   (records_t.shape[1], starts.data_ptr(), counts.data_ptr(),
                    grid, ntx, width, height), width, height, with_ids,
                   with_xrange)
