"""K5: the raster kernel launched alone, inside a piece-by-piece timing of
binning and the record build (torch counterpart of
``experiments/bin_decomp_probe.py``).

``rasterize`` = ``bin_triangles`` (per-triangle tile bbox, the
triangle-of-pair search over the exclusive cumsum of bbox counts, the
packed gather, the stable key sort, the per-tile histogram + cumsum) +
``build_records`` + the raster kernel. ``pieces`` builds each piece on
the precomputed outputs of the pieces before it, with the shapes
``bin_triangles`` gives them; ``decompose`` times each. The triangle-of-
pair search is the port's counterpart of the JAX package's marks scatter
+ cumsum. ``kernel_only`` is K5: ``raster.raster_tiles`` on precomputed
starts, counts and records.

Run on the card (config 4 at 1080p: the atlas and the main view)::

    python -m crychic_renderer_tpu_torch.experiments.bin_decomp_probe

On the CPU (plain versions, 1/8 size, host-clock CPU times)::

    python -m crychic_renderer_tpu_torch.experiments.bin_decomp_probe \
        --device cpu --small
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import raster
from ..ops import rasterizer as rz
from . import config4_views, device_name, time_ms


def pieces(tris: rz.ScreenTris, width: int, height: int, cap: int,
           xrange=None, with_ids: bool = True) -> dict:
    """{piece: fn} in pipeline order for the full screen: fn() runs the
    piece on the outputs of the pieces before it, computed here once.
    "bin_triangles", "rasterize" and "build_records" are the port's own
    functions; the pieces between them repeat bin_triangles' steps."""
    TH, TW = raster.TILE_H, raster.TILE_W
    ntx = -(-width // TW)
    num_keys = ntx * -(-height // TH)
    dev = tris.xy.device

    tx0, ty0, bw, bh, _, _ = rz._tile_bbox(tris, width, height, TH, TW)
    counts = bw * bh
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    offsets = ends - counts
    total = ends[-1]
    pair_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    packed = torch.stack([offsets, bw, tx0, ty0], dim=-1)

    def tri_of_pair():
        found = torch.searchsorted(offsets, pair_idx, right=True,
                                   out_int32=True) - 1
        return torch.clamp(found, 0, counts.shape[0] - 1)

    top = tri_of_pair()

    def packed_gather():
        return packed[top.long()]

    pp = packed_gather()
    slot = pair_idx - pp[:, 0]
    bw_p = torch.clamp(pp[:, 1], min=1)
    ty = pp[:, 3] + torch.div(slot, bw_p, rounding_mode="floor")
    tx = pp[:, 2] + torch.remainder(slot, bw_p)
    valid = pair_idx < torch.clamp(total, max=cap)
    tile_id = torch.where(valid, ty * ntx + tx,
                          torch.full_like(ty, num_keys))

    def key_sort():  # -> (sorted_tile, order)
        sorted_tile, perm = torch.sort(tile_id, stable=True)
        return sorted_tile, top[perm]

    def histogram():  # -> (starts, counts)
        hist = torch.zeros(num_keys + 1, dtype=torch.int32, device=dev)
        hist = hist.scatter_add_(0, tile_id.long(),
                                 torch.ones_like(tile_id))[:num_keys]
        return torch.cumsum(hist, 0, dtype=torch.int32) - hist, hist

    bins = rz.bin_triangles(tris, width, height, cap)
    records = raster.build_records(tris, bins, ntx, num_keys, xrange)
    guard = xrange is not None
    return {
        "bin_triangles": lambda: rz.bin_triangles(tris, width, height, cap),
        "tile_bbox": lambda: rz._tile_bbox(tris, width, height, TH, TW),
        "tri_of_pair": tri_of_pair,
        "packed_gather": packed_gather,
        "key_sort": key_sort,
        "histogram": histogram,
        "build_records": lambda: raster.build_records(tris, bins, ntx,
                                                      num_keys, xrange),
        "kernel_only": lambda: raster.raster_tiles(
            records, bins.starts, bins.counts, width, height, with_ids,
            guard),
        "rasterize": lambda: raster.rasterize(tris, width, height, cap,
                                              with_ids, xrange),
    }


def decompose(name, tris, width, height, cap, xrange=None, with_ids=True,
              reps: int = 10) -> dict:
    """{piece: ms} of every piece of ``pieces``, each timed alone after
    one warm-up (CUDA events on the card, the host clock on the CPU), and
    printed."""
    dev = tris.xy.device
    print(f"== {name}: {width}x{height}, cap={cap} ({device_name(dev)}) ==",
          flush=True)
    report = {}
    for piece, fn in pieces(tris, width, height, cap, xrange,
                            with_ids).items():
        report[piece] = time_ms(fn, reps, dev)
        print(f"  {piece:14s} {report[piece]:10.4f} ms", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="1/8 size (quick CPU runs)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    report = {"device": device_name(dev)}
    for name, tris, W, H, cap, xr, ids in reversed(
            config4_views(dev, args.small)):
        report[name] = decompose(name, tris, W, H, cap, xr, ids, args.reps)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
