"""K4: the raster kernel on field-major records (torch counterpart of
``experiments/fma_kernel_probe.py``).

The JAX probe times ``_fma_kernel``, the raster kernel with its planes as
broadcast FMAs, on its records in two layouts: ``'t'``, the shipping
(16, NB, TB) field-major blocks transposed inside the kernel, and ``'l'``,
(NB, TB, 16) pair-major. Both compute what K1/K2 compute. Here:

- ``'t'`` launches ``raster.raster_tiles_field`` on the (16, P) transpose
  of ``build_records``' output (csrc/raster.cu's field-major kernel);
- ``'l'`` launches ``raster.raster_tiles`` on ``build_records``' own
  (P, 16) layout, the shipping K1/K2 launch.

The plain version of both is ``rasterize_plain`` on the pair-major
records. The TPU's ``tiles_per_prog`` has no counterpart: one block per
tile.

Run on the card (config 4 at 1080p, both of the frame's launches)::

    python -m crychic_renderer_tpu_torch.experiments.fma_kernel_probe

On the CPU (plain versions, 1/8 size, host-clock CPU times)::

    python -m crychic_renderer_tpu_torch.experiments.fma_kernel_probe \
        --device cpu --small
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import raster
from . import config4_views, device_name, time_ms

LAYOUTS = ("t", "l")


def rasterize_fma(tris, width, height, pair_capacity, with_ids=True,
                  xrange=None, layout="t"):
    """Bin, build records and raster the full screen with the records in
    `layout` ("t" field-major, "l" pair-major). Returns (depth (H, W) f32,
    tid (H, W) i32 or None), equal to raster.rasterize's."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    records, starts, counts, _ = raster.binned_records(
        tris, width, height, pair_capacity, xrange)
    if layout == "l":
        return raster.raster_tiles(records, starts, counts, width, height,
                                   with_ids, xrange is not None)
    return raster.raster_tiles_field(records.t().contiguous(), starts,
                                     counts, width, height, with_ids,
                                     xrange is not None)


def _equal(a, b) -> bool:
    return torch.equal(a[0], b[0]) and (
        (a[1] is None and b[1] is None) or torch.equal(a[1], b[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="1/8 size (quick CPU runs)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    report = {"device": device_name(dev)}
    for name, tris, W, H, cap, xr, ids in config4_views(dev, args.small):
        rec, starts, counts, over = raster.binned_records(tris, W, H, cap,
                                                          xr)
        if bool(over):
            raise RuntimeError(f"{name}: pair capacity {cap} overflowed")
        ship = raster.raster_tiles(rec, starts, counts, W, H, ids,
                                   xr is not None)
        rec_t = rec.t().contiguous()
        kernel = {
            "t": lambda: raster.raster_tiles_field(rec_t, starts, counts, W,
                                                   H, ids, xr is not None),
            "l": lambda: raster.raster_tiles(rec, starts, counts, W, H, ids,
                                             xr is not None)}
        pairs = int(counts.sum())
        print(f"== {name}: {W}x{H}, {pairs} pairs, capacity {cap} ==",
              flush=True)
        for layout in LAYOUTS:
            out = rasterize_fma(tris, W, H, cap, ids, xr, layout)
            ms = time_ms(kernel[layout], args.reps, dev)
            full_ms = time_ms(lambda lo=layout: rasterize_fma(
                tris, W, H, cap, ids, xr, lo), args.reps, dev)
            equal = _equal(out, ship)
            report[f"{name} {layout}"] = dict(
                pairs=pairs, kernel_ms=ms, rasterize_fma_ms=full_ms,
                equal_to_shipping=equal)
            print(f"  layout {layout}: kernel {ms:.4f} ms, rasterize_fma "
                  f"{full_ms:.4f} ms ({report['device']}); equal to the "
                  f"shipping launch (torch.equal): {equal}", flush=True)
    print(json.dumps(report))
    if not all(v["equal_to_shipping"] for k, v in report.items()
               if k != "device"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
