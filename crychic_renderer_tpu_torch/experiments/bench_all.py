"""Amortized ms/frame of the five BASELINE configs, and of configs 4 and 5
with the fast preset, on one card: the port's counterpart of the
repository's ``experiments/bench_all.py``.

    python -m crychic_renderer_tpu_torch.experiments.bench_all
    python -m crychic_renderer_tpu_torch.experiments.bench_all \
        --device cpu --small

Prints the card line (nvidia-smi name, power limit), then one JSON line
per config: one warm-up frame read back (on the card it captures the
Renderer's CUDA graph after one eager frame), then N_FRAMES frames queued
back to back, each a replay, and one read back (bench.frame_rounds, one
round), the overflow flags checked after the clock, with the hand
kernels' launches over the 1 + N_FRAMES frames and the eager frame. Configs 2, 3 and 5 load their files as the
bench does (bench.assets: the reference's, else the synthetic set;
config 5 with the set's sky cube, as chip_smoke.py phases 20-21). Any
failure raises and exits non-zero. ``--small`` renders 160x90 with 128^2
maps, 1 frame per config, for the CPU tests.
"""
from __future__ import annotations

import argparse
import json

from .. import bench

N_FRAMES = 12
CELLS = ((1, False), (2, False), (3, False), (4, False), (4, True),
         (5, False), (5, True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="160x90, 128^2 maps, 1 frame per config (CPU "
                         "tests)")
    args = ap.parse_args(argv)

    from ..app.renderer import Renderer, resolve_device
    from ..models import scenes_baseline as sb

    device = resolve_device(args.device)
    n = 1 if args.small else N_FRAMES
    print(f"card: {bench.card(device)}", flush=True)
    with bench.assets(args.small) as (kw, source):
        for c, fast in CELLS:
            scene, cfg, lights = sb.CONFIGS[c]()
            if fast:
                cfg = cfg.fast_preset()
            if args.small:
                cfg = bench.shrink(cfg)
            r = Renderer(scene, cfg, lights=lights, device=device,
                         **bench.renderer_files(c, kw))
            (ms,), launches = bench.frame_rounds(r, n, 1)
            line = dict(config=c, fast=fast, ms_per_frame=ms, frames=n,
                        size=f"{cfg.width}x{cfg.height}",
                        assets=(source if c in bench.LOADS_FILES
                                else "built in"),
                        kernel_launches=launches)
            print(json.dumps(line), flush=True)
            del r


if __name__ == "__main__":
    main()
