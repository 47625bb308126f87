"""CLI frame runner.

Usage::

    python -m crychic_renderer_tpu_torch.app.run --config 4 --device cuda \
        --frames 10 --out frame.png [--small]

Renders N frames of a BASELINE config on the given device and writes the
last one as PNG. Prints the median ms per frame (host clock around each
frame, ending in a device synchronize).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", type=str, default="crychic_frame.png")
    ap.add_argument("--small", action="store_true",
                    help="render at 1/8 resolution (quick CPU runs)")
    args = ap.parse_args()

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer, write_png

    scene, cfg, lights = CONFIGS[args.config]()
    if args.small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 8, height=cfg.height // 8,
            shadow_map_size=max(cfg.shadow_map_size // 8, 128))

    device = torch.device(args.device)
    print(f"config {args.config}: {cfg.width}x{cfg.height} on {device}, "
          f"tris={scene.opaque.num_triangles}")
    t0 = time.perf_counter()
    r = Renderer(scene, cfg, lights=lights, device=device)
    print(f"scene build: {time.perf_counter() - t0:.2f} s, "
          f"pair_capacity={r.cfg.pair_capacity} "
          f"shadow_pair_capacity={r.cfg.shadow_pair_capacity}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    img = r.render(0.0)  # first frame builds the kernel
    sync()
    times = []
    for i in range(args.frames):
        t0 = time.perf_counter()
        img = r.render(i / 60.0)
        sync()
        times.append(time.perf_counter() - t0)
    r.check_overflow()
    ms = 1000.0 * float(np.median(times))
    print(f"ms/frame: {ms:.3f} (median of {args.frames})")
    write_png(args.out, np.clip(img.cpu().numpy(), 0.0, 1.0))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
