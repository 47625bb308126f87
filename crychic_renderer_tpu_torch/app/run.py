"""CLI frame runner.

Usage::

    python -m crychic_renderer_tpu_torch.app.run --config 4 --device cuda \
        --frames 10 --out frame.png [--small] [--fast] [--soft-pcf] \
        [--profile]

Renders N frames of a BASELINE config on the given device and writes the
last one as PNG. Prints the median ms per frame (host clock around each
frame, ending in a device synchronize). With --profile (on the card) it
then renders 3 more frames under torch.profiler (CUDA activity only) and
prints one JSON line: the card, the median ms/frame, device time and
device launches per frame (kernels and copies), the busy share (device
time / median frame time) and the 8 kernels that take the most device
time per frame, with their launches per frame.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch


def profile_frames(r, frame_ms, opts, frames=3, top=8):
    """Render `frames` frames under torch.profiler and print the JSON line
    of the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            r.render(i / 60.0)
        torch.cuda.synchronize()
    r.check_overflow()
    ms_by_name = collections.Counter()
    n_by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_by_name[e.name] += e.time_range.elapsed_us() / 1000.0
            n_by_name[e.name] += 1
    device_ms = sum(ms_by_name.values()) / frames
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, **opts, "frame_ms": frame_ms,
        "device_ms_per_frame": device_ms,
        "device_launches_per_frame": sum(n_by_name.values()) / frames,
        "busy_share": device_ms / frame_ms,
        "top": [{"name": name[:80], "ms_per_frame": ms / frames,
                 "launches_per_frame": n_by_name[name] / frames}
                for name, ms in ms_by_name.most_common(top)]}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", type=str, default="crychic_frame.png")
    ap.add_argument("--small", action="store_true",
                    help="render at 1/8 resolution (quick CPU runs)")
    ap.add_argument("--fast", action="store_true",
                    help="performance preset: half-res shadow factor, "
                         "quarter-res SSAO, trilinear texturing")
    ap.add_argument("--soft-pcf", action="store_true",
                    help="the 2.5-texel soft Poisson PCF disk "
                         "(pcf_radius_texels=2.5)")
    ap.add_argument("--profile", action="store_true",
                    help="device profile of 3 more frames (card only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.profile and device.type != "cuda":
        ap.error("--profile reads device time: run it with --device cuda")

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer, write_png

    scene, cfg, lights = CONFIGS[args.config]()
    if args.fast:
        cfg = cfg.fast_preset()
    if args.soft_pcf:
        cfg = dataclasses.replace(cfg, pcf_radius_texels=2.5)
    if args.small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 8, height=cfg.height // 8,
            shadow_map_size=max(cfg.shadow_map_size // 8, 128))

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

    img = r.render(0.0)  # builds the kernels, captures the frame's graph
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
    if args.profile:
        profile_frames(r, ms, dict(config=args.config, fast=args.fast,
                                   soft_pcf=args.soft_pcf))


if __name__ == "__main__":
    main()
