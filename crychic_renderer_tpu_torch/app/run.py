"""CLI frame runner.

Usage::

    python -m crychic_renderer_tpu_torch.app.run --config 4 --device cuda \
        --frames 10 --out frame.png [--small] [--fast] [--soft-pcf] \
        [--orbit] [--stats] [--profile]

Renders N frames of a BASELINE config on the given device and writes the
last one as PNG. Prints the median ms per frame (host clock around each
frame, ending in a device synchronize). The options are the JAX
package's (``crychic_renderer_tpu.app.run``), with ``--device`` for its
``--backend``:

- ``--small``: 1/4 of the width and height, shadow maps of
  max(S // 4, 128), half the pair capacities (the Renderer then sizes
  them from the scene, as the JAX one does);
- ``--orbit``: the camera turns 0.05 rad about y before each timed
  frame; on the card each frame is a replay of the one captured graph,
  which reads the moved camera from the packed constants;
- ``--stats``: after the timed frames, ``check_capacity(0.0)`` (raises
  on overflow), then one JSON line: ms_per_frame, fps, config, capacity
  (the counts of capacity_requirements), pair_capacity and
  shadow_pair_capacity.

With --profile the Renderer traces its frames (``trace=True``,
app/profiler.FrameTrace), and after the timed frames it renders 3 more
under torch.profiler and prints one JSON line: the card, the median
ms/frame of the timed frames, and over the 3 frames the trace's
``replay_ms`` (each stage's median ms inside the frame's replay, from
the marks the graph records; host ms on the CPU), ``host_ms`` (the mean
ms of each part of render(): constants, cull, upload, launch) and
``occupancy`` (100 x the median count over its capacity: the pairs of
both rasters, the tiles of the compacted resolve and SSAO), then the 8
kernels that take the most device time per frame (on the CPU the ops by
their own CPU time), with their launches per frame. That line comes
last, after the --stats line.

``main`` returns the Renderer and the last frame (an (H, W, 4) tensor on
the device).
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
    """Render `frames` frames of the traced Renderer r under
    torch.profiler and print the JSON line of the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    from .profiler import trace_summary

    cuda = r.device.type == "cuda"
    first = r.trace.frames
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        for i in range(frames):
            r.render(i / 60.0)
        if cuda:
            torch.cuda.synchronize()
    r.check_overflow()
    traced = trace_summary(r.trace.rows(since=first), r.cfg)
    want = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    ms_by_name = collections.Counter()
    n_by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == want:
            us = e.time_range.elapsed_us() if cuda else e.self_cpu_time_total
            ms_by_name[e.name] += us / 1000.0
            n_by_name[e.name] += 1
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card, **opts, "frame_ms": frame_ms,
        "replay_ms": traced["replay_ms"], "host_ms": traced["host_ms"],
        "occupancy": traced["occupancy"],
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
                    help="render at 1/4 resolution (quick CPU runs)")
    ap.add_argument("--stats", action="store_true",
                    help="check the capacities and print a JSON line")
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera across frames (demo/stability)")
    ap.add_argument("--fast", action="store_true",
                    help="performance preset: half-res shadow factor, "
                         "quarter-res SSAO, trilinear texturing")
    ap.add_argument("--soft-pcf", action="store_true",
                    help="the 2.5-texel soft Poisson PCF disk "
                         "(pcf_radius_texels=2.5)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the frames; profile 3 more")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer, write_png

    scene, cfg, lights = CONFIGS[args.config]()
    if args.fast:
        cfg = cfg.fast_preset()
    if args.soft_pcf:
        cfg = dataclasses.replace(cfg, pcf_radius_texels=2.5)
    if args.small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 4, height=cfg.height // 4,
            shadow_map_size=max(cfg.shadow_map_size // 4, 128),
            pair_capacity=cfg.pair_capacity // 2,
            shadow_pair_capacity=cfg.shadow_pair_capacity // 2)

    print(f"config {args.config}: {cfg.width}x{cfg.height} on {device}, "
          f"tris={scene.opaque.num_triangles}")
    t0 = time.perf_counter()
    r = Renderer(scene, cfg, lights=lights, device=device,
                 trace=args.profile)
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
        if args.orbit:
            r.camera.rotate_y(0.05)
        t0 = time.perf_counter()
        img = r.render(i / 60.0)
        sync()
        times.append(time.perf_counter() - t0)
    r.check_overflow()
    ms = 1000.0 * float(np.median(times))
    print(f"ms/frame: {ms:.3f} (median of {args.frames})")
    write_png(args.out, np.clip(img.cpu().numpy(), 0.0, 1.0))
    print(f"wrote {args.out}")
    if args.stats:
        req = r.check_capacity(0.0)  # raises on overflow
        # the counts by name, as the JAX package's jitted dict returns them
        print(json.dumps({"ms_per_frame": ms, "fps": 1000.0 / ms,
                          "config": args.config,
                          "capacity": {k: int(v)
                                       for k, v in sorted(req.items())},
                          "pair_capacity": r.cfg.pair_capacity,
                          "shadow_pair_capacity":
                              r.cfg.shadow_pair_capacity}))
    if args.profile:
        profile_frames(r, ms, dict(config=args.config, fast=args.fast,
                                   soft_pcf=args.soft_pcf))
    return r, img


if __name__ == "__main__":
    main()
