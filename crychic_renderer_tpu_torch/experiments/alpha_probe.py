"""Where the alpha-tested layer's time goes: the two alpha stages of the
fence scene's frame (passes/frame.alpha_merge_main, the depth peel of the
main view and its merge, and alpha_merge_shadow, the 4 cascades' punch
windows) under torch.profiler.

    python -m crychic_renderer_tpu_torch.experiments.alpha_probe \
        [--reps 5] [--device cpu --small]

fence_scene with the synthetic wire grid (models/scenes_baseline
.wire_fence_chain) at 1920x1080 (--small: 240x135). For each stage, per
call: the host ms (the host clock around `reps` calls ending in a
synchronize, after one warm-up: app/profiler's method), the device ms
and launches (torch.profiler's CUDA kernel and memcpy records), the
host's synchronizing CUDA runtime calls (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaMemcpy: each one waits for the device), and
the 8 operators with the most host time. Prints the card (nvidia-smi
name, power limit) and one JSON line. On the CPU it prints host times
only.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def fence_inputs(device, small: bool):
    """(stage name -> fn) of the fence frame's two alpha stages, on the
    Renderer's own scene, constants, raster and shadow maps."""
    from ..app.renderer import Renderer, synthetic_wire_fence
    from ..models.scenes_baseline import fence_scene
    from ..ops import raster
    from ..passes import frame as fr

    scene, cfg, lights = fence_scene(alpha_test=True)
    cfg = dataclasses.replace(cfg, width=240 if small else 1920,
                              height=135 if small else 1080)
    with synthetic_wire_fence():
        r = Renderer(scene, cfg, lights=lights, device=device)
    s, c, cfg = r.device_scene, r.frame_constants(0.0), r.cfg
    tris, attr = fr.main_view_tris(s, c, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    maps = fr.render_shadow_atlas(s, c.shadow_visibility,
                                  c.cascade_view_projs, cfg)
    return {
        "alpha_merge_main": lambda: fr.alpha_merge_main(
            s, c, cfg, depth, tid, tris, attr),
        "alpha_merge_shadow": lambda: fr.alpha_merge_shadow(
            s, c, cfg, maps)}


def stage_report(fn, reps: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..app.profiler import _time

    out = {"host_ms": _time(fn, reps, device)}
    if device.type != "cuda":
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    dev_us, launches = 0.0, 0
    syncs = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()
            launches += 1
        elif e.name.startswith(SYNC_CALLS):
            syncs[e.name] += 1
    top = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                 reverse=True)[:8]
    out.update(
        device_ms=dev_us / 1000.0 / reps, launches=launches / reps,
        syncs={k: v / reps for k, v in syncs.items()},
        top_host=[{"op": a.key[:60], "calls": a.count / reps,
                   "self_host_ms": a.self_cpu_time_total / 1000.0 / reps}
                  for a in top])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="240x135 (quick CPU runs)")
    args = ap.parse_args(argv)
    from ..app.renderer import resolve_device

    device = resolve_device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {name: stage_report(fn, args.reps, device)
              for name, fn in fence_inputs(device, args.small).items()}
    for name, rep in report.items():
        print(f"{name}: {rep}", flush=True)
    print(json.dumps({"card": card, "small": args.small, "reps": args.reps,
                      "stages": report}))


if __name__ == "__main__":
    main()
