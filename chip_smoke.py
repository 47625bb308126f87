"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's main path, BASELINE config 4 at 1920x1080 (deferred
PBR, 4-cascade 2048^2 shadow atlas, half-res SSAO, procedural sky),
through ``crychic_renderer_tpu_torch.app.renderer.Renderer`` on ``cuda``,
and checks the hand-written raster kernel (csrc/raster.cu) that carries
both of its raster launches. Phases, each printed as it ends:

1. the card's name and power limit (nvidia-smi);
2. the kernel built from the checkout's source with nvcc, and its time;
3. the Renderer at 1080p, with the capacities it sized (the atlas pair
   count is what the atlas binning expands);
4. the kernel on the frame's own main-view (K1) and atlas (K2) inputs,
   equal to rasterize_plain bit for bit (torch.equal), with the kernel's
   and the plain version's times from CUDA events after warm-up;
5. a 1/8-size config-4 frame on the card against the same frame rendered
   by the port's CPU path (plain raster; itself held against the JAX
   package by tests/test_torch_frame.py): <= 0.5% of pixels > 0.02;
6. 3 warm-up + 10 timed frames through Renderer.render: finite, with
   covered and sky pixels, exactly one K1 and one K2 launch per frame, no
   capacity overflow; the median ms/frame.

Then one JSON line of per-kernel results and, last, the device line. Any
failed phase raises, so the script exits non-zero and prints no result;
so does a machine without CUDA, and a directory without the repository.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES_WARMUP = 3
FRAMES_TIMED = 10
PIX_BOUND = 0.005


def phase(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of fn() on the current stream, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu_torch.ops import raster
    from crychic_renderer_tpu_torch.ops import rasterizer as rz
    from crychic_renderer_tpu_torch.ops import shading
    from crychic_renderer_tpu_torch.passes import frame as fr

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("[1] card (nvidia-smi name, power.limit):")
    print(smi, flush=True)

    # 2. the kernel, built from the checkout
    raster.load_kernel(rebuild=True)
    phase(f"[2] built {raster.library_path()} in "
          f"{raster.BUILD_SECONDS:.2f} s (nvcc {' '.join(raster.NVCC_FLAGS)})")

    # 3. the Renderer at 1080p
    scene, cfg, lights = CONFIGS[4]()
    t0 = time.perf_counter()
    r = Renderer(scene, cfg, lights=lights, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = r.cfg
    req = r.capacity_requirements(0.0)
    consts = r.frame_constants(0.0)
    S = cfg.shadow_map_size
    tw = fr.shadow_tri_world(r.device_scene.shadow, consts.shadow_visibility)
    per_cascade = 0
    for c in range(cfg.num_cascades):
        t = rz.setup_tri_verts(
            shading.rowmat(tw, consts.cascade_view_projs[c]), None, S, S)
        _, _, bw, bh, _, _ = rz._tile_bbox(t, S, S, 8, 128)
        per_cascade += int((bw * bh).sum())
    phase(f"[3] Renderer {cfg.width}x{cfg.height} built in {build_s:.2f} s: "
          f"main pairs {req['main_pairs']} -> pair_capacity "
          f"{cfg.pair_capacity}; atlas pairs {req['shadow_pairs']} "
          f"(per-cascade count, the JAX package's estimate: {per_cascade})"
          f" -> shadow_pair_capacity {cfg.shadow_pair_capacity}")

    # 4. K1 and K2 on the frame's own inputs, kernel vs plain version
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    atris, xr = fr.shadow_atlas_tris(r.device_scene, consts.shadow_visibility,
                                     consts.cascade_view_projs, cfg)
    launches = [
        ("K1 main view: depth + id (frame.py:1424)", "ids",
         "crychic_renderer_tpu/ops/raster_pallas.py:93",
         raster.binned_records(tris, cfg.width, cfg.height,
                               cfg.pair_capacity),
         cfg.width, cfg.height, True, False),
        ("K2 shadow atlas: depth, column guard (frame.py:415)", "depth",
         "crychic_renderer_tpu/ops/raster_pallas.py:93",
         raster.binned_records(atris, 4 * S, S, cfg.shadow_pair_capacity,
                               xrange=xr),
         4 * S, S, False, True),
    ]
    kernels = []
    for name, variant, replaces, inputs, W, H, ids, xrange in launches:
        rec, starts, counts, over = inputs
        assert not bool(over), f"{name}: capacity overflow"
        d_k, t_k = raster.raster_tiles(rec, starts, counts, W, H,
                                       with_ids=ids, with_xrange=xrange)
        torch.cuda.synchronize()
        d_p, t_p = raster.rasterize_plain(rec, starts, counts, W, H,
                                          with_ids=ids, with_xrange=xrange)
        err = float((d_k - d_p).abs().max())
        if ids:
            err = max(err, float((t_k - t_p).abs().max()))
            assert torch.equal(t_k, t_p), f"{name}: tid differs from plain"
        assert torch.equal(d_k, d_p), f"{name}: depth differs from plain"
        assert bool((d_k < 1.0).any()), f"{name}: nothing rasterized"
        ms = cuda_ms(lambda: raster.raster_tiles(
            rec, starts, counts, W, H, with_ids=ids, with_xrange=xrange), 20)
        plain_ms = cuda_ms(lambda: raster.rasterize_plain(
            rec, starts, counts, W, H, with_ids=ids, with_xrange=xrange), 3)
        phase(f"[4] {name}: {W}x{H}, {int(counts.sum())} pairs, equal to "
              f"rasterize_plain (max |err| {err}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        kernels.append(dict(name=name, route="cuda",
                            source="crychic_renderer_tpu_torch/csrc/raster.cu",
                            replaces=replaces, variant=variant,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # 5. a small frame on the card against the port's CPU path
    small = dataclasses.replace(CONFIGS[4]()[1], width=240, height=135,
                                shadow_map_size=256)
    s_scene, _, s_lights = CONFIGS[4]()
    img_gpu = Renderer(s_scene, small, lights=s_lights,
                       device=dev).render_np(0.0)
    img_cpu = Renderer(s_scene, small, lights=s_lights,
                       device="cpu").render_np(0.0)
    diff = np.abs(img_gpu - img_cpu).max(axis=-1)
    frac = float((diff > 0.02).mean())
    assert np.isfinite(img_gpu).all() and frac <= PIX_BOUND, (
        f"small frame: {frac:.4%} of pixels differ >0.02 from the CPU path")
    phase(f"[5] 240x135 frame on the card vs the CPU path: {frac:.4%} of "
          f"pixels >0.02 (max {diff.max():.3g}, mean {diff.mean():.3g})")

    # 6. the main path: frames through Renderer.render
    raster.reset_launches()
    times = []
    img = None
    for i in range(FRAMES_WARMUP + FRAMES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render(i / 60.0)
        torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t0))
    counts_run = dict(raster.LAUNCHES_BY_VARIANT)
    total = raster.LAUNCHES
    n = FRAMES_WARMUP + FRAMES_TIMED
    r.check_overflow()
    assert total == 2 * n, f"{total} kernel launches for {n} frames"
    assert counts_run == {"ids": n, "depth": n}, counts_run
    img = img.cpu().numpy()
    assert img.shape == (cfg.height, cfg.width, 4)
    assert np.isfinite(img).all(), "non-finite pixels"
    consts = r.frame_constants((n - 1) / 60.0)
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    _, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                 cfg.pair_capacity)
    covered = int((tid >= 0).sum())
    sky = tid.numel() - covered
    assert covered > 0 and sky > 0, (covered, sky)
    ms_frame = statistics.median(times[FRAMES_WARMUP:])
    phase(f"[6] {n} frames ({FRAMES_WARMUP} warm-up): median "
          f"{ms_frame:.3f} ms/frame (min {min(times[FRAMES_WARMUP:]):.3f}); "
          f"launches {counts_run}; {covered} covered, {sky} sky pixels; "
          f"no overflow")

    for k in kernels:
        k["launches"] = counts_run[k.pop("variant")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
