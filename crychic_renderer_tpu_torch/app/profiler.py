"""Per-stage profiling of the frame (torch counterpart of
``crychic_renderer_tpu.app.profiler``).

``profile_frame(renderer)`` times each stage of ``passes/frame.render_frame``
on its own, with the JAX profiler's keys so the two reports line up:
``tri_attrs``, ``tri_setup``, ``bin_main`` (binning + records of the main
view), ``raster_main`` (bin + records + K1), ``resolve_gbuffer``,
``shadow_maps_x4`` (``render_shadow_maps``: the atlas's bin + records +
K2), ``ssao``, ``lighting`` (with the debug overlay) and ``TOTAL_fused``
(the Renderer's frame whole). ``bin_main`` is also inside ``raster_main``,
so the stages sum to more than the frame. With ``cfg.use_pallas`` False
the stages are the JAX profiler's XLA branch: no ``bin_main``,
``raster_main`` the pure-tensor binned raster (``binned_raster``) and
``shadow_maps_x4`` the per-cascade renders of ``render_shadow_maps``. A frame with the alpha-tested
layer adds two stages the JAX profiler does not have:
``alpha_merge_main`` (the layer's vertex stage, depth peel and merge
into the visibility buffer) after ``raster_main``, and
``alpha_merge_shadow`` (the shadow punch) after ``shadow_maps_x4``.
Forward and Blinn-Phong frames keep the JAX keys (the forward path's
shadow quad is inside ``lighting``).

The JAX profiler jits every stage and times the compiled stage; on the
card each stage here is compiled the same way, captured as its own CUDA
graph (``app/graphs.capture``: one eager run, then the capture) and timed
as the JAX ``_time`` does: one warm-up replay, then the host clock around
`reps` replays ending in ``torch.cuda.synchronize()``. A replay is one
graph launch, so that is the stage's time on the card, not the time
Python takes to issue its kernels. ``TOTAL_fused`` times the frame that
``Renderer.render`` replays (its compiled frame) the same way. On the CPU
the stages and the frame run eagerly, timed alike. ``run_stages`` chains
the stages with the same functions and arguments as ``render_frame``, so
the chain gives its image bit for bit (on the card each stage's output is
its graph's). With a Renderer's tile capacities the ``resolve_gbuffer``,
``ssao`` and ``lighting`` stages run the tile-compacted passes, as the
frame does; the JAX profiler's ``ssao`` stage does not hand its
``ssao_pass`` the coverage, so there it times the dense occlusion.

Usage::

    python -m crychic_renderer_tpu_torch.app.profiler --config 4 \
        [--small] [--reps 5] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..ops import clipping, pcf, raster
from ..ops import rasterizer as rz
from ..passes import frame as fr
from . import graphs


def run_stages(scene: fr.DeviceScene, consts: fr.FrameConstants, cfg,
               stage) -> torch.Tensor:
    """render_frame split into its stages. Each stage is handed to
    stage(name, fn), which must return fn(); the next stage reads that
    output. Returns the (H, W, 4) image chained through the stages."""
    H, W = cfg.height, cfg.width
    dev = consts.view_proj.device

    tri_attr0 = stage("tri_attrs", lambda: fr.tri_attrs(
        scene.opaque, consts.opaque_visibility, consts.view_proj,
        scene.mat_transform))

    def setup():  # main_view_tris after tri_attrs
        ta, valid = clipping.clip_near(
            tri_attr0, torch.ones(tri_attr0.shape[0], dtype=torch.bool,
                                  device=dev))
        return ta, rz.setup_tri_verts(ta[..., :4], valid, W, H)

    tri_attr, tris = stage("tri_setup", setup)
    if cfg.use_pallas:
        stage("bin_main", lambda: raster.binned_records(tris, W, H,
                                                        cfg.pair_capacity))
        depth, tid, _ = stage("raster_main", lambda: raster.rasterize(
            tris, W, H, cfg.pair_capacity))
    else:
        depth, tid, _, _ = stage("raster_main", lambda: rz.binned_raster(
            tris, W, H, cfg.pair_capacity, cfg.bin_cap))
    alpha_on = fr.alpha_enabled(scene, cfg)
    if alpha_on:
        depth, tid, tris, tri_attr = stage(
            "alpha_merge_main", lambda: fr.alpha_merge_main(
                scene, consts, cfg, depth, tid, tris, tri_attr))
    g = stage("resolve_gbuffer", lambda: fr.resolve_gbuffer(
        scene, consts, cfg, tris, depth, tid, tri_attr))
    if cfg.shadows_enabled:
        shadow_maps = stage("shadow_maps_x4", lambda: fr.render_shadow_maps(
            scene, consts, cfg))
        if alpha_on:
            shadow_maps = stage("alpha_merge_shadow",
                                lambda: fr.alpha_merge_shadow(
                                    scene, consts, cfg, shadow_maps))
    else:
        shadow_maps = torch.ones((cfg.num_cascades, 2, 2),
                                 dtype=torch.float32, device=dev)
    if cfg.ssao_enabled:
        access = stage("ssao", lambda: fr.ssao_pass(
            scene, consts, cfg, g["normal_v"], depth, valid=tid >= 0))
        ambient_access = fr._upsample_bilinear(access, H, W)
    else:
        ambient_access = torch.ones((H, W), dtype=torch.float32, device=dev)
    return stage("lighting", lambda: fr.apply_debug_overlay(
        consts, cfg, fr.lighting_pass(scene, consts, cfg, g, shadow_maps,
                                      ambient_access, depth),
        shadow_maps, g["pos_w"]))


def _time(fn, reps: int, device: torch.device) -> float:
    """Host-clock ms per call over `reps` calls after one warm-up, ending
    in a device synchronize on a CUDA device."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1000.0 * (time.perf_counter() - t0) / reps


def _graph_time(fn, reps: int, device: torch.device):
    """fn captured as a CUDA graph (graphs.capture, after one eager run)
    and _time of its replays: (fn's output in the graph, which the
    replays leave holding fn's result, ms per replay). The graph, its
    pool and its maps are freed before it returns; the output stays."""
    maps, pieces = pcf.OwnedMaps(), graphs.Pieces()
    try:
        out, _, _, launches = graphs.capture(fn, device, maps, pieces)

        def replay():
            pieces.replay()
            graphs.add_launches(launches)

        return out, _time(replay, reps, device)
    finally:
        torch.cuda.synchronize(device)
        pieces.reset()
        maps.release()


def profile_frame(renderer, total_time: float = 0.0, reps: int = 5) -> dict:
    """{stage: ms} of the renderer's frame at `total_time` (see the module
    doc), with TOTAL_fused last."""
    scene, cfg, dev = renderer.device_scene, renderer.cfg, renderer.device
    consts = renderer.frame_constants(total_time)
    report = {}

    def timed(name, fn):
        if dev.type == "cuda":
            out, report[name] = _graph_time(fn, reps, dev)
            return out
        report[name] = _time(fn, reps, dev)
        return fn()

    run_stages(scene, consts, cfg, timed)
    report["TOTAL_fused"] = _time(lambda: renderer.render(total_time), reps,
                                  dev)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--small", action="store_true",
                    help="1/4 size, as the JAX profiler's --small")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer

    scene, cfg, lights = CONFIGS[args.config]()
    if args.small:
        cfg = dataclasses.replace(cfg, width=cfg.width // 4,
                                  height=cfg.height // 4,
                                  shadow_map_size=cfg.shadow_map_size // 4)
    r = Renderer(scene, cfg, lights=lights, device=args.device)
    report = profile_frame(r, reps=args.reps)
    where = (torch.cuda.get_device_name(r.device)
             if r.device.type == "cuda" else "cpu")
    how = ("CUDA graph replays" if r.device.type == "cuda"
           else "eager calls")
    print(f"config {args.config} {r.cfg.width}x{r.cfg.height} on {where}, "
          f"host clock per stage over {args.reps} {how} after 1 warm-up, "
          f"ending in a synchronize")
    for k, v in report.items():
        print(f"{k:20s} {v:10.2f} ms")
    print(json.dumps({"device": where, "config": args.config,
                      "width": r.cfg.width, "height": r.cfg.height,
                      "ms": report}))


if __name__ == "__main__":
    main()
