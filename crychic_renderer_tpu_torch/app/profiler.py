"""Per-stage profiling of the frame (torch counterpart of
``crychic_renderer_tpu.app.profiler``).

``profile_frame(renderer)`` times each stage of ``passes/frame.render_frame``
on its own, with the JAX profiler's keys so the two reports line up:
``tri_attrs``, ``tri_setup``, ``bin_main`` (binning + records of the main
view), ``raster_main`` (bin + records + K1), ``resolve_gbuffer``,
``shadow_maps_x4`` (``render_shadow_maps``: the atlas's bin + records +
K2), ``ssao``, ``lighting`` (with the debug overlay) and ``TOTAL_fused``
(the Renderer's frame whole), and two stages the JAX profiler times
inside its ``lighting``: ``shadow_factor`` (light 0's PCF factor, with
shadows on) and ``direct_light`` (the light loops, PBR or Blinn-Phong)
before ``lighting``, which keeps the SSAO upsample, the ambient, the
tonemap, the sky and the overlay. ``bin_main`` is also inside
``raster_main``, so the stages sum to more than the frame. With ``cfg.use_pallas`` False
the stages are the JAX profiler's XLA branch: no ``bin_main``,
``raster_main`` the pure-tensor binned raster (``binned_raster``) and
``shadow_maps_x4`` the per-cascade renders of ``render_shadow_maps``. A frame with the alpha-tested
layer adds two stages the JAX profiler does not have:
``alpha_merge_main`` (the layer's vertex stage, depth peel and merge
into the visibility buffer) after ``raster_main``, and
``alpha_merge_shadow`` (the shadow punch) after ``shadow_maps_x4``.
Forward and Blinn-Phong frames have the same stages (the forward
path's shadow quad is inside ``lighting``).

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

``FrameTrace`` traces the frames the user runs, from inside them: a
Renderer built with ``trace=True`` records, for every ``render()``, the
host time of its four parts, the device time of each stage inside the
compiled frame's own replay, and the counts its capacities bound. Stage
times come from marks that the frame's graph records itself (one
one-thread kernel of ``csrc/frame_trace.cu`` per mark, writing the
card's ``%globaltimer``), so they are the stages' shares of the real
replay, where ``profile_frame`` times each stage alone in a graph of its
own. Rows stay in memory, on the device for the marks and counts, until
``rows()`` reads them after the last frame.

Usage::

    python -m crychic_renderer_tpu_torch.app.profiler --config 4 \
        [--small] [--reps 5] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import statistics
import time
import warnings

import numpy as np
import torch

from ..ops import clipping, pcf, raster, tally
from ..ops import rasterizer as rz
from ..ops.build import KernelLibrary
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
    access = None
    if cfg.ssao_enabled:
        access = stage("ssao", lambda: fr.ssao_pass(
            scene, consts, cfg, g["normal_v"], depth, valid=tid >= 0))
    sf = None
    if cfg.shadows_enabled:
        sf = stage("shadow_factor", lambda: fr.shadow_factor_pass(
            consts, cfg, g, shadow_maps))
    lit = stage("direct_light", lambda: fr.direct_light(scene, consts, cfg,
                                                        g, sf))

    def lighting():
        ambient_access = (
            fr._upsample_bilinear(access, H, W) if access is not None
            else torch.ones((H, W), dtype=torch.float32, device=dev))
        return fr.apply_debug_overlay(
            consts, cfg, fr.finish_lighting(scene, consts, cfg, g, lit,
                                            ambient_access),
            shadow_maps, g["pos_w"])

    return stage("lighting", lighting)


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
            tally.add(launches)

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


# -- the frame trace ---------------------------------------------------------

RING_FRAMES = 4096  # frames the trace keeps (a 51 s window at 40 ms: ~1,300)
# Renderer.render's parts, in order: the rebind check, the camera
# matrices and the cascade fit; the frustum culling; BoltAnim's pairs, the
# pack and the pinned upload; CompiledFrame.__call__ (the static copy,
# the replay, the launch tally and the output's clone)
HOST_PARTS = ("constants", "cull", "upload", "launch")
# the counts the frame's capacities bound (capacity_requirements' keys),
# and the cfg field of each capacity
TRACE_COUNTS = {"main_pairs": "pair_capacity",
                "shadow_pairs": "shadow_pair_capacity",
                "shade_tiles": "shade_tile_capacity",
                "ssao_tiles": "ssao_tile_capacity"}
# the alpha layer's counts, made by frames with the layer: the widest
# light-space extent of the layer over the cascades in texels (its
# capacity the punch window, fr.alpha_window), and per peel of the main
# view the pixels it found a fragment in that stay unresolved after it
# (render_frame's "alpha_unresolved"), for the first TRACE_PEELS peels
TRACE_PEELS = 8
ALPHA_COUNTS = ("alpha_window",) + tuple(f"alpha_unresolved.{p}"
                                         for p in range(TRACE_PEELS))
SPAN_PREFIX = "crychic.render."  # the host parts' profiler ranges
# the light loop's counts, made by frames that shade local lights with
# Blinn-Phong (render_frame's): the (local light, covered pixel) pairs
# within the light's falloff_end, and the covered pixels
LIGHT_COUNTS = ("light_reach_pairs", "covered_pixels")
# the count columns of the ring, in order
_COUNT_KEYS = (*TRACE_COUNTS, *ALPHA_COUNTS, *LIGHT_COUNTS)
# the marks' ring: column 0 the frame, 1 the start mark, 2 + k the end
# mark of fr.FRAME_STAGES[k] (csrc/frame_trace.cu)
_MARK_COLS = 2 + len(fr.FRAME_STAGES)

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("frame_trace.cu", "crychic_frame_trace", {
    "crychic_frame_mark": ([_vp, _vp, _vp, _ci, _ci, _ci, _ci, _vp], _ci),
}, error="crychic_frame_trace_error")


@dataclasses.dataclass
class FrameRow:
    """One traced frame. host_ns: perf_counter_ns at render()'s start and
    at the end of each of HOST_PARTS; stage_ms: the device ms of each
    stage the frame ran, between its mark and the one before, in frame
    order (host ms on the CPU); counts: TRACE_COUNTS', ALPHA_COUNTS' and
    LIGHT_COUNTS' counts the frame made. A frame whose marks the ring no
    longer holds has no stages and no counts."""
    frame: int
    host_ns: tuple
    stage_ms: dict
    counts: dict

    @property
    def host_ms(self) -> dict:
        t = self.host_ns
        return {p: (t[k + 1] - t[k]) / 1e6 for k, p in enumerate(HOST_PARTS)}


class FrameTrace:
    """The frame trace of one Renderer (see the module doc).

    Device side, all in the compiled frame: ``mark(name)`` is
    render_frame's hook. On the card it queues a mark kernel while the
    frame is being captured and does nothing otherwise, so the graph
    holds the marks and the eager frame before the capture records
    nothing; the start mark advances ``counter``, a device int64 that
    counts replays, and each mark writes the card's clock into the
    frame's row of ``marks`` (csrc/frame_trace.cu). ``write_counts(stats)``
    copies the frame's counts into its row of ``counts`` with tensor ops
    (no host read). On the CPU, where the frame runs eagerly, the same
    hook writes ``time.perf_counter_ns()`` into the same rows.

    Host side: ``begin_frame()``, ``part(name)`` around each of
    HOST_PARTS in order and ``end_frame()`` record render()'s spans, and,
    while a profiler records, each as a ``torch.profiler.record_function``
    range named SPAN_PREFIX + part, on the profiler's clock beside the
    kernels. Frame n of the Renderer (its n-th render() since the trace
    began) is the n-th replay, so its host spans and its device row share
    the index.

    Rows are kept for the last RING_FRAMES frames and read by ``rows()``
    once the caller has stopped issuing frames."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ring_frames = R = RING_FRAMES

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=self.device)

        self.marks = zeros(R, _MARK_COLS)
        self.counts = zeros(R, len(_COUNT_KEYS))
        self.counter = zeros(1)  # frames the device has started
        self.row = zeros(1)  # the ring row of the frame in progress
        self._absent = torch.full((TRACE_PEELS,), -1, dtype=torch.int64,
                                  device=self.device)
        self.host = np.zeros((R, 1 + len(HOST_PARTS)), np.int64)
        self.frames = 0  # render() calls traced: the next frame's index
        if self.device.type == "cuda":
            # the first launch of the mark kernel outside any capture, on
            # scratch tensors: the library loads now, not in the graph
            self._launch(zeros(1), zeros(1), zeros(1, _MARK_COLS), 1, 1,
                         True)

    # -- device side ------------------------------------------------------
    def _launch(self, counter, row, ring, rows: int, col: int, start: bool):
        """One mark kernel, not counted in the tally: a traced frame's
        launches equal an untraced one's."""
        LIBRARY.launch("crychic_frame_mark", self.device, counter.data_ptr(),
                       row.data_ptr(), ring.data_ptr(), rows, ring.shape[1],
                       col, int(start), key=None)

    def _recording(self) -> bool:
        """Whether the frame now issued is one the trace records: on the
        card only the capture (the graph's replays run it), on the CPU
        every eager frame."""
        return (self.device.type != "cuda"
                or torch.cuda.is_current_stream_capturing())

    def mark(self, name: str):
        """render_frame's hook: "start", or the stage that just ended."""
        if not self._recording():
            return
        start = name == "start"
        col = 1 if start else 2 + fr.FRAME_STAGES.index(name)
        if self.device.type == "cuda":
            self._launch(self.counter, self.row, self.marks,
                         self.ring_frames, col, start)
            return
        if start:
            f = int(self.counter[0])
            self.counter[0] = f + 1
            self.row[0] = r = f % self.ring_frames
            self.marks[r] = 0
            self.marks[r, 0] = f
        self.marks[int(self.row[0]), col] = time.perf_counter_ns()

    def write_counts(self, stats: dict):
        """Copy the frame's counts (render_frame's stats with the hook
        set; -1 for a count the frame does not make) into its row."""
        if not self._recording():
            return
        one = self._absent[:1]
        peels = stats.get("alpha_unresolved")
        peels = (self._absent if peels is None else torch.cat(
            [peels[:TRACE_PEELS].to(torch.int64),
             self._absent[peels.shape[0]:]]))

        def count(k):
            return stats[k].to(torch.int64).reshape(1) if k in stats else one

        vals = torch.cat([count(k) for k in (*TRACE_COUNTS, ALPHA_COUNTS[0])]
                         + [peels] + [count(k) for k in LIGHT_COUNTS])
        self.counts.index_copy_(0, self.row, vals[None])

    # -- host side --------------------------------------------------------
    def begin_frame(self):
        self.host[self.frames % self.ring_frames, 0] = time.perf_counter_ns()

    @contextlib.contextmanager
    def part(self, name: str):
        """One of HOST_PARTS, then its end time; while a profiler records,
        also a profiler range (made only then: a range costs ~15 us of
        host time, the check ~0.3 us)."""
        if torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.host[self.frames % self.ring_frames,
                  1 + HOST_PARTS.index(name)] = time.perf_counter_ns()

    def end_frame(self):
        self.frames += 1

    def rows(self, since: int = 0) -> list:
        """FrameRow of every frame from `since` to the last, after the
        card has finished them (this waits for it). Where the ring has
        wrapped past `since`, the last RING_FRAMES frames, with a
        warning that says how many were lost."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        marks = self.marks.cpu().numpy()
        counts = self.counts.cpu().numpy()
        n, R = self.frames, self.ring_frames
        first = max(since, n - R, 0)
        if first > since:
            warnings.warn(f"the frame trace's ring holds the last {R} "
                          f"frames: frames {since} to {first - 1} are lost",
                          stacklevel=2)
        out = []
        for f in range(first, n):
            r = f % R
            stage_ms, made = {}, {}
            if marks[r, 0] == f and marks[r, 1]:
                t = marks[r, 1]
                for k, name in enumerate(fr.FRAME_STAGES):
                    end = marks[r, 2 + k]
                    if end:
                        stage_ms[name] = float(end - t) / 1e6
                        t = end
                made = {k: int(v) for k, v in zip(_COUNT_KEYS, counts[r])
                        if v >= 0}
            out.append(FrameRow(f, tuple(int(v) for v in self.host[r]),
                                stage_ms, made))
        return out


def trace_summary(rows: list, cfg) -> dict:
    """The frames' means and medians: host_ms, the mean ms of each host
    part; replay_ms, the median ms of each stage; occupancy, 100 x the
    median of count / capacity (cfg's) of each count the frames made,
    alpha_window's over the punch window; with the alpha layer,
    alpha_unresolved, the median count of each peel; with local lights
    shaded by Blinn-Phong, light_reach, the median of 100 x the (local
    light, covered pixel) pairs within the light's falloff_end / (local
    lights x covered pixels)."""
    def median(values):
        return statistics.median(values) if values else None

    replay = {s: median([r.stage_ms[s] for r in rows if s in r.stage_ms])
              for s in fr.FRAME_STAGES}
    occ = {}
    for k, cap in TRACE_COUNTS.items():
        c = getattr(cfg, cap)
        if c:
            occ[k] = median([100.0 * r.counts[k] / c for r in rows
                             if k in r.counts])
    occ["alpha_window"] = median([
        100.0 * r.counts["alpha_window"] / fr.alpha_window(cfg)
        for r in rows if "alpha_window" in r.counts])
    peels = [median([r.counts[k] for r in rows if k in r.counts])
             for k in ALPHA_COUNTS[1:]]
    out = {
        "frames": len(rows),
        "host_ms": {p: statistics.fmean(r.host_ms[p] for r in rows)
                    if rows else None for p in HOST_PARTS},
        "replay_ms": {k: v for k, v in replay.items() if v is not None},
        "occupancy": {k: v for k, v in occ.items() if v is not None}}
    if peels[0] is not None:
        out["alpha_unresolved"] = [v for v in peels if v is not None]
    n_local = cfg.num_point_lights + cfg.num_spot_lights
    reach = median([
        100.0 * r.counts["light_reach_pairs"]
        / (n_local * r.counts["covered_pixels"]) for r in rows
        if r.counts.get("covered_pixels")])
    if reach is not None:
        out["light_reach"] = reach
    return out


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
