"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's main paths, BASELINE config 4 at 1920x1080 (deferred
PBR, 4-cascade 2048^2 shadow atlas, half-res SSAO, procedural sky), with
the compiled zero-radius PCF and with the 2.5-texel soft disk (plain and
with the fast preset), through ``crychic_renderer_tpu_torch.app.renderer
.Renderer`` on ``cuda``, and checks the hand-written kernels that carry
them: the raster kernel (csrc/raster.cu) of both raster launches and the
soft PCF kernel (csrc/pcf.cu). Phases, each printed as it ends:

1. the card's name and power limit (nvidia-smi);
2. both kernels built from the checkout's sources, one nvcc each, started
   together, and their build times;
3. the Renderer at 1080p, with the capacities it sized (the atlas pair
   count is what the atlas binning expands; the tile capacities of the
   compacted passes beside their grids), and which of config 4's
   texture slots the default asset directory (the JAX package's) holds:
   phases 1-19 build their Renderers without asset_dir, so they render
   white 1x1 chains unless the host has the files;
4. the raster kernel on the frame's own main-view (K1) and atlas (K2)
   inputs, equal to rasterize_plain bit for bit (torch.equal), with the
   kernel's and the plain version's times from CUDA events after warm-up;
5. a 1/8-size config-4 frame on the card against the same frame rendered
   by the port's CPU path (plain raster; itself held against the JAX
   package by tests/test_torch_frame.py): <= 0.5% of pixels > 0.02;
6. 3 warm-up + 10 timed frames through Renderer.render: finite, with
   covered and sky pixels, exactly one K1 and one K2 launch per frame, no
   capacity overflow; the median ms/frame;
7. the soft PCF kernel (K6) on the dense 1080p receivers, both cascades
   of all 2.07M pixels, read from the window-ready buffer of the maps
   (ops/pcf.quantize_map), against soft_pcf_plain: max |err| <= 1e-5,
   with both times, the share of them the frame discards and the share
   whose window lies on the map's last block (the receivers the former
   kernel sent down its scalar branch) (phase 22 checks it on the
   compacted receivers the frame hands it now);
8. 3 warm-up + 10 timed frames each of config 4 with the soft disk, and of
   the same with the fast preset: finite, one K1, one K2 and one K6 launch
   per frame, no overflow, the median ms/frame of each; and a 240x135
   soft-disk frame on the card against the CPU path (<= 0.5% > 0.02);
9. the raster kernel's band launches (K3) on the frame's own inputs, the
   main view split 4 ways (nty 135, rpd 34: owner 3's last key row lies
   past the screen) and the atlas split 4 and 3 ways (nty 256, rpd 86 at
   n=3): every owner's launch equal to rasterize_plain in the same band
   mode, and the reassembled bands equal to the K1/K2 full-frame output
   (torch.equal), with pairs per owner, both times and the bound per
   launch;
10. the band-sharded frame (parallel/sharded.py) of config 4 at 1080p on
   4 ranks of one gloo group that time-share the ONE card (kernels built
   above, loaded by the ranks), as launch.render_sharded renders it by
   default: the compiled band frame (parallel/graphs.py, phase 25).
   check_band_capacity, 3 warm-up + 10 frames, exactly one K3 main-view
   and one K3 atlas launch per rank and frame (through the replay tally;
   one more of each for the eager frame before the capture) and no
   K1/K2, no overflow, the gathered image against render_frame on the
   card (<= 1e-3 of pixels > 0.02), the median ms/frame (not a scaling
   number: the ranks share one card);
11. each owner's band alone at n=4 in sim_index mode (the all_gathers are
   copies of the local shard), median ms: the JAX package's per-device
   band time method, printed without a claim. It does not time a band of
   the real frame: the copied shards make every owner render its own
   quarter of the triangles four times over, a different load per owner;
12. K4, the field-major raster launch, through the probe's entry point
   experiments/fma_kernel_probe.rasterize_fma on the phase-4 inputs, both
   views, layouts 't' (field-major kernel) and 'l' (the pair-major K1/K2
   launch), with every count set to 0 just before and read just after
   (one launch of each): each output equal to rasterize_plain and to
   phase 4's K1/K2 output (torch.equal), kernel and plain times (CUDA
   events) and phase 4's bound;
13. K5, the raster kernel launched alone inside
   experiments/bin_decomp_probe.decompose, on both views: the kernel-alone
   output equal to rasterize_plain and to the full rasterize
   (torch.equal), every piece's ms, and the counted launches of the
   decompose run (the kernel alone and the full rasterize, 1 + reps
   each);
14. app/profiler.profile_frame of the 1080p Renderer: every stage, their
   sum and TOTAL_fused, each stage captured as its own CUDA graph and
   timed over its replays, TOTAL_fused over Renderer.render's replays
   (host clock ending in a synchronize), with the launches of the
   profiling run counted;
15. app/compare.parity([4], small=True) on the card (the card's 480x270
   frame against the CPU path's, and under "xla" against the card's
   pure-XLA frame: < 0.5% of pixels > 0.02 each), and a scripted
   headless app/viewer run on the card (config 4, fast preset, 1280x720,
   keys "wwjl", frames in flight): its caption lines, no overflow, one K1
   and one K2 launch per frame.

16. the forward path: config 1 at its own 800x600 (forward PBR, sky, no
   shadows) and config 4 at 1920x1080 with deferred=False, use_pbr=False
   (config 2's Blinn-Phong lighting with the shadow atlas and the
   ShadowDebug quad): each at 240x135 on the card against the CPU path
   (<= 0.5% of pixels > 0.02), then 3 warm-up + 10 timed frames with the
   launches counted (one K1 per frame, and one K2 with shadows);
17. config 3's settings (deferred Blinn-Phong, 16 point lights) and light
   rig on config 4's scene at 1920x1080: against the CPU path at 240x135
   and timed the same way (one K1 per frame);
18. the alpha-tested layer: fence_scene with the synthetic wire grid
   (models/scenes_baseline.wire_fence_chain; WireFence.dds is absent) at
   its own 480x270 against the CPU path, then at 1920x1080 with the
   capacities capacity_requirements sizes, timed the same way (one K1 and
   one K2 per frame), and profile_frame of the 1080p fence frame: the
   alpha peel's stages (alpha_merge_main, alpha_merge_shadow);
19. the soft PCF kernel (K6) on 520^2 maps, whose 1,040-byte rows are off
   the card's texture pitch alignment: their window-ready buffer (a
   544-texel pitch) has a texture object, so every receiver takes the
   gather path. The 1080p receivers of config 4 with 520^2 maps against
   soft_pcf_plain (<= 1e-5), kernel, device, plain and bound times, with
   the scalar path's device time before the window-ready map quoted
   beside them (every receiver took it then), and the share with a
   window on the last block; and 3 warm-up + 10 timed frames of that
   config with the soft disk (one K1, K2 and K6 launch per frame).

20. config 5 (skull + car + instanced boxes + grid, PBR, shadows, SSAO,
   the animated BoltAnim slot) from files on disk: the full-size
   synthetic asset set (experiments/synthetic_assets.py: DXT5/DXT1/RGBA8
   textures of 512², 60 + 120 BMP frames, a DXT1 cubemap of 6 x 1024²,
   the published skull and car counts) written under build/, with its
   write time, the decode time of the meshes, the textures and the cube,
   and the pair pool's and the cube's bytes on the card; a 240x135 frame
   with the loaded cube on the card against the CPU path (<= 0.5% of
   pixels > 0.02); 3 warm-up + 10 timed frames at 1920x1080 whose times
   walk the BoltAnim slot through 7 of its frames (the material's pair
   must change), one K1 and one K2 launch per frame, no overflow, finite
   pixels, the median ms/frame; the raster kernel on the last timed
   frame's own 1080p main-view (K1) and atlas (K2) inputs, binned at the
   frame's capacities, equal to rasterize_plain (torch.equal), with the
   pair counts; and profile_frame of that frame;
21. configs 2 (forward Blinn-Phong, 3 lights) and 3 (deferred, 16 point
   lights) as written, on the synthetic skull and textures: each at
   240x135 on the card against the CPU path, then 3 warm-up + 10 timed
   frames at 1920x1080 (one K1 launch per frame), and K1 on the last
   timed frame's main-view inputs against rasterize_plain as in phase 20.

22. tile-compacted shading (every Renderer above sizes the tile
   capacities, so every phase renders compacted frames; the band frame
   stays dense): config 4 with the zero-radius PCF and with the soft
   disk, config 5 from the phase-20 files and config 2 as written, at
   1920x1080. For each: the occupied shade and SSAO tiles (the frame's
   coverage and capacity_requirements' bound) beside CB and NT; the
   compacted frame against the same Renderer's inputs with both
   capacities None (max |diff| <= 1e-5, no pixel > 0.02); the three
   compacted passes under torch.cuda.set_sync_debug_mode("error"); the
   device ms of the resolve_gbuffer, ssao and lighting stages of both
   (torch.profiler's summed kernel and copy durations, and CUDA events
   around each call queued behind a device sleep); ms/frame of both, 3
   warm-up + 10 frames each, in turns compacted, dense, dense,
   compacted, with the launches counted (one K1, K2 and K6 per frame as
   the cell has them). On the soft-disk frame, K6 on the compacted
   receivers it was handed (2 x CB x 1024) against soft_pcf_plain (<=
   1e-5), with both times, their bound (the kernels line's K6 entry) and
   the share of them the frame discards.

23. frames queued without a host sync, and the bench entry points: for
   configs 1-5 as written, config 4 with the soft disk and with the soft
   disk + fast preset, config 5 with the fast preset (configs 2, 3 and 5
   from the phase-20 files) and the fence at 1920x1080, one warm-up frame,
   then 3 frames queued through Renderer.render under
   torch.cuda.set_sync_debug_mode("error") (a host sync raises), with the
   launches counted (one K1 per frame, K2 with shadows, K6 with the soft
   disk), the host ms to queue a frame and the ms until the last is done,
   no overflow, finite pixels; on the soft-disk Renderer, 20 more frames
   queued back to back and read back once, over which the soft PCF
   kernel's texture-object cache (csrc/pcf.cu) must fill 0 times (a fill
   synchronizes the device where the debug mode cannot see it); then
   ``python -m crychic_renderer_tpu_torch.bench`` and ``python -m
   crychic_renderer_tpu_torch.experiments.bench_all`` as subprocesses from
   the checkout, each exiting 0: the bench's JSON line parsed and checked
   (5 rounds of 20 queued frames, one K1 and one K2 launch per frame, no
   K6) and printed, and bench_all's card line and 7 config lines printed.

24. the compiled frame (Renderer.render replays a CUDA graph captured at
   its first call, app/graphs.py) against the eager frame, for config 4
   with the zero-radius PCF and with the soft disk (K6 inside the graph),
   config 5 from the phase-20 files (BoltAnim), the fence (the alpha
   layer) and config 1 (forward), at their phase sizes (1920x1080, config
   1 800x600). For each: the first render's host ms (eager frame, capture
   and replay), the capture's ms and the bytes of the graph's memory
   pool; the replayed frame at t = 0.1 (config 5: another BoltAnim slot
   than at t = 0, which must show in the image) against render_frame on
   the same constants: torch.equal, or, where two eager frames differ
   too, max |diff| <= 1e-5 and no pixel > 0.02; then 20 frames queued and
   read back once, in turns graph, eager, eager, graph: the host ms to
   issue a frame and the ms/frame, with the launches counted in each turn
   (per replay, from the replay tally: one K1, one K2 with shadows, one K6
   with the soft disk); K6's texture-cache fills over the cell (0). On
   config 4: whether torch.profiler records the replay's kernels (its
   kernel records and summed device ms per frame, graph against eager)
   and the device ms per replay from CUDA events around 20 replays queued
   behind a device sleep. On config 5: the device memory the Renderer's
   close() gives back. Last, experiments/texture_capture_probe.py in a
   process of its own: whether CUDA makes a texture object inside a
   capture in the global mode (the compiled frame makes its objects before
   the capture either way).

25. the compiled band frame (parallel/graphs.CompiledBandFrame) against
   the eager band frame: config 4 at 1920x1080 on 4 gloo ranks sharing
   the card, with the zero-radius PCF and with the soft disk, in turns
   compiled, eager, eager, compiled (2 warm-up + 5 frames each) in one
   job: every rank's replay torch.equal to its eager band frame, the
   gathered image against render_frame on the card (phase 10's bound),
   per rank the graphs (the gathers + 1), the graphs' pool bytes, the
   capture ms, the launches per replay (one K3 of each kind, one K6 with
   the soft disk) and the host ms to issue a frame, the launches counted
   (one more of each per capture), the median ms/frame of rank 0 per
   turn, 0 texture-cache fills, and torch.profiler over 3 replays of rank
   0 (K3's and K6's device ms inside the replay); the u16-packed atlas
   gather against the f32 one on the same frame (torch.equal, the bytes
   received per rank and frame); render_frames_replicated on 2 x 2
   ranks, compiled equal to eager; 1 NCCL rank, the whole band frame and
   its all_gather_into_tensor collectives one graph, equal to eager; and
   phase 14's per-stage replay ms beside phase 22's device ms.

26. the JAX package's pure-XLA raster path and a scene whose draws carry
   no static tables, config 4 at 1920x1080: (a) the Renderer with
   use_pallas=False (the binned tensor raster of ops.rasterizer, each
   cascade in its own viewport), compiled: 3 warm-up + 10 frames with no
   K1/K2 launch, the frame against the kernel frame (<= 0.5% of pixels >
   0.02), the main view's tids against K1 on the same triangles (the
   disagreeing pixels, and max |depth diff| where the tids agree), the
   per-cascade maps against the atlas's, the capture ms and pool bytes;
   (b) the same with the soft disk, K6 on that frame's receivers against
   soft_pcf_plain (<= 1e-5) and one K6 launch per frame; (c) config 4's
   scene without its static tables (passes.frame.strip_draw_statics)
   through Renderer.render, 3 + 10 frames with one K1 and one K2 launch
   each, against the frame with the tables (torch.equal, or max |diff|
   <= 1e-5 with 0 pixels > 0.02); (d) the compiled band frame on 4 gloo
   ranks of both families, 2 warm-up + 5 frames, compiled against eager:
   every rank's replay torch.equal to its eager frame, the gathered image
   against render_frame (phase 10's bound), 14 and 21 graphs per rank,
   no K1/K2/K3 launch on the pure-XLA path. The card's name and power
   limit head the phase's lines.

27. K6 off the frame's receivers: the card's texture limits (and the S
   from which four cascades pass them); receivers near every edge and
   corner of patchy maps made from a seed, with 1,000 NaN, +-inf and
   +-1e30 parameters among them, at S = 520 and 2048 (textured), and at
   S = 136 on one cascade more than the card's texture height holds (no
   texture object: the scalar path): each against soft_pcf_plain (<=
   1e-5; torch.equal printed). The K6 entries of the kernels line carry
   these errors.

28. the full-size frame and the app tools' options: config 4 at its
   published 1920x1080 with 2048^2 cascades, with the zero-radius PCF and
   with the soft disk (K1, K2 and K6 at full size), on the card against
   the port's CPU path on the same scene and frame constants (<= 0.5% of
   pixels > 0.02; the share, max and mean |diff| and the seconds of each;
   tests/test_torch_fullsize.py holds the CPU path against the JAX
   package at this size); ``app.run.main`` with ``--config 4 --frames 3
   --orbit --stats``: one capture for the whole run (the turned camera
   reaches each replay through the packed constants), the last frame
   torch.equal to render_frame at the turned camera, and the --stats line
   parsed; ``app.compare.main`` with ``--parity --small --configs 4
   --json-out``: exit code 0 and the file equal to the printed report.
   The launches of each are counted; the card's name and power limit head
   the phase's lines.

29. the JAX system's last entry points on the port: (a)
   ``graft_entry.entry("cuda")`` (the cascade scene at 256x128 on the
   pure-tensor raster, render_frame eager: no hand-kernel launch) against
   ``entry("cpu")``'s frame (<= 0.5% of pixels > 0.02); (b)
   ``graft_entry.dryrun_multichip(..., cpu_check=True)`` on 4 gloo ranks
   sharing the card (its three legs: the 128x1080 pure-tensor band frame,
   the 256x72 K3 band frame and 2 x 2 replica groups, each against
   render_frame in the parent, < 1e-3 of pixels > 0.02, and against
   render_frame on the CPU from the same leaves, <= 0.5%: K3 at these
   shapes against its plain version), then on 1 NCCL rank (NCCL puts one
   rank on a card: legs 1 and 2); the parent's K1/K2 launches (its
   kernel-path single frames) and the ranks' K3 launches (eager frame +
   replay of each run's band graph) counted; (c)
   ``experiments.fast_quality`` on configs 4 and 5 at 1920x1080 (config
   5 from the synthetic set where the reference's files are absent):
   PSNR, SSIM and the share of pixels moved > 2%, fast preset against
   parity, and the config-5 pair written under build/; (d)
   ``experiments.aniso_quality`` (configs 1 and 5 at 1/4 size, four
   probe schedules against the 8-probe reference; each reference frame
   also against the CPU path, <= 0.5%; config 1's rows stay out of the
   record: its WoodCrate01.dds is not in the repository, so every
   schedule filters a white 1x1 alike); (e) ``experiments.make_gallery``
   at full size (the seven images under build/); each frame of (c)-(e)
   holds its raster launches (K1, and K2 with shadows) on its own inputs
   against rasterize_plain (torch.equal), uncounted; each of (c)-(e)
   with its launches counted (each Renderer's first render: an eager
   frame and a replay of its graph, one K1 each and one K2 each with
   shadows) and its captures; (f) the phase's seconds. The card's name
   and power limit head the phase's lines.

Renderer.render replays a CUDA graph: a Renderer's first render, and the
first after its cfg is replaced, runs one eager frame before it captures
the graph, so a run's launch counts hold one more launch of each of its
kernels per capture (app/graphs.CAPTURES), which every check counts.
Phases 6, 8, 10, 14-16 and 18-25 count no field-major (K4) launch: the
variant is kept off every frame path.

Then one JSON line of per-kernel results (with each kernel's bound: the
larger of the bytes its function must move over 3.35 TB/s and the f32
operations the function needs on this run's inputs over 33.5 T/s, the
rate with every operation rounded on its own, as the kernels are built
(-fmad=false): for the raster kernel the warp-level reject's test of
every (record, warp) pair and the pixel tests of the pairs it keeps,
for K6 460 per receiver-cascade) and, last, the device line. Any
failed phase raises, so the script exits non-zero and prints no result;
so does a machine without CUDA, and a directory without the repository.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FRAMES_WARMUP = 3
FRAMES_TIMED = 10
DECOMP_REPS = 10
PROFILE_REPS = 5
VIEWER_SCRIPT = "wwjl"
# the frame paths whose launches count for K1-K3 and K6; the probes' runs
# (phases 12, 13) count for K4 and K5
# phase 22's cells, each timed compacted and dense in turns
P22_CELLS = ("config4", "config4_soft", "config5", "config2")
P22_TURNS = ("compacted", "dense", "dense", "compacted")
# phase 23's cells, each 3 frames queued under the sync debug mode; the
# soft-disk cell then queues 20 frames for K6's texture-cache count
P23_CELLS = ("config1", "config2", "config3", "config4", "config4_soft",
             "config4_soft_fast", "config5", "config5_fast", "fence")
P23_FRAMES = 3
K6_QUEUE = 20
# phase 24's cells, the compiled frame against the eager one in turns
P24_CELLS = ("config4", "config4_soft", "config5", "fence", "config1")
P24_TURNS = ("graph", "eager", "eager", "graph")
P24_QUEUE = 20
# phase 25: the band frame compiled against eager in turns, per cell, on
# 4 gloo ranks (rank 0's first compiled turn also profiled)
P25_TURNS = ("compiled", "eager", "eager", "compiled")
P25_WARMUP = 2
P25_TIMED = 5
P25_PROFILE = 3
# phase 26: the band frame's cells; graphs per gloo rank of each (config 4)
P26_GRAPHS = {"xla": 14, "no_statics": 21}
FRAME_RUNS = ["config4", "soft", "soft_fast", "sharded", "profiler",
              "parity", "viewer", "config1", "forward", "rig", "fence",
              "fence_profiler", "soft_520", "config5", "config5_profiler",
              "config2", "config3"] + [
                  f"p22_{cell}_{mode}_{i}" for cell in P22_CELLS
                  for i, mode in enumerate(P22_TURNS)] + [
                  f"p23_{cell}" for cell in P23_CELLS] + [
                  "p23_soft_queue", "bench"] + [
                  f"p24_{cell}_{turn}_{i}" for cell in P24_CELLS
                  for i, turn in enumerate(P24_TURNS)] + [
                  "p25_gloo", "p25_nccl", "p26_xla", "p26_xla_soft",
                  "p26_no_statics", "p26_band", "p28_zero", "p28_soft",
                  "p28_run", "p28_compare", "p29_entry", "p29_dryrun_gloo",
                  "p29_dryrun_nccl", "p29_fast_quality",
                  "p29_aniso_quality", "p29_gallery"]
ZERO = dict(ids=0, depth=0, band_ids=0, band_depth=0, field_ids=0,
            field_depth=0, pcf=0)
PIX_BOUND = 0.005
SHARD_FRAC = 1e-3  # tests/test_multichip.py's sharded-frame bound
PCF_TOL = 1e-5
SOFT = 2.5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and f32 operations/s
# with each rounded on its own: the kernels are built with -fmad=false,
# so every mul and add issues alone, at half the 67 TFLOP/s that counts
# an FMA as two
HBM_BYTES_S = 3.35e12
F32_OPS_S = 33.5e12
# The raster function's f32 operations on these inputs, each rounded on
# its own: the warp-level reject's test for every (record, warp) pair,
# and the pixel tests of the pairs it keeps (ops/raster.warp_rejects).
# The test: per edge its margin (|A|*128, |B|*8, two sums, the 2^-20
# product and the 2^-120 sum: 6), the plane at the maximising corner (2
# compares to pick it, 2 products, 2 sums) and a compare: 13; the depth
# plane's margin (6), both corners (6 + 4, the compares shared), 1 + m
# and two compares: 19; the column guard 2 compares. The pixel tests of
# a warp's 16x8 rectangle: each of the 4 planes multiplies A by 16
# column centres and B by 8 row centres, then per pixel 8 adds and 6
# compares; the guard 2 compares per column.
RASTER_REJECT_OPS = {False: 3 * 13 + 19, True: 3 * 13 + 19 + 2}
RASTER_WARP_OPS = {False: 4 * (16 + 8) + 128 * (8 + 6),
                   True: 4 * (16 + 8) + 128 * (8 + 6) + 16 * 2}
# The former rule, printed beside the new bound once (phase 4): every
# pair's full 8x128 tile, 14,880 operations (15,136 with the guard), over
# 67 TFLOP/s
OLD_RASTER_OPS = {False: 4 * (128 + 8) + 1024 * (8 + 6),
                  True: 4 * (128 + 8) + 1024 * (8 + 6) + 128 * 2}
OLD_F32_OPS_S = 67e12
# K6's scalar path on config 4's 1080p receivers at S = 520 before the
# window-ready map (every receiver: its 1,040-byte rows had no texture),
# device ms on an NVIDIA H100 80GB HBM3 at 700.00 W, quoted in phase 19
K6_520_SCALAR_MS = 0.4932


def raster_ops(records, with_xrange):
    """f32 operations the raster function needs on these records (the
    valid pairs): RASTER_REJECT_OPS per (record, warp), RASTER_WARP_OPS
    per (record, warp) the reject keeps."""
    from crychic_renderer_tpu_torch.ops import raster

    kept = int((~raster.warp_rejects(records, with_xrange)).sum())
    return (records.shape[0] * raster.WARPS * RASTER_REJECT_OPS[with_xrange]
            + kept * RASTER_WARP_OPS[with_xrange])


def bound(nbytes, ops):
    """The least time the card could take: (dict(bound_ms, bound_by), and
    a note of the two times it is the larger of, for the phase line)."""
    t_bytes = 1000.0 * nbytes / HBM_BYTES_S
    t_ops = 1000.0 * ops / F32_OPS_S
    keys = dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return keys, (f"bound {keys['bound_ms']:.4f} ms (bytes {t_bytes:.4f}, "
                  f"operations {t_ops:.4f})")


def k6_bound(qmap, params):
    """K6's bound on these inputs: the parameters read, the map's C*S*S
    16-bit texels read (not the window-ready padding) and the factors
    written; OPS_PER_RECEIVER per receiver-cascade."""
    from crychic_renderer_tpu_torch.ops import pcf

    S = pcf.map_size(qmap)
    m = params.shape[1]
    return bound(params.numel() * 4 + qmap.shape[0] * S * S * 2 + m * 4,
                 m * pcf.OPS_PER_RECEIVER)


def last_block_share(params, S):
    """The share of receiver-cascades whose window lies on the map's last
    8-texel block in x or y (qx0 or qy0 = S/8 - 1): the ones the former
    kernel sent down its scalar path on a textured map."""
    nb = S // 8
    corner = torch.clamp(torch.floor(params[:2]).nan_to_num(nan=-2.0 ** 30),
                         -2.0 ** 30, 2.0 ** 30).long() - 3
    q = torch.clamp(corner >> 3, 0, nb - 1)
    return float((q == nb - 1).any(dim=0).float().mean())


def phase(msg):
    print(msg, flush=True)


def device_ms(fn, reps, kernel):
    """Mean device ms of the kernel named `kernel` per call of fn()
    (torch.profiler's kernel records, so the wrapper's host work is not
    in it; CUDA events around each queued call where the profiler keeps
    too few records, see kernel_ab_probe.device_ms)."""
    from crychic_renderer_tpu_torch.experiments import kernel_ab_probe

    return kernel_ab_probe.device_ms(fn, reps, kernel)


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
    from crychic_renderer_tpu_torch.ops import build, pcf, raster
    from crychic_renderer_tpu_torch.ops import rasterizer as rz
    from crychic_renderer_tpu_torch.ops import shading, shadows
    from crychic_renderer_tpu_torch.passes import frame as fr

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("[1] card (nvidia-smi name, power.limit):")
    print(smi, flush=True)

    # 2. the kernels, built from the checkout, one nvcc each, in parallel
    libs = (raster.LIBRARY, pcf.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load, True) for lib in libs]:
            f.result()
    built = ", ".join(f"{lib.path()} ({lib.build_seconds:.2f} s)"
                      for lib in libs)
    phase(f"[2] built {built} in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS)})")
    for lib in libs:  # ptxas: registers, shared memory, spills per kernel
        for line in lib.build_log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[2] {lib.name}: {line.strip()}", flush=True)

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
          f" -> shadow_pair_capacity {cfg.shadow_pair_capacity}; "
          f"{tile_note(cfg, req)}")
    phase(f"[3] {default_textures(scene)}")

    # 4. K1 and K2 on the frame's own inputs, kernel vs plain version
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    atris, xr = fr.shadow_atlas_tris(r.device_scene, consts.shadow_visibility,
                                     consts.cascade_view_projs, cfg)
    raster_launches = [
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
    full_out = {}  # variant -> (depth, tid) of the full-frame launch
    views = {}  # variant -> the launch's inputs, plain output, time, bound
    for name, variant, replaces, inputs, W, H, ids, xrange in \
            raster_launches:
        rec, starts, counts, _ = inputs
        (d_k, t_k), (d_p, t_p), err = raster_vs_plain(name, inputs, W, H,
                                                      ids, xrange)
        full_out[variant] = (d_k, t_k)
        ms = cuda_ms(lambda: raster.raster_tiles(
            rec, starts, counts, W, H, with_ids=ids, with_xrange=xrange), 20)
        dev_ms = device_ms(lambda: raster.raster_tiles(
            rec, starts, counts, W, H, with_ids=ids, with_xrange=xrange), 20,
            "raster_tiles_kernel")
        plain_ms = cuda_ms(lambda: raster.rasterize_plain(
            rec, starts, counts, W, H, with_ids=ids, with_xrange=xrange), 3)
        pairs = int(counts.sum())
        # records of the valid pairs, per-tile starts and counts, depth
        # (+ id) out
        nbytes = pairs * 64 + starts.numel() * 8 + W * H * (8 if ids else 4)
        b, note = bound(nbytes, raster_ops(rec[:pairs], xrange))
        old_ms = 1000.0 * max(nbytes / HBM_BYTES_S, pairs * OLD_RASTER_OPS[
            xrange] / OLD_F32_OPS_S)
        phase(f"[4] {name}: {W}x{H}, {pairs} pairs, equal to "
              f"rasterize_plain (max |err| {err}); kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f}), plain {plain_ms:.4f} ms, {note} "
              f"(the former rule, every pair's whole tile over 67 "
              f"TFLOP/s: {old_ms:.4f}); {reject_note(rec[:pairs], xrange)}")
        kernels.append(dict(name=name, route="cuda",
                            source="crychic_renderer_tpu_torch/csrc/raster.cu",
                            replaces=replaces, variant=variant,
                            runs=FRAME_RUNS, max_abs_err=err, ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=None, **b))
        views[variant] = dict(
            view="main view" if ids else "atlas",
            tris=tris if ids else atris, xrange=xr if xrange else None,
            cap=cfg.pair_capacity if ids else cfg.shadow_pair_capacity,
            W=W, H=H, ids=ids, records=(rec, starts, counts),
            plain=(d_p, t_p), plain_ms=plain_ms, pairs=pairs, bound=b,
            note=note)

    # 5. a small frame on the card against the port's CPU path
    frac, diff = small_frame_vs_cpu(dev, {})
    phase(f"[5] 240x135 frame on the card vs the CPU path: {frac:.4%} of "
          f"pixels >0.02 (max {diff.max():.3g}, mean {diff.mean():.3g})")

    # 6. the main path: frames through Renderer.render
    ms_frame, counts_run = run_frames(r, dict(ZERO, ids=1, depth=1))
    consts = r.frame_constants((FRAMES_WARMUP + FRAMES_TIMED - 1) / 60.0)
    tris, tri_attr = fr.main_view_tris(r.device_scene, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    covered = int((tid >= 0).sum())
    sky = tid.numel() - covered
    assert covered > 0 and sky > 0, (covered, sky)
    phase(f"[6] config 4: {FRAMES_WARMUP} warm-up + {FRAMES_TIMED} frames: "
          f"median {ms_frame:.3f} ms/frame; launches {counts_run}; "
          f"{covered} covered, {sky} sky pixels; no overflow")
    launches = {"config4": counts_run}

    # 7. K6 on the 1080p frame's own receivers, kernel vs plain version
    g = fr.resolve_gbuffer(r.device_scene, consts, cfg, tris, depth, tid,
                           tri_attr)
    maps = fr.render_shadow_atlas(r.device_scene, consts.shadow_visibility,
                                  consts.cascade_view_projs, cfg)
    _, no_shadow, cascades, shadow_pos = shadows.cascade_select(
        consts.shadow_transforms, g["pos_w"], consts.eye_pos)
    # the receiver-cascades whose factor the frame discards: both slots of
    # sky and no-shadow pixels; the second slot of cascade-3 pixels (the
    # deferred quirk blends only below cascade 3)
    assert cfg.deferred
    both = ~g["valid"] | no_shadow
    discard = torch.stack([both, both | (cascades[..., 0] == 3)], dim=-1)
    params = pcf.receiver_params(shadow_pos.reshape(-1, 4),
                                 cascades.reshape(-1), S)
    qmap = pcf.quantize_map(maps)
    f_k = pcf.soft_pcf(qmap, params, SOFT)
    torch.cuda.synchronize()
    f_p = pcf.soft_pcf_plain(qmap, params, SOFT)
    err = (f_k - f_p).abs()
    max_err = float(err.max())
    above = float((err > 1e-5).float().mean())
    assert torch.isfinite(f_k).all(), "K6: non-finite factors"
    assert max_err <= PCF_TOL, f"K6: max |err| {max_err} vs plain"
    ms = cuda_ms(lambda: pcf.soft_pcf(qmap, params, SOFT), 20)
    dev_ms = device_ms(lambda: pcf.soft_pcf(qmap, params, SOFT), 20,
                       "soft_pcf_kernel")
    plain_ms = cuda_ms(lambda: pcf.soft_pcf_plain(qmap, params, SOFT), 3)
    m = params.shape[1]
    b, note = k6_bound(qmap, params)
    soft_share = float(((f_p > 0) & (f_p < 1)).float().mean())
    phase(f"[7] K6 soft PCF on the dense receivers (the frame now hands "
          f"it the compacted ones, phase 22): {m} receiver-cascades "
          f"({cfg.width}x{cfg.height} x 2) on the {tuple(qmap.shape)} "
          f"window-ready buffer, {soft_share:.2%} in a penumbra; "
          f"{last_block_share(params, S):.2%} with a window on the map's "
          f"last block (the former kernel's scalar branch); max |err| "
          f"{max_err} vs soft_pcf_plain, {above:.4%} above 1e-5; kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"{note}; discarded by the "
          f"frame: {float(discard.float().mean()):.2%} of receiver-cascades "
          f"(sky {float((~g['valid']).float().mean()):.2%} and no shadow "
          f"{float((no_shadow & g['valid']).float().mean()):.2%} of pixels, "
          f"both slots; the second slot of cascade-3 pixels "
          f"{float(((cascades[..., 0] == 3) & ~both).float().mean()):.2%})")

    # 8. the soft-disk paths: frames through Renderer.render
    frame_ms = {"config4": ms_frame}
    for name, make in (("soft", lambda c: c),
                       ("soft_fast", lambda c: c.fast_preset())):
        cfg_run = make(dataclasses.replace(CONFIGS[4]()[1],
                                           pcf_radius_texels=SOFT))
        r_run = Renderer(scene, cfg_run, lights=lights, device=dev)
        ms_run, counts_run = run_frames(
            r_run, dict(ZERO, ids=1, depth=1, pcf=1))
        frame_ms[name] = ms_run
        launches[name] = counts_run
        phase(f"[8] config 4 {name}: {FRAMES_WARMUP} warm-up + "
              f"{FRAMES_TIMED} frames: median {ms_run:.3f} ms/frame; "
              f"launches {counts_run}; no overflow")
        del r_run
    frac, diff = small_frame_vs_cpu(dev, {"pcf_radius_texels": SOFT})
    phase(f"[8] 240x135 soft-disk frame on the card vs the CPU path: "
          f"{frac:.4%} of pixels >0.02 (max {diff.max():.3g}, mean "
          f"{diff.mean():.3g})")

    # 9. K3, the band launches, on the frame's own 1080p inputs
    from crychic_renderer_tpu_torch.parallel import sharded

    consts0 = r.frame_constants(0.0)
    scene_d = r.device_scene
    tris, _ = fr.main_view_tris(scene_d, consts0, cfg)
    atris, xr = fr.shadow_atlas_tris(scene_d, consts0.shadow_visibility,
                                     consts0.cascade_view_projs, cfg)
    band_cfg = {n: sharded.autosize_band_capacities(scene_d, consts0, cfg, n)
                for n in (3, 4)}
    for n, variant, tris_v, W, H, xrange in (
            (4, "ids", tris, cfg.width, 4 * sharded.band_height(cfg, 4),
             None),
            (4, "depth", atris, 4 * S, S, xr),
            (3, "depth", atris, 4 * S, S, xr)):
        view = "main view" if variant == "ids" else "atlas"
        name = (f"K3 {view}, band launch of 1 of {n} owners "
                f"(parallel/sharded.py:{573 if variant == 'ids' else 376})")
        cap = (band_cfg[n].band_pair_capacity if variant == "ids"
               else band_cfg[n].shadow_band_pair_capacity)
        entry = band_launches(name, variant, n, tris_v, W, H, cap, xrange,
                              full_out[variant])
        if n == 4:
            kernels.append(entry)

    # 10. the sharded frame: 4 gloo ranks sharing the card
    frame_ms["sharded_4_ranks_one_card"], launches["sharded"] = \
        sharded_frame(r, consts0, band_cfg[4], dev)

    # 11. per-device band time in sim_index mode
    band_h = sharded.band_height(band_cfg[4], 4)
    sim_ms = []
    for d in range(4):
        comm = sharded._Comm(None, 4, sim_index=d)

        def band():
            return sharded._band_render(scene_d, consts0, band_cfg[4], comm,
                                        band_h)

        img = band()
        torch.cuda.synchronize()
        assert img.shape == (band_h, cfg.width, 4)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            band()
            torch.cuda.synchronize()
            times.append(1000.0 * (time.perf_counter() - t0))
        sim_ms.append(statistics.median(times))
    frame_ms["band_sim_index_n4"] = sim_ms
    phase(f"[11] sim_index band time, n=4, one owner alone on the card "
          f"(the all_gathers are copies of the local shard, no transfer, "
          f"so each owner renders its own quarter of the triangles four "
          f"times over, not its band of the real frame), median of 5 "
          f"after 1 warm-up, owners 0-3: "
          f"{', '.join(f'{t:.3f}' for t in sim_ms)} ms")

    # 12-15: the probes and the app layer
    t0 = time.perf_counter()
    probe_runs(views, full_out, kernels, launches)
    frame_ms["profile_stages"] = profile_run(r, launches)
    app_runs(dev, launches)
    t1 = time.perf_counter()
    phase(f"[15] phases 12-15 took {t1 - t0:.1f} s; the script "
          f"{t1 - t_script:.1f} s, kernel builds included")

    # 16-19: the forward path, point lights, the alpha layer, K6 at S=520
    forward_runs(dev, frame_ms, launches)
    fence_runs(dev, frame_ms, launches)
    kernels.append(pcf_520(dev, frame_ms, launches))
    t2 = time.perf_counter()
    phase(f"[19] phases 16-19 took {t2 - t1:.1f} s; the script "
          f"{t2 - t_script:.1f} s, kernel builds included")

    # 20-21: configs 5, 2 and 3 from the synthetic asset set on disk
    assets = asset_runs(dev, frame_ms, launches)
    t3 = time.perf_counter()
    phase(f"[21] phases 20-21 took {t3 - t2:.1f} s; the script "
          f"{t3 - t_script:.1f} s, kernel builds included")

    # 22: tile-compacted shading against the dense passes
    kernels.append(compaction_runs(dev, assets, frame_ms, launches))
    t4 = time.perf_counter()
    phase(f"[22] phase 22 took {t4 - t3:.1f} s; the script "
          f"{t4 - t_script:.1f} s, kernel builds included")

    # 23: frames queued without a host sync; the bench entry points
    queued_runs(dev, assets, frame_ms, launches)
    t5 = time.perf_counter()
    phase(f"[23] phase 23 took {t5 - t4:.1f} s; the script "
          f"{t5 - t_script:.1f} s, kernel builds included")

    # 24: the compiled frame (a CUDA graph) against the eager frame
    compiled_runs(dev, assets, frame_ms, launches)
    t6 = time.perf_counter()
    phase(f"[24] phase 24 took {t6 - t5:.1f} s; the script "
          f"{t6 - t_script:.1f} s, kernel builds included")

    # 25: the compiled band frame against the eager one
    band_graph_runs(r, consts0, band_cfg[4], dev, frame_ms, launches,
                    frame_ms["p22_config4_stages"]["compacted"], smi)
    t7 = time.perf_counter()
    phase(f"[25] phase 25 took {t7 - t6:.1f} s; the script "
          f"{t7 - t_script:.1f} s, kernel builds included")

    # 26: the pure-XLA raster path and draws without static tables
    xla_runs(r, band_cfg[4], dev, frame_ms, launches, smi)
    t8 = time.perf_counter()
    phase(f"[26] phase 26 took {t8 - t7:.1f} s; the script "
          f"{t8 - t_script:.1f} s, kernel builds included")

    # 27: K6 on edge, NaN and huge receivers, and past the texture limits
    k6_edges = pcf_edge_runs(smi)
    for k in kernels:
        if k["name"].startswith("K6"):
            k["edge_max_abs_err"] = k6_edges
    t9 = time.perf_counter()
    phase(f"[27] phase 27 took {t9 - t8:.1f} s; the script "
          f"{t9 - t_script:.1f} s, kernel builds included")

    # 28: the full-size frame against the CPU path; run and compare
    full_size_runs(dev, frame_ms, launches, smi)
    t10 = time.perf_counter()
    phase(f"[28] phase 28 took {t10 - t9:.1f} s; the script "
          f"{t10 - t_script:.1f} s, kernel builds included")

    # 29: graft_entry, the quality probes and the gallery
    entry_point_runs(dev, frame_ms, launches, smi)
    t11 = time.perf_counter()
    phase(f"[29] phase 29 took {t11 - t10:.1f} s; the script "
          f"{t11 - t_script:.1f} s, kernel builds included")

    kernels.sort(key=lambda k: k["name"])
    for k in kernels:
        variant = k.pop("variant")
        runs = k.pop("runs")
        k["launches"] = sum(launches[run][variant] for run in runs)
        k["launches_by_run"] = {run: launches[run][variant] for run in runs}
        assert k["launches"] > 0, f"{k['name']}: no launch on its paths"
    print(json.dumps({"kernels": kernels, "ms_per_frame": frame_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def band_launches(name, variant, n, tris, W, H, cap, xrange, full):
    """K3 on one view split n ways: each owner's band launch against
    rasterize_plain in the same band mode (torch.equal), and the n bands
    reassembled against the full-frame launch `full` (torch.equal). Prints
    per-owner pairs and times; returns the kernels-line entry, per launch
    averaged over the owners."""
    from crychic_renderer_tpu_torch.ops import raster

    ids = variant == "ids"
    parts, owners, err, recs = [], [], 0.0, []
    for d in range(n):
        rec, starts, counts, over = raster.binned_records(
            tris, W, H, cap, xrange=xrange, row_stride=(n, d))
        assert not bool(over), f"{name}, owner {d}: capacity overflow"
        off, rows = raster.band_grid(W, H, row_stride=(n, d))
        args = (rec, starts, counts, W, rows, ids, xrange is not None, off)
        d_k, t_k = raster.raster_tiles(*args)
        torch.cuda.synchronize()
        d_p, t_p = raster.rasterize_plain(*args)
        err = max(err, float((d_k - d_p).abs().max()))
        if ids:
            err = max(err, float((t_k - t_p).abs().max()))
        assert torch.equal(d_k, d_p), f"{name}, owner {d}: depth != plain"
        assert not ids or torch.equal(t_k, t_p), \
            f"{name}, owner {d}: tid != plain"
        grid = rows // raster.TILE_H * (-(-W // raster.TILE_W))
        pairs = int(counts[off:off + grid].sum())
        first = int(starts[off])
        recs.append(rec[first:first + pairs])
        ops = raster_ops(recs[-1], xrange is not None)
        owners.append(dict(
            pairs=pairs,
            ms=cuda_ms(lambda: raster.raster_tiles(*args), 20),
            device_ms=device_ms(lambda: raster.raster_tiles(*args), 20,
                                "raster_tiles_kernel"),
            plain_ms=cuda_ms(lambda: raster.rasterize_plain(*args), 3),
            # records of the valid pairs, the grid's starts and counts,
            # depth (+ id) out
            nbytes=pairs * 64 + grid * 8 + W * rows * (8 if ids else 4),
            ops=ops))
        parts.append((d_k, t_k))
    rows = parts[0][0].shape[0]

    def reassemble(stripes):
        g = torch.stack(stripes).reshape(n, rows // 8, 8, W).transpose(0, 1)
        return g.reshape(n * rows, W)[:full[0].shape[0]]

    assert torch.equal(reassemble([p[0] for p in parts]), full[0]), \
        f"{name}: reassembled depth != the full-frame launch"
    assert not ids or torch.equal(reassemble([p[1] for p in parts]),
                                  full[1]), \
        f"{name}: reassembled tid != the full-frame launch"

    def mean(key):
        return sum(o[key] for o in owners) / n

    b, note = bound(mean("nbytes"), mean("ops"))
    phase(f"[9] {name}, {W}x{H} in {n} bands of {rows} rows: pairs per "
          f"owner {[o['pairs'] for o in owners]} (capacity {cap}); kernel "
          f"ms {[round(o['ms'], 4) for o in owners]}, plain ms "
          f"{[round(o['plain_ms'], 3) for o in owners]}, device ms "
          f"{[round(o['device_ms'], 4) for o in owners]}; every launch "
          f"equal to rasterize_plain (max |err| {err}) and the bands "
          f"reassembled equal to "
          f"the full-frame launch (torch.equal); per launch: kernel "
          f"{mean('ms'):.4f} ms (device {mean('device_ms'):.4f}), plain "
          f"{mean('plain_ms'):.4f} ms, {note}; owners' records: "
          f"{reject_note(torch.cat(recs), xrange is not None)}")
    return dict(name=name, route="cuda",
                source="crychic_renderer_tpu_torch/csrc/raster.cu",
                replaces="crychic_renderer_tpu/ops/raster_pallas.py:93",
                variant="band_" + variant, runs=FRAME_RUNS,
                max_abs_err=err, ms=mean("ms"), device_ms=mean("device_ms"),
                plain_ms=mean("plain_ms"), library_ms=None, **b)


def reject_note(records, with_xrange):
    """The raster kernel's warp-level reject on these records
    (raster.warp_rejects, its mirror): the share of (record, warp) pairs
    it skips, and the share that have a covered pixel."""
    from crychic_renderer_tpu_torch.ops import raster

    rejected = raster.warp_rejects(records, with_xrange)
    live = raster.warp_covers(records, with_xrange)
    assert not bool((rejected & live).any()), "a rejected warp covers"
    return (f"warp-level reject skips {float(rejected.float().mean()):.2%} "
            f"of {rejected.numel()} (record, warp) pairs, "
            f"{float(live.float().mean()):.2%} have a covered pixel")


def sharded_frame(r, consts, band_cfg, dev):
    """The band-sharded frame of config 4 at 1080p on 4 gloo ranks that
    share the card, as launch.render_sharded renders it by default (the
    compiled band frame, parallel/graphs.py): band capacities checked,
    FRAMES_WARMUP + FRAMES_TIMED frames per rank with every launch count
    set to 0 just before and read just after (one K3 main-view and one K3
    atlas launch per frame, counted through the replay tally, and one
    more of each for the eager frame before the capture; no K1/K2), no
    overflow, and the gathered image against render_frame on the same
    card (<= 1e-3 of pixels > 0.02). Returns (median ms/frame of rank 0,
    launch counts summed over the ranks)."""
    from crychic_renderer_tpu_torch.parallel import launch, sharded
    from crychic_renderer_tpu_torch.passes import frame as fr

    n = 4
    req = sharded.check_band_capacity(r.device_scene, consts, band_cfg, n)
    t0 = time.perf_counter()
    ranks = launch.render_sharded(
        [r.device_scene], [consts], [(band_cfg, 0, (0,))], n, "gloo", dev,
        warmup=FRAMES_WARMUP, timed=FRAMES_TIMED, timeout=600)
    job_s = time.perf_counter() - t0
    frames = FRAMES_WARMUP + FRAMES_TIMED + 1  # + the eager frame
    want = dict(ZERO, band_ids=frames, band_depth=frames)
    img = ranks[0][0]["img"]
    for rank, (out,) in enumerate(ranks):
        assert out["launches"] == want, (rank, out["launches"], want)
        assert not out["overflowed"], f"rank {rank}: raster overflow"
        assert np.array_equal(out["img"], img), f"rank {rank}: other image"
    ref = fr.render_frame(r.device_scene, consts, r.cfg).cpu().numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref).max(axis=-1)
    frac = float((diff > 0.02).mean())
    assert frac <= SHARD_FRAC, f"sharded frame: {frac:.4%} of pixels > 0.02"
    ms = statistics.median(ranks[0][0]["ms"])
    graph = ranks[0][0]["graph"]
    phase(f"[10] sharded frame, config 4 {r.cfg.width}x{r.cfg.height}, "
          f"{n} gloo ranks time-sharing ONE card (not band scaling), the "
          f"compiled band frame ({graph['graphs']} graphs per rank): band "
          f"capacities main {band_cfg.band_pair_capacity} >= worst rank "
          f"{req['main_band_pairs']}, shadow "
          f"{band_cfg.shadow_band_pair_capacity} >= "
          f"{req['shadow_band_pairs']}; {FRAMES_WARMUP} warm-up + "
          f"{FRAMES_TIMED} frames: median {ms:.3f} ms/frame (rank 0; "
          f"per rank {[round(statistics.median(o[0]['ms']), 3) for o in ranks]}"
          f"); launches per rank {want}; no overflow; vs render_frame on "
          f"the card: max |diff| {diff.max():.3g}, {frac:.4%} of pixels > "
          f"0.02; job {job_s:.1f} s with spawn")
    # what the ranks counted, summed: every key of every rank was checked
    total = {k: sum(o[0]["launches"][k] for o in ranks) for k in want}
    return ms, total


def launch_counts():
    from crychic_renderer_tpu_torch.ops import pcf, raster

    return dict(raster.LAUNCHES_BY_VARIANT, pcf=pcf.LAUNCHES)


def reset_counts():
    from crychic_renderer_tpu_torch.ops import pcf, raster

    raster.reset_launches()
    pcf.reset_launches()


def captures():
    from crychic_renderer_tpu_torch.app import graphs

    return graphs.CAPTURES


def counted(fn, want, what, per_capture=None):
    """fn() with every launch count set to 0 just before and read just
    after (after a synchronize); the counts must equal ZERO updated with
    `want`, plus `per_capture` for each graph fn captured (each after one
    eager frame). Returns (fn's result, counts)."""
    reset_counts()
    c0 = captures()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    n = captures() - c0
    want = dict(ZERO, **want)
    for k, v in (per_capture or {}).items():
        want[k] += v * n
    assert counts == want, f"{what}: launches {counts}, want {want}"
    return out, counts


def _equal(a, b):
    return torch.equal(a[0], b[0]) and (
        (a[1] is None and b[1] is None) or torch.equal(a[1], b[1]))


def probe_runs(views, full_out, kernels, launches):
    """Phases 12 (K4) and 13 (K5) on the phase-4 inputs (see the module
    doc); appends their kernels-line entries."""
    from crychic_renderer_tpu_torch.experiments import bin_decomp_probe as bd
    from crychic_renderer_tpu_torch.experiments import fma_kernel_probe as fma
    from crychic_renderer_tpu_torch.ops import raster

    def args(v):
        return v["tris"], v["W"], v["H"], v["cap"]

    def kw(v):
        return dict(with_ids=v["ids"], xrange=v["xrange"])

    # 12. K4 through rasterize_fma, one call per view and layout
    out, launches["fma_probe"] = counted(
        lambda: {(variant, layout): fma.rasterize_fma(*args(v), **kw(v),
                                                      layout=layout)
                 for variant, v in views.items() for layout in fma.LAYOUTS},
        dict(ids=1, depth=1, field_ids=1, field_depth=1),
        "rasterize_fma, both views and layouts")
    for (variant, layout), got in sorted(out.items()):
        v = views[variant]
        assert _equal(got, v["plain"]), f"K4 {variant} {layout} != plain"
        assert _equal(got, full_out[variant]), \
            f"K4 {variant} {layout} != the phase-4 K1/K2 output"
        err = float((got[0] - v["plain"][0]).abs().max())
        rec, starts, counts = v["records"]
        guard = v["xrange"] is not None
        if layout == "t":
            rec_in, launch = rec.t().contiguous(), raster.raster_tiles_field
            plain_rec = rec_in.t()
        else:
            rec_in, launch, plain_rec = rec, raster.raster_tiles, rec
        ms = cuda_ms(lambda: launch(rec_in, starts, counts, v["W"], v["H"],
                                    v["ids"], guard), 20)
        dev_ms = device_ms(lambda: launch(rec_in, starts, counts, v["W"],
                                          v["H"], v["ids"], guard), 20,
                           "raster_tiles_field_kernel" if layout == "t"
                           else "raster_tiles_kernel")
        plain_ms = cuda_ms(lambda: raster.rasterize_plain(
            plain_rec, starts, counts, v["W"], v["H"], v["ids"], guard), 3)
        kind = "field-major (16, P)" if layout == "t" else "pair-major (P, 16)"
        name = (f"K4 {v['view']}, layout '{layout}': {kind} records "
                f"(fma_kernel_probe.py:145)")
        phase(f"[12] {name}: {v['W']}x{v['H']}, {v['pairs']} pairs, equal "
              f"to rasterize_plain and to phase 4's launch (torch.equal); "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, {v['note']}")
        kernels.append(dict(
            name=name, route="cuda",
            source="crychic_renderer_tpu_torch/csrc/raster.cu",
            replaces="experiments/fma_kernel_probe.py:37",
            variant=("field_" if layout == "t" else "") + variant,
            runs=["fma_probe"], max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, library_ms=None, **v["bound"]))
    phase(f"[12] rasterize_fma launches {launches['fma_probe']}")

    # 13. K5: the kernel alone inside the binning decomposition
    for variant, v in views.items():
        fns = bd.pieces(*args(v), **kw(v))
        alone = fns["kernel_only"]()
        full = fns["rasterize"]()
        torch.cuda.synchronize()
        assert not bool(full[2]), f"K5 {variant}: overflow"
        assert _equal(alone, v["plain"]), f"K5 {variant}: != plain"
        assert _equal(alone, full[:2]), f"K5 {variant}: != rasterize"
        run = f"bin_decomp_{variant}"
        times, launches[run] = counted(
            lambda: bd.decompose(v["view"], *args(v), **kw(v),
                                 reps=DECOMP_REPS),
            {variant: 2 * (1 + DECOMP_REPS)}, f"decompose {v['view']}")
        name = (f"K5 {v['view']}: the raster kernel alone on precomputed "
                f"inputs (bin_decomp_probe.py:119)")
        phase(f"[13] {name}: equal to rasterize_plain and the full "
              f"rasterize (torch.equal); pieces (ms) "
              f"{ {k: round(t, 4) for k, t in times.items()} }; launches of "
              f"the decompose run {launches[run]} (kernel alone and full "
              f"rasterize, {1 + DECOMP_REPS} each); plain "
              f"{v['plain_ms']:.4f} ms (phase 4), {v['note']}")
        kernels.append(dict(
            name=name, route="cuda",
            source="crychic_renderer_tpu_torch/csrc/raster.cu",
            replaces="experiments/bin_decomp_probe.py:119", variant=variant,
            runs=[run], max_abs_err=float(
                (alone[0] - v["plain"][0]).abs().max()),
            ms=times["kernel_only"], plain_ms=v["plain_ms"],
            library_ms=None, **v["bound"]))


def profile_run(r, launches):
    """Phase 14: profile_frame of the Renderer `r`. Each timed stage
    runs 2 + reps times (warm-up, reps, the output for the next stage),
    TOTAL_fused 1 + reps. Returns the report."""
    from crychic_renderer_tpu_torch.app import profiler

    n = 3 + 2 * PROFILE_REPS
    report, launches["profiler"] = counted(
        lambda: profiler.profile_frame(r, reps=PROFILE_REPS),
        dict(ids=n, depth=n), "profile_frame")
    stages = {k: v for k, v in report.items() if k != "TOTAL_fused"}
    phase(f"[14] profile_frame, config 4 {r.cfg.width}x{r.cfg.height}, "
          f"{PROFILE_REPS} reps after 1 warm-up, host clock per stage "
          f"ending in a synchronize (ms): "
          f"{ {k: round(v, 3) for k, v in stages.items()} }; sum of stages "
          f"{sum(stages.values()):.3f} (bin_main is also inside "
          f"raster_main), TOTAL_fused {report['TOTAL_fused']:.3f}; "
          f"launches {launches['profiler']}")
    return report


def app_runs(dev, launches):
    """Phase 15: compare.parity at 480x270 and a scripted viewer run on
    the card."""
    from crychic_renderer_tpu_torch.app import compare, viewer

    # the kernel frame's first render: its eager frame and a replay; the
    # pure-XLA frame (parity's "xla") launches no raster kernel
    report, launches["parity"] = counted(
        lambda: compare.parity([4], True, dev), dict(ids=2, depth=2),
        "compare.parity")
    assert report["ok"], f"parity: {report}"
    phase(f"[15] compare.parity([4], small=True) on the card vs the CPU "
          f"path (and, under 'xla', vs the card's pure-XLA frame): "
          f"{report[4]}; launches {launches['parity']}")
    n = len(VIEWER_SCRIPT)
    frames, launches["viewer"] = counted(
        lambda: viewer.main(["--config", "4", "--script", VIEWER_SCRIPT,
                             "--no-draw", "--device", "cuda"]),
        dict(ids=n, depth=n), "viewer", per_capture=dict(ids=1, depth=1))
    assert frames == n, frames
    phase(f"[15] viewer: {frames} scripted frames ('{VIEWER_SCRIPT}') on the "
          f"card, fast preset 1280x720, {viewer.DEPTH} in flight, no "
          f"overflow; launches {launches['viewer']}")


def default_textures(scene):
    """Which of `scene`'s texture slots a Renderer built without asset_dir
    reads from files: the default asset directory is the JAX package's,
    and a slot whose file is absent renders white 1x1, so phases 1-19
    measure textured work only on a host that holds the files."""
    from crychic_renderer_tpu_torch.app import renderer as ren

    d = ren.DEFAULT_ASSET_DIR
    found = [n for n in scene.texture_names
             if (n in ren._TEXTURE_FILES and os.path.isfile(
                 os.path.join(d, ren._TEXTURE_FILES[n])))
             or (n in ren._ANIM_SLOTS and os.path.isdir(
                 os.path.join(d, ren._ANIM_SLOTS[n][0])))]
    return (f"default asset dir {d}: present {os.path.isdir(d)}; slots "
            f"read from files {found}, the other "
            f"{len(scene.texture_names) - len(found)} white 1x1 (phases "
            f"1-19 build their Renderers with this default)")


def raster_vs_plain(name, records, W, H, ids, xrange):
    """The raster kernel (raster_tiles: K1 with ids, K2 with the column
    guard) against rasterize_plain on the same binned records: no
    overflow, depth (and tid) equal bit for bit (torch.equal), something
    rasterized. Returns (the kernel's (depth, tid), the plain version's,
    max |err|)."""
    from crychic_renderer_tpu_torch.ops import raster

    rec, starts, counts, over = records
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
    return (d_k, t_k), (d_p, t_p), err


def frame_raster_vs_plain(r, t):
    """Phase 4's check on the inputs that the frame of the Renderer `r` at
    time `t` gives the raster kernel: the main view (K1) and, with
    shadows, the atlas (K2), binned at r's capacities. Returns a note
    with each view's pair count."""
    from crychic_renderer_tpu_torch.ops import raster
    from crychic_renderer_tpu_torch.passes import frame as fr

    cfg = r.cfg
    consts = r.frame_constants(t)
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    views = [("K1 main view", tris, None, cfg.width, cfg.height,
              cfg.pair_capacity, True)]
    if cfg.shadows_enabled:
        S = cfg.shadow_map_size
        atris, xr = fr.shadow_atlas_tris(
            r.device_scene, consts.shadow_visibility,
            consts.cascade_view_projs, cfg)
        views.append(("K2 atlas", atris, xr, 4 * S, S,
                      cfg.shadow_pair_capacity, False))
    notes = []
    for name, tris_v, xr, W, H, cap, ids in views:
        records = raster.binned_records(tris_v, W, H, cap, xrange=xr)
        _, _, err = raster_vs_plain(name, records, W, H, ids, xr is not None)
        notes.append(f"{name} {W}x{H}: {int(records[2].sum())} pairs "
                     f"(capacity {cap}) equal to rasterize_plain (max "
                     f"|err| {err})")
    return "; ".join(notes)


def run_frames(r, per_frame):
    """FRAMES_WARMUP + FRAMES_TIMED frames through r.render with every
    launch count set to 0 just before and read just after. Checks the
    counts (per_frame launches of each kernel per frame, and per eager
    frame before a capture), overflow and the last frame; returns (median
    ms/frame, counts)."""
    from crychic_renderer_tpu_torch.ops import pcf, raster

    raster.reset_launches()
    pcf.reset_launches()
    c0 = captures()
    n = FRAMES_WARMUP + FRAMES_TIMED
    times = []
    img = None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render(i / 60.0)
        torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t0))
    counts = launch_counts()
    r.check_overflow()
    frames = n + captures() - c0
    want = {k: v * frames for k, v in per_frame.items()}
    assert counts == want, (f"launches {counts} for {n} frames and "
                            f"{frames - n} captures, want {want}")
    img = img.cpu().numpy()
    assert img.shape == (r.cfg.height, r.cfg.width, 4)
    assert np.isfinite(img).all(), "non-finite pixels"
    return statistics.median(times[FRAMES_WARMUP:]), counts


def small_frame_vs_cpu(dev, options):
    """A 240x135 config-4 frame (with `options`) on the card against the
    port's CPU path: (share of pixels > 0.02, per-pixel max |diff|)."""
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS

    scene, cfg, lights = CONFIGS[4]()
    return frame_vs_cpu(dev, scene, dataclasses.replace(
        cfg, width=240, height=135, shadow_map_size=256, **options), lights)


def frame_vs_cpu(dev, scene, cfg, lights, **kw):
    """The frame of (scene, cfg, lights) on the card against the port's
    CPU path, both Renderers built with the keywords `kw`: (share of
    pixels > 0.02, per-pixel max |diff|)."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    img_gpu = Renderer(scene, cfg, lights=lights, device=dev,
                       **kw).render_np(0.0)
    img_cpu = Renderer(scene, cfg, lights=lights, device="cpu",
                       **kw).render_np(0.0)
    diff = np.abs(img_gpu - img_cpu).max(axis=-1)
    frac = float((diff > 0.02).mean())
    assert np.isfinite(img_gpu).all() and frac <= PIX_BOUND, (
        f"{cfg.width}x{cfg.height} frame: {frac:.4%} of pixels differ "
        f">0.02 from the CPU path")
    return frac, diff


def timed_config(dev, name, scene, cfg, lights, per_frame, frame_ms,
                 launches, **kw):
    """FRAMES_WARMUP + FRAMES_TIMED frames of (scene, cfg, lights) at its
    size through Renderer.render (run_frames: counts, overflow, finite);
    records the median and the counts under `name`. Returns the
    Renderer (built with the keywords `kw`)."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    r = Renderer(scene, cfg, lights=lights, device=dev, **kw)
    frame_ms[name], launches[name] = run_frames(r, dict(ZERO, **per_frame))
    return r


def forward_runs(dev, frame_ms, launches):
    """Phases 16-17: config 1, config 4 forward Blinn-Phong with shadows
    and config 3's point-light rig on config 4's scene (see the module
    doc)."""
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    def small(cfg):
        return dataclasses.replace(cfg, width=240, height=135,
                                   shadow_map_size=256)

    scene4, cfg4, lights4 = sb.config4_shadow_pipeline()
    forward = dataclasses.replace(cfg4, deferred=False, use_pbr=False)
    scene1, cfg1, lights1 = sb.config1_woodcrate()
    scene3, cfg3, lights3 = sb.config3_rig_on_config4()
    for tag, name, scene, cfg, lights, per_frame in (
            ("16", "config1", scene1, cfg1, lights1, dict(ids=1)),
            ("16", "forward", scene4, forward, lights4, dict(ids=1, depth=1)),
            ("17", "rig", scene3, cfg3, lights3, dict(ids=1))):
        frac, diff = frame_vs_cpu(dev, scene, small(cfg), lights)
        r = timed_config(dev, name, scene, cfg, lights, per_frame, frame_ms,
                         launches)
        phase(f"[{tag}] {name} (deferred={cfg.deferred}, use_pbr="
              f"{cfg.use_pbr}, shadows={cfg.shadows_enabled}, lights "
              f"{cfg.num_dir_lights} dir / {cfg.num_point_lights} point): "
              f"240x135 on the card vs the CPU path {frac:.4%} of pixels "
              f">0.02 (max {diff.max():.3g}); {r.cfg.width}x{r.cfg.height}: "
              f"{FRAMES_WARMUP} warm-up + {FRAMES_TIMED} frames, median "
              f"{frame_ms[name]:.3f} ms/frame; launches {launches[name]}; "
              f"no overflow")
        del r


def fence_runs(dev, frame_ms, launches):
    """Phase 18: the fence scene with the synthetic wire grid (see the
    module doc)."""
    from crychic_renderer_tpu_torch.app import profiler
    from crychic_renderer_tpu_torch.app.renderer import synthetic_wire_fence
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    scene, cfg, lights = sb.fence_scene(alpha_test=True)
    with synthetic_wire_fence():
        frac, diff = frame_vs_cpu(dev, scene, cfg, lights)
        full = dataclasses.replace(cfg, width=1920, height=1080)
        r = timed_config(dev, "fence", scene, full, lights,
                         dict(ids=1, depth=1), frame_ms, launches)
    req = r.capacity_requirements(0.0)
    n = 3 + 2 * PROFILE_REPS
    report, launches["fence_profiler"] = counted(
        lambda: profiler.profile_frame(r, reps=PROFILE_REPS),
        dict(ids=n, depth=n), "profile_frame of the fence")
    assert "alpha_merge_main" in report and "alpha_merge_shadow" in report
    frame_ms["fence_profile_stages"] = report
    phase(f"[18] fence_scene (alpha test, synthetic wire grid): "
          f"{cfg.width}x{cfg.height} on the card vs the CPU path "
          f"{frac:.4%} of pixels >0.02 (max {diff.max():.3g}); 1920x1080 "
          f"with capacities from capacity_requirements (main "
          f"{req['main_pairs']} -> {r.cfg.pair_capacity}, shadow "
          f"{req['shadow_pairs']} -> {r.cfg.shadow_pair_capacity}): "
          f"{FRAMES_WARMUP} warm-up + {FRAMES_TIMED} frames, median "
          f"{frame_ms['fence']:.3f} ms/frame; launches {launches['fence']} "
          f"(K1 {launches['fence']['ids']}, K2 {launches['fence']['depth']})"
          f"; profile_frame (ms): "
          f"{ {k: round(v, 3) for k, v in report.items()} }, the peel's "
          f"stages alpha_merge_main {report['alpha_merge_main']:.3f} and "
          f"alpha_merge_shadow {report['alpha_merge_shadow']:.3f} ms; "
          f"launches {launches['fence_profiler']}")


def asset_runs(dev, frame_ms, launches):
    """Phases 20-21: configs 5, 2 and 3 from the full-size synthetic asset
    set written under build/ (see the module doc)."""
    from crychic_renderer_tpu_torch.app import profiler
    from crychic_renderer_tpu_torch.app import renderer as ren
    from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "synthetic_assets")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths = sa.write_asset_set(root, sa.FULL, seed=0)
    write_s = time.perf_counter() - t0
    sb.REF_MODELS = paths["models"]
    kw = dict(asset_dir=paths["textures"], sky_cubemap_path=paths["sky_cube"])
    t0 = time.perf_counter()
    scene, cfg, lights = sb.CONFIGS[5]()
    t1 = time.perf_counter()
    chains, anim = ren.load_texture_chains(scene.texture_names,
                                           paths["textures"])
    t2 = time.perf_counter()
    faces = ren.load_sky_cubemap(paths["sky_cube"])
    t3 = time.perf_counter()
    n_frames = {scene.texture_names[s]: len(f) for s, (f, _) in anim.items()}
    assert n_frames == {"bolt_anim": 15, "fire_anim": 15}, n_frames
    side, cube = sa.FULL.texture, sa.FULL.cube
    assert chains[0][0].shape == (side, side, 4), chains[0][0].shape
    assert len(chains[0]) == side.bit_length(), len(chains[0])
    assert faces.shape == (6, cube, cube, 4), faces.shape
    small = dataclasses.replace(cfg, width=240, height=135,
                                shadow_map_size=256)
    frac, diff = frame_vs_cpu(dev, scene, small, lights, **kw)
    t4 = time.perf_counter()
    r = timed_config(dev, "config5", scene, cfg, lights,
                     dict(ids=1, depth=1), frame_ms, launches, **kw)
    bolt = 6  # config 5's "bolt" material, the BoltAnim slot's
    base, count, fps = r.anim_specs[bolt]
    walked = sorted({base + int(i / 60.0 * fps) % count for i in
                     range(FRAMES_WARMUP + FRAMES_TIMED)})
    last = int(r.device_scene.mat_pair[bolt])
    assert len(walked) > 1 and last == walked[-1] != \
        int(r._base_mat_pair[bolt]), (walked, last)
    last_t = (FRAMES_WARMUP + FRAMES_TIMED - 1) / 60.0
    raster_note = frame_raster_vs_plain(r, last_t)
    req = r.capacity_requirements(0.0)
    n = 3 + 2 * PROFILE_REPS
    report, launches["config5_profiler"] = counted(
        lambda: profiler.profile_frame(r, reps=PROFILE_REPS),
        dict(ids=n, depth=n), "profile_frame of config 5")
    frame_ms["config5_profile_stages"] = report
    phase(f"[20] config 5 from the synthetic set (seed 0, {side}^2 "
          f"textures, {cube}^2 cube faces): written in "
          f"{write_s:.2f} s; decoded: meshes + scene {t1 - t0:.2f} s, "
          f"textures and {sum(n_frames.values())} BMP frames "
          f"{t2 - t1:.2f} s, the DXT1 cube {t3 - t2:.2f} s; "
          f"pair pool on the card {r.device_scene.pair_data.numel() * 4} "
          f"bytes ({r.device_scene.n_big_pairs} big pairs), cube "
          f"{r.device_scene.cubemap.numel() * 4} bytes; 240x135 with the "
          f"loaded cube on the card vs the CPU path {frac:.4%} of pixels "
          f">0.02 (max {diff.max():.3g}; both Renderers built from the "
          f"files in {t4 - t3:.1f} s); {r.cfg.width}x{r.cfg.height} (main "
          f"{req['main_pairs']} -> {r.cfg.pair_capacity}, shadow "
          f"{req['shadow_pairs']} -> {r.cfg.shadow_pair_capacity} pairs): "
          f"{FRAMES_WARMUP} warm-up + {FRAMES_TIMED} frames, median "
          f"{frame_ms['config5']:.3f} ms/frame; BoltAnim pairs walked "
          f"{walked}; launches {launches['config5']}; no overflow; at "
          f"t={last_t:.4f} s {raster_note}; profile_frame (ms): "
          f"{ {k: round(v, 3) for k, v in report.items()} }, "
          f"resolve_gbuffer "
          f"{report['resolve_gbuffer'] / report['TOTAL_fused']:.1%} of "
          f"TOTAL_fused; launches {launches['config5_profiler']}")
    del r

    for name in ("config2", "config3"):
        scene, cfg, lights = sb.CONFIGS[int(name[-1])]()
        small = dataclasses.replace(cfg, width=240, height=135)
        frac, diff = frame_vs_cpu(dev, scene, small, lights,
                                  asset_dir=paths["textures"])
        r = timed_config(dev, name, scene, cfg, lights, dict(ids=1),
                         frame_ms, launches, asset_dir=paths["textures"])
        raster_note = frame_raster_vs_plain(r, last_t)
        phase(f"[21] {name} as written (synthetic skull, {cfg.width}x"
              f"{cfg.height}, deferred={cfg.deferred}, lights "
              f"{cfg.num_dir_lights} dir / {cfg.num_point_lights} point): "
              f"240x135 on the card vs the CPU path {frac:.4%} of pixels "
              f">0.02 (max {diff.max():.3g}); {FRAMES_WARMUP} warm-up + "
              f"{FRAMES_TIMED} frames, median {frame_ms[name]:.3f} ms/frame;"
              f" launches {launches[name]}; no overflow; at t={last_t:.4f}"
              f" s {raster_note}")
        del r
    return kw


def pcf_520(dev, frame_ms, launches):
    """Phase 19: K6 on 520^2 maps, whose window-ready buffer (a 544-texel
    pitch) the card textures (see the module doc). Returns the
    kernels-line entry."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu_torch.ops import pcf, raster, shadows
    from crychic_renderer_tpu_torch.passes import frame as fr

    S = 520
    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, shadow_map_size=S, pcf_radius_texels=SOFT)
    r = Renderer(scene, cfg, lights=lights, device=dev)
    cfg = r.cfg
    c = r.frame_constants(0.0)
    tris, attr = fr.main_view_tris(r.device_scene, c, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(r.device_scene, c, cfg, tris, depth, tid, attr)
    maps = fr.render_shadow_atlas(r.device_scene, c.shadow_visibility,
                                  c.cascade_view_projs, cfg)
    _, _, cascades, pos = shadows.cascade_select(c.shadow_transforms,
                                                 g["pos_w"], c.eye_pos)
    qmap = pcf.quantize_map(maps)
    params = pcf.receiver_params(pos.reshape(-1, 4), cascades.reshape(-1), S)
    assert (2 * S) % 32 != 0, "S = 520 is meant to be off the pitch alignment"
    tex, has_tex = pcf.make_texture(qmap)
    assert has_tex == 1, "the 520^2 window-ready buffer has no texture"
    pcf.destroy_texture(tex)
    f_k = pcf.soft_pcf(qmap, params, SOFT)
    torch.cuda.synchronize()
    f_p = pcf.soft_pcf_plain(qmap, params, SOFT)
    err = float((f_k - f_p).abs().max())
    assert torch.isfinite(f_k).all() and err <= PCF_TOL, \
        f"K6 at S={S}: max |err| {err} vs plain"
    ms = cuda_ms(lambda: pcf.soft_pcf(qmap, params, SOFT), 20)
    dev_ms = device_ms(lambda: pcf.soft_pcf(qmap, params, SOFT), 20,
                       "soft_pcf_kernel")
    plain_ms = cuda_ms(lambda: pcf.soft_pcf_plain(qmap, params, SOFT), 3)
    m = params.shape[1]
    b, note = k6_bound(qmap, params)
    edge = last_block_share(params, S)
    frame_ms["soft_520"], launches["soft_520"] = run_frames(
        r, dict(ZERO, ids=1, depth=1, pcf=1))
    phase(f"[19] K6 soft PCF on {S}^2 maps ({2 * S}-byte rows, off the "
          f"texture pitch alignment), read from the {tuple(qmap.shape)} "
          f"window-ready buffer ({2 * qmap.shape[2]}-byte rows) through "
          f"its texture object: every receiver on the gather path; {m} "
          f"receiver-cascades at {cfg.width}x{cfg.height}, all of them on "
          f"the former kernel's scalar path (no texture), {edge:.2%} with "
          f"a window on the last block; max |err| {err} vs "
          f"soft_pcf_plain; kernel {ms:.4f} ms (device {dev_ms:.4f}; the "
          f"scalar path read {K6_520_SCALAR_MS} on an NVIDIA H100 80GB "
          f"HBM3 at 700.00 W), plain {plain_ms:.4f} ms, {note}, device "
          f"time {b['bound_ms'] / dev_ms:.1%} of the bound; the soft-disk "
          f"frame on {S}^2 maps: {FRAMES_WARMUP} warm-up + {FRAMES_TIMED} "
          f"frames, median {frame_ms['soft_520']:.3f} ms/frame; launches "
          f"{launches['soft_520']}; no overflow")
    return dict(
        name=f"K6 soft-disk PCF at S={S}: the window-ready buffer of a map "
             f"whose rows are off the texture pitch alignment "
             f"(shadows.py:319)", route="cuda",
        source="crychic_renderer_tpu_torch/csrc/pcf.cu",
        replaces="experiments/pcf_probe.py:46", variant="pcf",
        runs=["soft_520"], max_abs_err=err, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, library_ms=None, receivers=m,
        map_buffer=list(qmap.shape), last_block_share=edge, **b)


def pcf_edge_params(S, n, seed, cascades=4):
    """(qmap, params) for phase 27: patchy maps made with numpy from
    `seed`, and n receivers whose window corner cx, cy lies within 8
    texels of the map's low edge, within 8 of its high edge, or inside,
    independently in x and y, in every cascade, with depths near the
    map's; then 1,000 receivers each with one parameter (cx, cy, dq, cos,
    sin, cascade by turns) set to NaN, +inf, -inf, 1e30 or -1e30."""
    from crychic_renderer_tpu_torch.ops import pcf

    rng = np.random.default_rng(seed)

    def coord():
        return np.choose(rng.integers(0, 3, n),
                         [rng.uniform(-8.5, 8.5, n),
                          rng.uniform(S - 9.5, S + 7.5, n),
                          rng.uniform(8.0, S - 9.0, n)])

    yy, xx = np.mgrid[0:S, 0:S]
    ph = rng.uniform(0, 6, (cascades, 2))
    maps = np.stack([0.5 + 0.3 * np.sin(xx / (7.0 + c % 4) + ph[c, 0])
                     * np.cos(yy / (5.0 + c % 4) + ph[c, 1])
                     for c in range(cascades)]).astype(np.float32)
    cx, cy = coord(), coord()
    casc = rng.integers(0, cascades, n)
    ix = np.clip(np.floor(cx + 0.5).astype(int), 0, S - 1)
    iy = np.clip(np.floor(cy + 0.5).astype(int), 0, S - 1)
    dq = (maps[casc, iy, ix] + rng.uniform(-0.05, 0.05, n)) * 65535.0 - 0.5
    theta = rng.uniform(0, 2 * np.pi, n)
    params = np.stack([cx, cy, dq, np.cos(theta), np.sin(theta),
                       casc]).astype(np.float32)
    extreme = [np.nan, np.inf, -np.inf, 1e30, -1e30]
    for k in range(1000):
        params[k % pcf.PARAMS, k] = extreme[k % len(extreme)]
    dev = torch.device("cuda", 0)
    return (pcf.quantize_map(torch.from_numpy(maps).to(dev)),
            torch.from_numpy(params).to(dev))


def pcf_edge_runs(card):
    """Phase 27 (see the module doc). Returns {case: max |err|}."""
    from crychic_renderer_tpu_torch.ops import pcf

    lim = pcf.texture_limits(torch.device("cuda", 0))
    four = (lim["max_height"] // 4 - pcf.WINDOW_PAD) // 8 * 8 + 8
    phase(f"[27] {card}; texture limits {lim}: four cascades take the "
          f"scalar path from S = {four}")
    out = {}
    fit = lim["max_height"] // (136 + pcf.WINDOW_PAD)
    for name, S, n, cascades in (
            ("S=520", 520, 200_001, 4), ("S=2048", 2048, 1_000_001, 4),
            (f"past the limits, S=136 x {fit + 1} cascades", 136, 200_001,
             fit + 1)):
        qmap, params = pcf_edge_params(S, n, seed=S + cascades,
                                       cascades=cascades)
        tex, has_tex = pcf.make_texture(qmap)
        if has_tex:
            pcf.destroy_texture(tex)
        assert has_tex == (cascades * (S + pcf.WINDOW_PAD)
                           <= lim["max_height"]), (name, has_tex)
        f_k = pcf.soft_pcf(qmap, params, SOFT)
        torch.cuda.synchronize()
        f_p = pcf.soft_pcf_plain(qmap, params, SOFT)
        err = float((f_k - f_p).abs().max())
        assert bool(f_k.isfinite().all()) and err <= PCF_TOL, \
            f"K6 {name}: max |err| {err} vs plain"
        out[name] = err
        phase(f"[27] K6 {name}: {n} receiver-cascades on the "
              f"{tuple(qmap.shape)} buffer "
              f"({'texture' if has_tex else 'no texture: scalar path'}), "
              f"{last_block_share(params, S):.2%} with a window on the "
              f"last block, 1,000 with a NaN, +-inf or +-1e30 parameter: "
              f"torch.equal to soft_pcf_plain {torch.equal(f_k, f_p)}, "
              f"max |err| {err}")
    return out


def full_size_runs(dev, frame_ms, launches, card):
    """Phase 28 (see the module doc)."""
    from crychic_renderer_tpu_torch.app import compare, run
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS

    phase(f"[28] card: {card}")
    scene, cfg, lights = CONFIGS[4]()
    for name, options, per_frame in (
            ("zero", {}, dict(ids=2, depth=2)),
            ("soft", dict(pcf_radius_texels=SOFT),
             dict(ids=2, depth=2, pcf=2))):
        t0 = time.perf_counter()
        # the card's first render: its eager frame and a replay
        (frac, diff), launches[f"p28_{name}"] = counted(
            lambda: frame_vs_cpu(dev, scene, dataclasses.replace(
                cfg, **options), lights), per_frame, f"p28 {name}")
        secs = time.perf_counter() - t0
        frame_ms[f"p28_{name}"] = dict(frac=frac, max=float(diff.max()),
                                       mean=float(diff.mean()), s=secs)
        phase(f"[28] config 4 {name} {cfg.width}x{cfg.height} on the card "
              f"vs the CPU path: {frac:.4%} of pixels >0.02 (max "
              f"{diff.max():.3g}, mean {diff.mean():.3g}); {secs:.1f} s; "
              f"launches {launches[f'p28_{name}']}")

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "p28")
    os.makedirs(root, exist_ok=True)
    frames = 3
    argv = ["--config", "4", "--frames", str(frames), "--orbit", "--stats",
            "--out", os.path.join(root, "orbit.png")]
    buf = io.StringIO()
    c0 = captures()
    with contextlib.redirect_stdout(buf):
        # 1 + frames renders: the first captures (one eager frame more)
        (r, img), launches["p28_run"] = counted(
            lambda: run.main(argv), dict(ids=1 + frames, depth=1 + frames),
            "run --orbit --stats", per_capture=dict(ids=1, depth=1))
    n_captures = captures() - c0
    assert n_captures == 1, f"run --orbit captured {n_captures} graphs"
    stats = json.loads(buf.getvalue().splitlines()[-1])
    assert list(stats) == ["ms_per_frame", "fps", "config", "capacity",
                           "pair_capacity", "shadow_pair_capacity"], stats
    turned = not np.array_equal(r.camera.view, r._default_camera().view)
    want = eager_render(r, (frames - 1) / 60.0)
    assert turned and torch.equal(img, want), (
        "run --orbit: the last frame is not render_frame at the turned "
        "camera")
    phase(f"[28] app.run.main({' '.join(argv[:-2])}): one capture, the "
          f"last frame torch.equal to render_frame at the turned camera "
          f"(0.05 rad x {frames}); stats line {json.dumps(stats)}; "
          f"launches {launches['p28_run']}")
    del r, img, want

    path = os.path.join(root, "parity.json")
    argv = ["--parity", "--small", "--configs", "4", "--json-out", path]
    buf = io.StringIO()

    def parity_main():
        with contextlib.redirect_stdout(buf):
            try:
                compare.main(argv)
            except SystemExit as e:
                return e.code
        return None

    code, launches["p28_compare"] = counted(
        parity_main, dict(ids=2, depth=2), "compare --parity --json-out")
    printed = json.loads(buf.getvalue().splitlines()[-1])
    with open(path) as f:
        written = json.load(f)
    assert code == 0 and printed["ok"], f"compare exited {code}: {printed}"
    assert written == printed, "compare --json-out: the file differs"
    frame_ms["p28_compare"] = printed
    phase(f"[28] app.compare.main({' '.join(argv[:-1])} PATH): exit code "
          f"0, the file equal to the printed report {json.dumps(printed)}; "
          f"launches {launches['p28_compare']}")


def uncounted(fn):
    """fn() with the launches it makes taken back out of the counts: a
    kernel held against its plain version is no launch of the path."""
    from crychic_renderer_tpu_torch.ops import pcf, raster

    torch.cuda.synchronize()
    by_variant, total, k6 = (dict(raster.LAUNCHES_BY_VARIANT),
                             raster.LAUNCHES, pcf.LAUNCHES)
    try:
        return fn()
    finally:
        torch.cuda.synchronize()
        raster.LAUNCHES_BY_VARIANT.update(by_variant)
        raster.LAUNCHES, pcf.LAUNCHES = total, k6


@contextlib.contextmanager
def held_renderers(checks, cpu_frame):
    """Inside the block, every app.renderer.Renderer a script builds holds
    each frame it renders: its raster launches (K1, and K2 with shadows)
    on that frame's inputs against rasterize_plain (torch.equal), and,
    where cpu_frame(cfg), the frame against the port's CPU path built the
    same way (<= PIX_BOUND), both uncounted. Appends one note per frame
    to `checks`."""
    from crychic_renderer_tpu_torch.app import renderer as ren

    base = ren.Renderer

    class Held(base):
        def __init__(self, scene, cfg, **kw):
            super().__init__(scene, cfg, **kw)
            self._built = scene, kw

        def render_np(self, total_time=0.0):
            img = super().render_np(total_time)
            cfg = self.cfg
            view = f" {cfg.debug_view}" if cfg.debug_view else ""
            note = (f"{cfg.width}x{cfg.height}{view}: " + uncounted(
                lambda: frame_raster_vs_plain(self, total_time)))
            if cpu_frame(cfg):
                scene, kw = self._built
                ref = base(scene, cfg, **dict(kw, device="cpu")).render_np(
                    total_time)
                diff = np.abs(img - ref).max(axis=-1)
                frac = float((diff > 0.02).mean())
                assert frac <= PIX_BOUND, (
                    f"{note}: {frac:.4%} of pixels > 0.02 from the CPU path")
                note += (f"; the frame vs the CPU path {frac:.4%} of pixels "
                         f"> 0.02 (max {diff.max():.3g})")
            checks.append(note)
            return img

    ren.Renderer = Held
    try:
        yield
    finally:
        ren.Renderer = base


def entry_point_runs(dev, frame_ms, launches, card):
    """Phase 29 (see the module doc)."""
    from crychic_renderer_tpu_torch import graft_entry
    from crychic_renderer_tpu_torch.experiments import (
        aniso_quality, fast_quality, make_gallery)

    phase(f"[29] card: {card}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "p29")
    os.makedirs(root, exist_ok=True)
    result = {}

    # (a) entry on the card against the CPU path
    t0 = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    img, launches["p29_entry"] = counted(lambda: fn(*args), {}, "entry")
    fn_cpu, args_cpu = graft_entry.entry("cpu")
    img, ref = img.cpu().numpy(), fn_cpu(*args_cpu).numpy()
    diff = np.abs(img - ref).max(axis=-1)
    frac = float((diff > 0.02).mean())
    assert img.shape == (128, 256, 4) and np.isfinite(img).all()
    assert frac <= PIX_BOUND, f"entry: {frac:.4%} of pixels > 0.02"
    result["entry"] = dict(frac=frac, max=float(diff.max()),
                           s=time.perf_counter() - t0)
    phase(f"[29] graft_entry.entry('cuda') {img.shape[1]}x{img.shape[0]} "
          f"(use_pallas=False) vs entry('cpu'): {frac:.4%} of pixels > "
          f"0.02 (max {diff.max():.3g}); launches {launches['p29_entry']}")

    # (b) the dryrun: 4 gloo ranks sharing the card, then 1 NCCL rank,
    # each leg also against the CPU path; the parent renders each kernel
    # leg's single frame on the card (K1, K2), each rank an eager frame
    # and a replay per kernel leg (K3)
    for n, backend, legs, singles in ((4, "gloo", 2, 3), (1, "nccl", 1, 1)):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out, parent = counted(
                lambda: graft_entry.dryrun_multichip(n, backend, "cuda",
                                                     cpu_check=True),
                dict(ids=singles, depth=singles), f"dryrun {backend}")
        want = dict(ZERO, band_ids=2 * legs * n, band_depth=2 * legs * n)
        assert out.pop("launches") == want, (backend, want)
        key = f"p29_dryrun_{backend}"
        launches[key] = {k: parent[k] + want[k] for k in ZERO}
        secs = time.perf_counter() - t0
        result[key] = dict(out, s=secs)
        for line in buf.getvalue().splitlines():
            phase(f"[29] {backend}: {line}")
        phase(f"[29] dryrun_multichip({n}, '{backend}', 'cuda', cpu_check="
              f"True): {secs:.1f} s with spawn; launches (the parent's and "
              f"the ranks') {launches[key]}")

    # (c)-(e): the scripts, each Renderer's first render an eager frame
    # and a replay (K1, and K2 with shadows), each frame's raster held
    # against plain, aniso_quality's references also against the CPU
    # path; (configs, captures)
    def aniso_ref(cfg):
        return cfg.aniso_probes == 0 and not cfg.dual_mip_rows

    scripts = (
        ("fast_quality", lambda: fast_quality.main(
            ["--configs", "4", "5", "--gallery",
             os.path.join(root, "gallery")]), dict(ids=8, depth=8), 4,
         None),
        ("aniso_quality", lambda: aniso_quality.main([]),
         dict(ids=20, depth=10), 10, aniso_ref),
        ("gallery", lambda: make_gallery.main(
            ["--out", os.path.join(root, "gallery")]),
         dict(ids=14, depth=8), 7, None))
    for name, run, want, renders, cpu_frame in scripts:
        t0 = time.perf_counter()
        c0 = captures()
        buf = io.StringIO()
        checks = []
        with contextlib.redirect_stdout(buf), held_renderers(
                checks, cpu_frame or (lambda cfg: False)):
            rows, launches[f"p29_{name}"] = counted(run, want, name)
        n_captures = captures() - c0
        assert n_captures == renders, f"{name}: {n_captures} captures"
        secs = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            phase(f"[29] {name}: {line}")
        for note in checks:
            phase(f"[29] {name}: {note}")
        result[name] = dict(rows=rows, s=secs, checks=checks)
        phase(f"[29] {name}: {secs:.1f} s, {n_captures} captures, launches "
              f"{launches[f'p29_{name}']}")
    for c, row in result["fast_quality"]["rows"].items():
        assert 0.0 < row["ssim"] < 1.0 and np.isfinite(row["psnr"]), row
    for c, rows in result["aniso_quality"]["rows"].items():
        for psnr, f5, f2 in rows.values():
            assert np.isfinite(psnr) and 0.0 <= f5 <= f2 <= 1.0, (c, rows)
    # config 1's crate texture (WoodCrate01.dds) is not in the repository:
    # every schedule filters a white 1x1 to the same image, so its rows
    # measure nothing and stay out of the record
    result["aniso_quality"]["rows"] = {
        5: result["aniso_quality"]["rows"][5]}
    written = sorted(os.listdir(os.path.join(root, "gallery")))
    assert len(written) == 9, written  # the pair and the seven views
    frame_ms["p29"] = dict(result, card=card)


DEVICE_STAGES = ("resolve_gbuffer", "ssao", "lighting")
# device sleep that queues a stage's calls behind it (~0.2 s on an H100),
# longer than the host may take to issue one stage (STAGE_HOST_MS)
STAGE_SLEEP_CYCLES = 400_000_000
STAGE_HOST_MS = 100.0


def tile_grids(cfg):
    """(NT of the shade tiles, NT of the SSAO tiles) of cfg's screen."""
    from crychic_renderer_tpu_torch.passes import frame as fr

    return (-(-cfg.height // fr.SHADE_TILE_H) * -(-cfg.width //
                                                  fr.SHADE_TILE_W),
            -(-cfg.ssao_height // fr.SSAO_TILE_H) * -(-cfg.ssao_width //
                                                      fr.SSAO_TILE_W))


def tile_note(cfg, req):
    """The tile capacities the Renderer sized, their counts and grids."""
    nt, snt = tile_grids(cfg)
    return (f"shade tiles {req['shade_tiles']} -> shade_tile_capacity "
            f"{cfg.shade_tile_capacity} of {nt} (8, 128) tiles; ssao tiles "
            f"{req['ssao_tiles']} -> ssao_tile_capacity "
            f"{cfg.ssao_tile_capacity} of {snt} (8, 32) half-res tiles")


def occupied_tiles(cfg, tid):
    """The tiles the compacted passes evaluate on this coverage: shade
    tiles with a covered pixel, SSAO tiles within the blurs' reach."""
    from crychic_renderer_tpu_torch.passes import frame as fr

    valid = tid >= 0
    tiles, _, _ = fr._tiles(valid, fr.SHADE_TILE_H, fr.SHADE_TILE_W, False)
    shade = int(tiles.any(dim=1).sum())
    if not cfg.ssao_enabled:
        return shade, 0
    k, h, w = cfg.ssao_scale, cfg.ssao_height, cfg.ssao_width
    vh = valid[:h * k, :w * k].reshape(h, k, w, k).any(dim=3).any(dim=1)
    _, snt = tile_grids(cfg)
    occ = fr._ssao_tile_occupancy(vh, -(-h // fr.SSAO_TILE_H),
                                  -(-w // fr.SSAO_TILE_W))
    assert occ.numel() == snt
    return shade, int(occ.sum())


def stage_device_ms(scene, consts, cfg, reps=3):
    """Device time per call of the resolve_gbuffer, ssao and lighting
    stages of profiler.run_stages (the frame's stage chain), after one
    warm-up: {stage: (busy ms, span ms, launches, host ms)}. busy: the
    summed durations of the CUDA kernels and copies one call queues
    (torch.profiler); span: CUDA events around each call queued behind a
    device sleep (kernel_ab_probe.queued_event_ms), so the host's issue
    time is not in it and the stage's kernels run back to back. The span
    holds only while the host can queue the whole stage behind the sleep:
    a stage of thousands of launches (SSAO's ~3,100) fills the card's
    launch queue, and the host's issue time enters the span. host: the
    host clock around one call, without a synchronize (its issue time,
    while the launch queue has room)."""
    from torch.profiler import ProfilerActivity, profile

    from crychic_renderer_tpu_torch.app import profiler
    from crychic_renderer_tpu_torch.experiments import kernel_ab_probe

    out = {}

    def stage(name, fn):
        if name in DEVICE_STAGES:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            t0 = time.perf_counter()
            fn()
            host_ms = 1000.0 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            assert host_ms < STAGE_HOST_MS, \
                f"{name}: host issue {host_ms:.1f} ms"
            span = kernel_ab_probe.queued_event_ms(fn, reps,
                                                   STAGE_SLEEP_CYCLES)
            out[name] = (sum(ev) / 1000.0 / reps, span, len(ev) / reps,
                         host_ms)
        return fn()

    profiler.run_stages(scene, consts, cfg, stage)
    return out


def capture_soft_pcf(fn):
    """fn() with ops.pcf.soft_pcf recording its (qmap, params, radius):
    the K6 inputs the frame builds. Returns (fn's result, the calls)."""
    from crychic_renderer_tpu_torch.ops import pcf

    calls = []
    real = pcf.soft_pcf

    def recording(qmap, params, radius):
        calls.append((qmap, params, radius))
        return real(qmap, params, radius)

    pcf.soft_pcf = recording
    try:
        return fn(), calls
    finally:
        pcf.soft_pcf = real


def no_sync_passes(r, consts):
    """The three compacted passes of r's frame (the resolve, the SSAO
    occlusion, the PCF factor) under torch.cuda.set_sync_debug_mode
    ("error"), after one warm-up call each outside it: a host sync inside
    them raises. Returns the passes checked."""
    from crychic_renderer_tpu_torch.ops import raster, shadows
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg = r.device_scene, r.cfg
    tris, attr = fr.main_view_tris(scene, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    rec = fr._build_resolve_records(tris, attr)
    g, _ = fr._resolve_compacted(scene, consts, cfg, rec, tid)
    calls = {"resolve": lambda: fr._resolve_compacted(scene, consts, cfg,
                                                      rec, tid)}
    if cfg.ssao_enabled:
        n_half, d_half = fr.ssao_inputs_half(cfg, g["normal_v"], depth)
        calls["ssao"] = lambda: fr._ssao_occlusion_compacted(
            scene, consts, cfg, n_half, d_half, depth, tid >= 0)
    if cfg.shadows_enabled:
        maps = fr.render_shadow_atlas(scene, consts.shadow_visibility,
                                      consts.cascade_view_projs, cfg)

        def sf_fn(pw, dead):
            return shadows.cascade_shadow_factor(
                maps, consts.shadow_transforms, pw, consts.eye_pos,
                cfg.shadow_map_size, deferred_blend_quirk=cfg.deferred,
                soft_radius_texels=cfg.pcf_radius_texels, dead=dead)

        calls["pcf"] = lambda: fr._pcf_factor_compacted(
            cfg, g["pos_w"], g["valid"], sf_fn)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return list(calls)


def compaction_runs(dev, assets, frame_ms, launches):
    """Phase 22 (see the module doc). Returns the kernels-line entry of
    K6, measured on the soft-disk frame's compacted receivers."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.ops import raster
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene4, cfg4, lights4 = sb.CONFIGS[4]()
    cells = [  # in P22_CELLS' order
        ("config4", scene4, cfg4, lights4, {}, dict(ids=1, depth=1)),
        ("config4_soft", scene4,
         dataclasses.replace(cfg4, pcf_radius_texels=SOFT), lights4, {},
         dict(ids=1, depth=1, pcf=1)),
        ("config5", *sb.CONFIGS[5](), assets, dict(ids=1, depth=1)),
        ("config2", *sb.CONFIGS[2](), dict(asset_dir=assets["asset_dir"]),
         dict(ids=1)),
    ]
    assert tuple(c[0] for c in cells) == P22_CELLS
    k6 = None
    for name, scene, cfg, lights, kw, per_frame in cells:
        r = Renderer(scene, cfg, lights=lights, device=dev, **kw)
        cfg = r.cfg
        dense = dataclasses.replace(cfg, shade_tile_capacity=None,
                                    ssao_tile_capacity=None)
        assert cfg.shade_tile_capacity and (
            cfg.ssao_tile_capacity or not cfg.ssao_enabled), name
        req = r.capacity_requirements(0.0)
        consts = r.frame_constants(0.0)
        tris, attr = fr.main_view_tris(r.device_scene, consts, cfg)
        depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                         cfg.pair_capacity)
        occ, socc = occupied_tiles(cfg, tid)
        nt, snt = tile_grids(cfg)

        # the compacted frame against the dense one, same inputs
        img_c, k6_calls = capture_soft_pcf(
            lambda: fr.render_frame(r.device_scene, consts, cfg))
        img_d = fr.render_frame(r.device_scene, consts, dense)
        diff = (img_c - img_d).abs().amax(dim=-1)
        max_diff = float(diff.max())
        above = int((diff > 0.02).sum())
        assert bool(img_c.isfinite().all()), f"{name}: non-finite pixels"
        assert max_diff <= PCF_TOL and above == 0, \
            f"{name}: compacted vs dense max {max_diff}, {above} > 0.02"

        checked = no_sync_passes(r, consts)
        stages = {mode: stage_device_ms(r.device_scene, consts, c)
                  for mode, c in (("compacted", cfg), ("dense", dense))}

        # ms/frame in turns: compacted, dense, dense, compacted
        ms = {"compacted": [], "dense": []}
        for i, mode in enumerate(P22_TURNS):
            r.cfg = cfg if mode == "compacted" else dense
            run = f"p22_{name}_{mode}_{i}"
            t, launches[run] = run_frames(r, dict(ZERO, **per_frame))
            ms[mode].append(t)
        r.cfg = cfg
        frame_ms[f"p22_{name}"] = ms
        frame_ms[f"p22_{name}_stages"] = stages

        note = ""
        if k6_calls:
            assert len(k6_calls) == 1, f"{name}: {len(k6_calls)} K6 calls"
            g = fr.resolve_gbuffer(r.device_scene, consts, cfg, tris,
                                   depth, tid, attr)
            k6, note = k6_compacted(r, consts, k6_calls[0], tid, g["pos_w"])
        stage_note = "; ".join(
            f"{mode}: " + ", ".join(
                f"{st} busy {b:.3f} span {sp:.3f} host {h:.3f} ms ({n:.0f} "
                f"launches)" for st, (b, sp, n, h) in stages[mode].items())
            for mode in stages)
        phase(f"[22] {name} {cfg.width}x{cfg.height}: shade tiles occupied "
              f"{occ} (bound {req['shade_tiles']}), CB "
              f"{cfg.shade_tile_capacity} / NT {nt}; ssao tiles occupied "
              f"{socc} (bound {req['ssao_tiles']}), CB "
              f"{cfg.ssao_tile_capacity} / NT {snt}; compacted vs dense "
              f"frame: max |diff| {max_diff:.3g}, {above} pixels > 0.02; "
              f"no host sync in {checked} (sync debug mode 'error'); "
              f"device ms per stage, {stage_note}; ms/frame ({FRAMES_WARMUP}"
              f" warm-up + {FRAMES_TIMED}, median, in turns c d d c) "
              f"compacted {[round(t, 3) for t in ms['compacted']]}, dense "
              f"{[round(t, 3) for t in ms['dense']]}; launches per run "
              f"{launches[f'p22_{name}_compacted_0']}{note}")
        del r
    assert k6 is not None, "phase 22: no soft-disk cell reached K6"
    return k6


def k6_compacted(r, consts, call, tid, pos_w):
    """K6 on the compacted receivers the soft-disk frame handed it
    (capture_soft_pcf): against soft_pcf_plain, both times, the bound of
    these receivers and the share the frame discards. Returns (the
    kernels-line entry, a note for the phase line)."""
    from crychic_renderer_tpu_torch.ops import pcf, shadows
    from crychic_renderer_tpu_torch.passes import frame as fr

    qmap, params, radius = call
    cfg = r.cfg
    m = params.shape[1]
    assert m == 2 * cfg.shade_tile_capacity * fr.SHADE_TILE_H \
        * fr.SHADE_TILE_W, m
    f_k = pcf.soft_pcf(qmap, params, radius)
    torch.cuda.synchronize()
    f_p = pcf.soft_pcf_plain(qmap, params, radius)
    err = float((f_k - f_p).abs().max())
    assert bool(f_k.isfinite().all()) and err <= PCF_TOL, \
        f"K6 on the compacted receivers: max |err| {err} vs plain"
    ms = cuda_ms(lambda: pcf.soft_pcf(qmap, params, radius), 20)
    dev_ms = device_ms(lambda: pcf.soft_pcf(qmap, params, radius), 20,
                       "soft_pcf_kernel")
    plain_ms = cuda_ms(lambda: pcf.soft_pcf_plain(qmap, params, radius), 3)
    b, bnote = k6_bound(qmap, params)
    edge = last_block_share(params, pcf.map_size(qmap))
    # the receiver-cascades the frame keeps: both slots of covered pixels
    # with a shadow, less the second slot of cascade-3 pixels (the
    # deferred quirk blends below cascade 3 only)
    assert cfg.deferred
    _, no_shadow, cascades, _ = shadows.cascade_select(
        consts.shadow_transforms, pos_w, consts.eye_pos)
    live = (tid >= 0) & ~no_shadow
    used = int((live.to(torch.int64) * (1 + (cascades[..., 0] < 3)
                                        .to(torch.int64))).sum())
    covered_tiles = int(fr._tiles(tid >= 0, fr.SHADE_TILE_H,
                                  fr.SHADE_TILE_W, False)[0]
                        .any(dim=1).sum())
    empty = 2 * (cfg.shade_tile_capacity - covered_tiles) \
        * fr.SHADE_TILE_H * fr.SHADE_TILE_W
    note = (f"; K6 on the compacted receivers: {m} receiver-cascades "
            f"(2 x CB {cfg.shade_tile_capacity} x 1024; the dense frame "
            f"{2 * cfg.width * cfg.height}) on the {tuple(qmap.shape)} "
            f"window-ready buffer, {edge:.2%} with a window on the last "
            f"block (the former kernel's scalar branch), max |err| {err} "
            f"vs soft_pcf_plain; kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, {bnote}; discarded "
            f"by the frame {1 - used / m:.2%} of them (slots of no "
            f"occupied tile {empty / m:.2%})")
    return dict(
        name="K6 soft-disk PCF: 16 taps, 2.5 texels, 2 cascades, on the "
             "compacted receivers (shadows.py:319)", route="cuda",
        source="crychic_renderer_tpu_torch/csrc/pcf.cu",
        replaces="experiments/pcf_probe.py:46", variant="pcf",
        runs=FRAME_RUNS, max_abs_err=err, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, library_ms=None, receivers=m,
        map_buffer=list(qmap.shape), last_block_share=edge, **b), note


def queued_runs(dev, assets, frame_ms, launches):
    """Phase 23 (see the module doc)."""
    from crychic_renderer_tpu_torch import bench
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.ops import pcf

    def soft(cfg):
        return dataclasses.replace(cfg, pcf_radius_texels=SOFT)

    files = dict(asset_dir=assets["asset_dir"])
    scene4, cfg4, lights4 = sb.CONFIGS[4]()
    scene5, cfg5, lights5 = sb.CONFIGS[5]()
    fence, cfg_f, lights_f = sb.fence_scene(alpha_test=True)
    shadows, k6 = dict(ids=1, depth=1), dict(ids=1, depth=1, pcf=1)
    cells = [  # in P23_CELLS' order
        ("config1", *sb.CONFIGS[1](), {}, dict(ids=1)),
        ("config2", *sb.CONFIGS[2](), files, dict(ids=1)),
        ("config3", *sb.CONFIGS[3](), files, dict(ids=1)),
        ("config4", scene4, cfg4, lights4, {}, shadows),
        ("config4_soft", scene4, soft(cfg4), lights4, {}, k6),
        ("config4_soft_fast", scene4, soft(cfg4).fast_preset(), lights4, {},
         k6),
        ("config5", scene5, cfg5, lights5, assets, shadows),
        ("config5_fast", scene5, cfg5.fast_preset(), lights5, assets,
         shadows),
        ("fence", fence,
         dataclasses.replace(cfg_f, width=1920, height=1080), lights_f,
         files, shadows),
    ]
    assert tuple(c[0] for c in cells) == P23_CELLS
    for name, scene, cfg, lights, kw, per_frame in cells:
        r = Renderer(scene, cfg, lights=lights, device=dev, **kw)
        r.render(0.0)  # warm-up: makes the per-device constants
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(P23_FRAMES):
                img = r.render((i + 1) / 60.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        issue_ms = 1000.0 * (time.perf_counter() - t0) / P23_FRAMES
        torch.cuda.synchronize()
        done_ms = 1000.0 * (time.perf_counter() - t0) / P23_FRAMES
        counts = launch_counts()
        want = dict(ZERO, **{k: v * P23_FRAMES for k, v in per_frame.items()})
        assert counts == want, f"{name}: launches {counts}, want {want}"
        launches[f"p23_{name}"] = counts
        r.check_overflow()
        assert bool(img.isfinite().all()), f"{name}: non-finite pixels"
        frame_ms[f"p23_{name}"] = dict(issue=issue_ms, done=done_ms)
        note = ""
        if name == "config4_soft":
            fills = pcf.cache_fills()
            reset_counts()
            t0 = time.perf_counter()
            for i in range(K6_QUEUE):
                img = r.render(i / 60.0)
            float(img[0, 0, 0])
            queue_ms = 1000.0 * (time.perf_counter() - t0) / K6_QUEUE
            fills = pcf.cache_fills() - fills
            counts = launch_counts()
            want = dict(ZERO, ids=K6_QUEUE, depth=K6_QUEUE, pcf=K6_QUEUE)
            assert counts == want, f"queued soft frames: launches {counts}"
            assert fills == 0, f"K6's texture cache filled {fills} times"
            r.check_overflow()
            launches["p23_soft_queue"] = counts
            frame_ms["p23_soft_queue"] = queue_ms
            note = (f"; then {K6_QUEUE} frames queued and read back once: "
                    f"{queue_ms:.3f} ms/frame, K6's texture cache filled "
                    f"{fills} times (total since load "
                    f"{pcf.cache_fills()}), launches {counts}")
        phase(f"[23] {name} {r.cfg.width}x{r.cfg.height}: {P23_FRAMES} "
              f"frames queued under sync debug mode 'error', no sync; "
              f"host {issue_ms:.3f} ms/frame to queue, {done_ms:.3f} "
              f"ms/frame until done; launches {launches[f'p23_{name}']}"
              f"{note}")
        del r

    # the bench entry points, each a process of its own at the checkout
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for module, limit in (("crychic_renderer_tpu_torch.bench", 400),
                          ("crychic_renderer_tpu_torch.experiments.bench_all",
                           600)):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", module], cwd=root,
                           capture_output=True, text=True, timeout=limit)
        if p.returncode != 0:
            raise RuntimeError(f"{module} exited {p.returncode}:\n"
                               f"{p.stderr[-4000:]}")
        out[module.split(".")[-1]] = (p.stdout.strip().splitlines(),
                                      time.perf_counter() - t0)
    lines, bench_s = out["bench"]
    got = json.loads(lines[-1])
    frames = 1 + bench.ROUNDS * bench.N_FRAMES
    assert {"metric", "value", "unit", "vs_baseline", "rounds_ms", "card",
            "assets"} <= set(got), got
    assert len(got["rounds_ms"]) == bench.ROUNDS and got["value"] > 0, got
    # + 1: the eager frame before the capture
    assert got["frames"] == frames and got["kernel_launches"] == dict(
        ids=frames + 1, depth=frames + 1, pcf=0), got
    launches["bench"] = dict(ZERO, **got["kernel_launches"])
    frame_ms["bench"] = got
    phase(f"[23] python -m crychic_renderer_tpu_torch.bench exited 0 in "
          f"{bench_s:.1f} s; its line:")
    print(lines[-1], flush=True)
    lines, all_s = out["bench_all"]
    rows = [json.loads(x) for x in lines[1:]]
    assert lines[0].startswith("card: ") and len(rows) == 7, lines
    for row in rows:
        n = row["frames"] + 2  # the warm-up frame and the eager frame
        assert row["kernel_launches"] == dict(
            ids=n, depth=n if row["config"] in (4, 5) else 0, pcf=0), row
    frame_ms["bench_all"] = rows
    phase(f"[23] python -m crychic_renderer_tpu_torch.experiments.bench_all "
          f"exited 0 in {all_s:.1f} s; its lines:")
    for x in lines:
        print(x, flush=True)



# device sleep that queues 20 replays behind it (~1 s on an H100)
P24_SLEEP_CYCLES = 2_000_000_000


def eager_render(r, t):
    """The frame that r.render replays, run eagerly as render() ran it
    before it had a graph: the same constants through render_frame."""
    from crychic_renderer_tpu_torch.passes import frame as fr

    r._animate_materials(t)
    return fr.render_frame(r.device_scene, r.frame_constants(t), r.cfg)


def queue_frames(render, n):
    """n frames queued back to back, one value of the last read back:
    (host ms per frame to issue them, ms per frame until the read)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = None
    for i in range(n):
        img = render(i / 60.0)
    t1 = time.perf_counter()
    float(img[0, 0, 0])
    t2 = time.perf_counter()
    return 1000.0 * (t1 - t0) / n, 1000.0 * (t2 - t0) / n


def profiled(render, frames=3):
    """torch.profiler (CUDA activity) over `frames` frames: (device
    records per frame, their summed ms per frame)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            render(i / 60.0)
        torch.cuda.synchronize()
    recs = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(recs) / frames,
            sum(e.time_range.elapsed_us() for e in recs) / 1000.0 / frames)


def replay_device_ms(r, n=P24_QUEUE):
    """Device ms per replay: CUDA events around n frames queued behind a
    device sleep that outlasts the host's issue, so the span holds no host
    time. Returns (ms per replay, the sleep's ms, host ms to issue)."""
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(P24_SLEEP_CYCLES)
    e1.record()
    t0 = time.perf_counter()
    for i in range(n):
        r.render(i / 60.0)
    host_ms = 1000.0 * (time.perf_counter() - t0)
    e2.record()
    torch.cuda.synchronize()
    sleep_ms = e0.elapsed_time(e1)
    assert host_ms < sleep_ms, (
        f"issuing {n} replays took {host_ms:.1f} ms, longer than the "
        f"{sleep_ms:.1f} ms sleep: the span would hold host time")
    return e1.elapsed_time(e2) / n, sleep_ms, host_ms


def compiled_runs(dev, assets, frame_ms, launches):
    """Phase 24 (see the module doc)."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.ops import pcf
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene4, cfg4, lights4 = sb.CONFIGS[4]()
    fence, cfg_f, lights_f = sb.fence_scene(alpha_test=True)
    shadows = dict(ids=1, depth=1)
    cells = [  # in P24_CELLS' order
        ("config4", scene4, cfg4, lights4, {}, shadows),
        ("config4_soft", scene4,
         dataclasses.replace(cfg4, pcf_radius_texels=SOFT), lights4, {},
         dict(shadows, pcf=1)),
        ("config5", *sb.CONFIGS[5](), assets, shadows),
        ("fence", fence,
         dataclasses.replace(cfg_f, width=1920, height=1080), lights_f,
         dict(asset_dir=assets["asset_dir"]), shadows),
        ("config1", *sb.CONFIGS[1](), {}, dict(ids=1)),
    ]
    assert tuple(c[0] for c in cells) == P24_CELLS
    for name, scene, cfg, lights, kw, per_frame in cells:
        r = Renderer(scene, cfg, lights=lights, device=dev, **kw)
        fills = pcf.cache_fills()
        torch.cuda.synchronize()
        c0 = captures()
        t0 = time.perf_counter()
        img0 = r.render(0.0)  # eager frame, capture, replay
        torch.cuda.synchronize()
        first_ms = 1000.0 * (time.perf_counter() - t0)
        cf = r.compiled_frame
        assert captures() == c0 + 1 and cf is not None, name

        # the replayed frame against the eager frame on the same constants
        t = 0.1
        img = r.render(t)
        consts = r.frame_constants(t)
        eager = [fr.render_frame(r.device_scene, consts, r.cfg)
                 for _ in range(2)]
        diff = (img - eager[0]).abs().amax(dim=-1)
        max_d = float(diff.max())
        above = int((diff > 0.02).sum())
        ee = float((eager[0] - eager[1]).abs().max())
        same = torch.equal(img, eager[0])
        assert bool(img.isfinite().all()), f"{name}: non-finite pixels"
        assert same or (ee > 0 and max_d <= PCF_TOL and above == 0), (
            f"{name}: replay vs eager max |diff| {max_d}, {above} pixels "
            f"> 0.02; eager vs eager {ee}")
        note = ""
        if name == "config5":
            bolt = 6  # the "bolt" material, the BoltAnim slot's
            base = int(r._base_mat_pair[bolt])
            slot = int(r.device_scene.mat_pair[bolt])
            moved = int(((img - img0).abs().amax(dim=-1) > 0.02).sum())
            assert slot != base and moved > 0, (slot, base, moved)
            note += (f"; BoltAnim pair {base} at t=0 -> {slot} at t={t}, "
                     f"{moved} pixels moved > 0.02 in the replayed frame")

        # 20 queued frames in turns: graph, eager, eager, graph
        turns = {"graph": [], "eager": []}
        for i, turn in enumerate(P24_TURNS):
            render = (r.render if turn == "graph"
                      else lambda tt: eager_render(r, tt))
            reset_counts()
            c1 = captures()
            issue_ms, done_ms = queue_frames(render, P24_QUEUE)
            counts = launch_counts()
            assert captures() == c1, f"{name}: a {turn} turn captured"
            want = dict(ZERO, **{k: v * P24_QUEUE
                                 for k, v in per_frame.items()})
            assert counts == want, (f"{name} {turn}: launches {counts}, "
                                    f"want {want}")
            launches[f"p24_{name}_{turn}_{i}"] = counts
            turns[turn].append((issue_ms, done_ms))
        r.check_overflow()
        fills = pcf.cache_fills() - fills
        assert fills == 0, f"{name}: K6's texture cache filled {fills} times"
        per_replay = {k: v / P24_QUEUE for k, v in
                      launches[f"p24_{name}_graph_0"].items() if v}

        if name == "config4":
            rec_g, dev_g = profiled(r.render)
            rec_e, dev_e = profiled(lambda tt: eager_render(r, tt))
            ev_ms, sleep_ms, host_ms = replay_device_ms(r)
            frame_ms["p24_profiler"] = dict(
                graph_records=rec_g, graph_device_ms=dev_g,
                eager_records=rec_e, eager_device_ms=dev_e,
                replay_event_ms=ev_ms)
            note += (f"; torch.profiler per frame: replay {rec_g:.0f} "
                     f"device records, {dev_g:.3f} ms; eager {rec_e:.0f} "
                     f"records, {dev_e:.3f} ms; CUDA events around "
                     f"{P24_QUEUE} replays queued behind a {sleep_ms:.0f} "
                     f"ms device sleep (issued in {host_ms:.1f} ms): "
                     f"{ev_ms:.3f} ms per replay")
        if name == "config5":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_reserved(dev)
            r.close()
            torch.cuda.empty_cache()
            freed = held - torch.cuda.memory_reserved(dev)
            assert freed >= cf.pool_bytes, (freed, cf.pool_bytes)
            note += (f"; close() gave back {freed} bytes of reserved device "
                     f"memory (the pool {cf.pool_bytes})")
        frame_ms[f"p24_{name}"] = dict(
            first_render_ms=first_ms, capture_ms=cf.capture_ms,
            pool_bytes=cf.pool_bytes, replay_vs_eager_max=max_d,
            eager_vs_eager_max=ee, equal=same,
            turns={k: [dict(issue_ms=a, ms_per_frame=b) for a, b in v]
                   for k, v in turns.items()},
            launches_per_replay=per_replay)
        phase(f"[24] {name} {r.cfg.width}x{r.cfg.height}: first render "
              f"(eager frame, capture, replay) {first_ms:.1f} ms, capture "
              f"{cf.capture_ms:.1f} ms, graph pool {cf.pool_bytes} bytes; "
              f"replay vs eager at t={t}: "
              f"{'torch.equal' if same else 'not equal'}, max |diff| "
              f"{max_d:.3g}, {above} pixels > 0.02 (eager vs eager "
              f"{ee:.3g}); {P24_QUEUE} queued frames, turns g e e g, host "
              f"ms to issue a frame "
              f"{[round(turns[k][j][0], 3) for k, j in P24_ORDER]}, "
              f"ms/frame {[round(turns[k][j][1], 3) for k, j in P24_ORDER]}"
              f"; launches per replay (replay tally) {per_replay}, "
              f"captured {cf.launches}; K6 texture-cache fills {fills}"
              f"{note}")
        del r, cf

    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run(
        [sys.executable, "-m",
         "crychic_renderer_tpu_torch.experiments.texture_capture_probe"],
        cwd=root, capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise RuntimeError(f"texture_capture_probe exited {p.returncode}:\n"
                           f"{p.stderr[-4000:]}")
    line = p.stdout.strip().splitlines()[-1]
    frame_ms["p24_texture_capture"] = json.loads(line)
    phase(f"[24] cudaCreateTextureObject inside a capture in the global "
          f"mode (experiments/texture_capture_probe.py): {line}")


# (turn, index within that turn's list) in P24_TURNS' order
P24_ORDER = [(t, P24_TURNS[:i].count(t)) for i, t in enumerate(P24_TURNS)]


def _rank_note(out):
    """One rank's compiled run: graphs, pool bytes, capture ms, launches
    per replay, median host ms to issue a frame."""
    g = out["graph"]
    return (f"{g['graphs']} graphs, pool {g['pool_bytes']} B, capture "
            f"{g['capture_ms']:.1f} ms, per replay {g['launches']}, issue "
            f"{statistics.median(out['issue_ms']):.3f} ms")


def band_graph_runs(r, consts, band_cfg, dev, frame_ms, launches, p22,
                    card):
    """Phase 25 (see the module doc): the compiled band frame against the
    eager one on 4 gloo ranks sharing the card and on 1 NCCL rank, the
    u16-packed atlas gather against the f32 one, render_frames_replicated
    on 2 x 2 ranks, and profile_frame's stage graphs beside phase 22.
    `card`: nvidia-smi's name and power limit, printed first."""
    import copy

    from crychic_renderer_tpu_torch.parallel import launch, sharded
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene = r.device_scene
    cells = {"zero": band_cfg,
             "soft": dataclasses.replace(band_cfg, pcf_radius_texels=SOFT)}
    cfg2 = sharded.autosize_band_capacities(scene, consts, r.cfg, 2)
    cam = copy.deepcopy(r.camera)
    r.camera.walk(2.0)
    r.camera.rotate_y(0.1)
    moved = r.frame_constants(0.5)
    r.camera = cam
    runs, index = [], {}
    for cell, cfg in cells.items():
        for i, turn in enumerate(P25_TURNS):
            opts = dict(compiled=turn == "compiled")
            if i == 0:
                opts["profile"] = P25_PROFILE
            index[(cell, i)] = len(runs)
            runs.append((cfg, 0, (0,), opts))
    index["f32"] = len(runs)
    runs.append((band_cfg, 0, (0,), dict(packed_atlas=False)))
    for turn in ("compiled", "eager"):
        index[("replicated", turn)] = len(runs)
        runs.append((cfg2, 0, (0, 1), dict(compiled=turn == "compiled")))
    t0 = time.perf_counter()
    ranks = launch.render_sharded(
        [scene], [consts, moved], runs, 4, "gloo", dev, warmup=P25_WARMUP,
        timed=P25_TIMED, timeout=900)
    job_s = time.perf_counter() - t0
    total = dict(ZERO)
    for rank, outs in enumerate(ranks):
        for k, out in enumerate(outs):
            cfg, opts = runs[k][0], runs[k][3]
            compiled = opts.get("compiled", True)
            n = out["frames"] + (1 if compiled else 0)
            want = dict(ZERO, band_ids=n, band_depth=n,
                        pcf=n if cfg.pcf_radius_texels else 0)
            assert out["launches"] == want, (rank, k, out["launches"], want)
            assert not out["overflowed"], (rank, k)
            assert out["cache_fills"] == 0, (rank, k, out["cache_fills"])
            for key in total:
                total[key] += out["launches"][key]
            if compiled:
                assert out["graph"]["launches"] == (
                    {"band_ids": 1, "band_depth": 1}, want["pcf"] // n), \
                    (rank, k, out["graph"]["launches"])
    launches["p25_gloo"] = total

    lines, cell_ms = [f"[25] card: {card}"], {}
    for cell, cfg in cells.items():
        outs = [[ranks[q][index[(cell, i)]] for i in range(4)]
                for q in range(4)]
        for q, o in enumerate(outs):
            for i in (0, 3):
                for j in (1, 2):
                    assert np.array_equal(o[i]["img"], o[j]["img"]), (
                        f"{cell}, rank {q}: the replay (turn {i}) is not "
                        f"equal to the eager band frame (turn {j})")
            gathers = o[1]["gathers"]
            assert o[0]["graph"]["graphs"] == gathers + 1, (
                cell, q, o[0]["graph"]["graphs"], gathers)
        ref = fr.render_frame(scene, consts, dataclasses.replace(
            r.cfg, pcf_radius_texels=cfg.pcf_radius_texels)).cpu().numpy()
        img = outs[0][0]["img"]
        diff = np.abs(img - ref).max(axis=-1)
        frac = float((diff > 0.02).mean())
        assert frac <= SHARD_FRAC, f"{cell}: {frac:.4%} of pixels > 0.02"
        med = [statistics.median(outs[0][i]["ms"]) for i in range(4)]
        issue = [statistics.median(outs[0][i]["issue_ms"])
                 for i in range(4)]
        prof = outs[0][0]["profile"]
        cell_ms[cell] = dict(
            ms_per_frame=med, issue_ms=issue, gathers=outs[0][1]["gathers"],
            gathered_bytes=outs[0][0]["gathered_bytes"],
            ranks=[o[0]["graph"] for o in outs], profile=prof,
            vs_render_frame=dict(max=float(diff.max()), frac=frac))
        kern = "; ".join(f"{name} {c:.0f} x {ms:.4f} ms" for name, (
            c, ms) in prof["kernels"].items())
        top = "; ".join(f"{name} {c:.0f} x {ms:.3f} ms" for name, (
            c, ms) in prof["top"].items())
        lines.append(
            f"[25] {cell}: turns c e e c, rank 0 median ms/frame "
            f"{[round(t, 3) for t in med]}, host ms to issue "
            f"{[round(t, 3) for t in issue]}; every rank's replay "
            f"torch.equal to its eager band frame; vs render_frame max "
            f"|diff| {diff.max():.3g}, {frac:.4%} > 0.02; "
            f"{outs[0][1]['gathers']:.0f} gathers per frame, "
            f"{outs[0][0]['gathered_bytes']:.0f} bytes received per rank "
            f"and frame; per rank: "
            + " | ".join(_rank_note(o[0]) for o in outs)
            + f"; rank 0's replay in torch.profiler ({prof['frames']} "
            f"frames): {prof['records']:.0f} device records, "
            f"{prof['device_ms']:.3f} ms per frame, of it {kern}; the "
            f"names that took the most: {top}")

    # the packed atlas gather against the f32 one, same frame
    f32 = [ranks[q][index["f32"]] for q in range(4)]
    packed = [ranks[q][index[("zero", 0)]] for q in range(4)]
    for q in range(4):
        assert np.array_equal(f32[q]["img"], packed[q]["img"]), (
            f"rank {q}: packed atlas frame != f32 atlas frame")
    saved = f32[0]["gathered_bytes"] - packed[0]["gathered_bytes"]
    assert saved > 0, saved
    lines.append(
        f"[25] u16-packed atlas gather vs f32: torch.equal frames on every "
        f"rank; bytes received per rank and frame "
        f"{packed[0]['gathered_bytes']:.0f} packed, "
        f"{f32[0]['gathered_bytes']:.0f} f32 ({saved:.0f} fewer); rank 0 "
        f"median ms/frame {statistics.median(packed[0]['ms']):.3f} packed "
        f"(turn 0), {statistics.median(f32[0]['ms']):.3f} f32; f32 ranks: "
        + " | ".join(_rank_note(o) for o in f32))

    # render_frames_replicated on 2 x 2 ranks, compiled against eager
    rep = [(ranks[q][index[("replicated", "compiled")]],
            ranks[q][index[("replicated", "eager")]]) for q in range(4)]
    for q, (g, e) in enumerate(rep):
        assert np.array_equal(g["img"], e["img"]), (
            f"replicated, rank {q}: compiled != eager")
    assert not np.array_equal(rep[0][0]["img"], rep[2][0]["img"])
    lines.append(
        f"[25] render_frames_replicated, 2 replica groups x 2 gloo ranks "
        f"(the second group's camera moved): every rank's replay "
        f"torch.equal to its eager frame; rank 0 median ms/frame compiled "
        f"{statistics.median(rep[0][0]['ms']):.3f}, eager "
        f"{statistics.median(rep[0][1]['ms']):.3f}; per rank: "
        + " | ".join(_rank_note(g) for g, _ in rep))

    # 1 NCCL rank: the whole band frame, its collectives inside, one graph
    cfg1 = sharded.autosize_band_capacities(scene, consts, r.cfg, 1)
    t1 = time.perf_counter()
    (g1, e1), = launch.render_sharded(
        [scene], [consts], [(cfg1, 0, (0,)),
                            (cfg1, 0, (0,), dict(compiled=False))],
        1, "nccl", "cuda:0", warmup=P25_WARMUP, timed=P25_TIMED,
        timeout=600)
    nccl_s = time.perf_counter() - t1
    assert g1["graph"]["graphs"] == 1, g1["graph"]
    assert np.array_equal(g1["img"], e1["img"]), "NCCL: replay != eager"
    assert g1["gathers"] == e1["gathers"] > 0, (g1["gathers"], e1["gathers"])
    nccl = {}
    for name, out, extra in (("compiled", g1, 1), ("eager", e1, 0)):
        n = out["frames"] + extra
        want = dict(ZERO, band_ids=n, band_depth=n)
        assert out["launches"] == want, (name, out["launches"], want)
        assert not out["overflowed"] and out["cache_fills"] == 0, name
        nccl[name] = dict(ms=statistics.median(out["ms"]),
                          issue_ms=statistics.median(out["issue_ms"]))
    launches["p25_nccl"] = {k: g1["launches"][k] + e1["launches"][k]
                            for k in ZERO}
    lines.append(
        f"[25] 1 NCCL rank: the whole band frame in one graph "
        f"({g1['gathers']:.0f} all_gather_into_tensor inside, "
        f"{g1['gathered_bytes']:.0f} bytes per frame), replay torch.equal "
        f"to eager; median ms/frame compiled {nccl['compiled']['ms']:.3f} "
        f"(issue {nccl['compiled']['issue_ms']:.3f}), eager "
        f"{nccl['eager']['ms']:.3f} (issue {nccl['eager']['issue_ms']:.3f})"
        f"; {_rank_note(g1)}; job {nccl_s:.1f} s")

    # profile_frame's stage graphs (phase 14) beside phase 22's device ms
    stages = frame_ms["profile_stages"]
    side = {k: (round(stages[k], 3), round(p22[k][0], 3), round(p22[k][1], 3))
            for k in p22}
    lines.append(
        f"[25] profile_frame, config 4 {r.cfg.width}x{r.cfg.height} "
        f"(phase 14: each stage a CUDA graph, {PROFILE_REPS} replays after "
        f"1, host clock ending in a synchronize), ms: "
        f"{ {k: round(v, 3) for k, v in stages.items()} }; beside phase "
        f"22's compacted device ms (stage: replay, busy, span): {side}")
    for line in lines:
        phase(line)
    frame_ms["p25"] = dict(cells=cell_ms, job_s=job_s, nccl=nccl,
                           packed_bytes=packed[0]["gathered_bytes"],
                           f32_bytes=f32[0]["gathered_bytes"],
                           f32_ms=statistics.median(f32[0]["ms"]),
                           replicated_ms=[
                               statistics.median(rep[0][0]["ms"]),
                               statistics.median(rep[0][1]["ms"])])


def xla_frame_checks(rx, rk):
    """Phase 26 (a)/(b) on the frame at t = 0 of rx (use_pallas=False)
    against rk's (the kernel path, same options): the frame, the main
    view's tids and depths against K1 on the same triangles, the
    per-cascade maps against the atlas, and with the soft disk K6 on rx's
    receivers against soft_pcf_plain. Returns (dict of numbers, note)."""
    from crychic_renderer_tpu_torch.ops import pcf, raster, shadows
    from crychic_renderer_tpu_torch.ops import rasterizer as rz
    from crychic_renderer_tpu_torch.passes import frame as fr

    cfg = rx.cfg
    W, H, S = cfg.width, cfg.height, cfg.shadow_map_size
    img_x = rx.render(0.0)
    img_k = rk.render(0.0)
    diff = (img_x - img_k).abs().amax(dim=-1)
    frac = float((diff > 0.02).float().mean())
    assert bool(img_x.isfinite().all()), "pure-XLA frame: non-finite pixels"
    assert frac <= PIX_BOUND, f"pure-XLA vs kernel frame: {frac:.4%} > 0.02"
    consts = rx.frame_constants(0.0)
    tris, tri_attr = fr.main_view_tris(rx.device_scene, consts, cfg)
    d_x, t_x, _, _ = rz.binned_raster(tris, W, H, cfg.pair_capacity,
                                      cfg.bin_cap)
    d_k, t_k, _ = raster.rasterize(tris, W, H, rk.cfg.pair_capacity)
    same = t_x == t_k
    dz = float((d_x - d_k).abs()[same].max())
    maps = fr.render_shadow_maps(rx.device_scene, consts, cfg)
    atlas = fr.render_shadow_atlas(rk.device_scene, consts.shadow_visibility,
                                   consts.cascade_view_projs, rk.cfg)
    both = (maps < 1.0) & (atlas < 1.0)
    dmap = (maps - atlas).abs()
    out = dict(vs_kernel_frac=frac, vs_kernel_max=float(diff.max()),
               tid_differ=int((~same).sum()), dz_where_same=dz,
               maps_max=float(dmap.max()),
               maps_coverage_differ=int(((maps < 1.0) != (atlas < 1.0))
                                        .sum()),
               maps_far=int((dmap[both] > 1e-3).sum()))
    note = (f"vs the kernel frame {frac:.4%} of pixels > 0.02 (max "
            f"{out['vs_kernel_max']:.3g}); main view vs K1 on the same "
            f"triangles: {out['tid_differ']} of {W * H} tids differ, max "
            f"|depth diff| {dz:.3g} where they agree; per-cascade maps vs "
            f"the atlas: max |diff| {out['maps_max']:.3g}, "
            f"{out['maps_coverage_differ']} texels' coverage differs, "
            f"{out['maps_far']} covered texels > 1e-3 apart")
    if cfg.pcf_radius_texels:
        g = fr.resolve_gbuffer(rx.device_scene, consts, cfg, tris, d_x, t_x,
                               tri_attr)
        _, _, cascades, shadow_pos = shadows.cascade_select(
            consts.shadow_transforms, g["pos_w"], consts.eye_pos)
        params = pcf.receiver_params(shadow_pos.reshape(-1, 4),
                                     cascades.reshape(-1), S)
        qmap = pcf.quantize_map(maps)
        f_k = pcf.soft_pcf(qmap, params, SOFT)
        torch.cuda.synchronize()
        err = float((f_k - pcf.soft_pcf_plain(qmap, params, SOFT))
                    .abs().max())
        assert err <= PCF_TOL, f"K6 on the pure-XLA maps: max |err| {err}"
        out["k6_max_abs_err"] = err
        note += (f"; K6 on this frame's {params.shape[1]} receiver-cascades "
                 f"over the per-cascade maps vs soft_pcf_plain: max |err| "
                 f"{err}")
    return out, note


def xla_runs(r, band_cfg, dev, frame_ms, launches, card):
    """Phase 26 (see the module doc). r: phase 3's Renderer (config 4,
    the kernel path); band_cfg: phase 9's band capacities for 4 ranks."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.parallel import launch, sharded
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg4, lights = sb.CONFIGS[4]()
    lines = [f"[26] card: {card}"]
    result = {}
    rk_soft = Renderer(scene, dataclasses.replace(
        cfg4, pcf_radius_texels=SOFT), lights=lights, device=dev)
    xla_cfg = None
    for name, over, per_frame, rk in (
            ("xla", {}, {}, r),
            ("xla_soft", dict(pcf_radius_texels=SOFT), dict(pcf=1),
             rk_soft)):
        rx = Renderer(scene, dataclasses.replace(cfg4, use_pallas=False,
                                                 **over),
                      lights=lights, device=dev)
        req = rx.capacity_requirements(0.0)
        ms, counts = run_frames(rx, dict(ZERO, **per_frame))
        launches[f"p26_{name}"] = counts
        cf = rx.compiled_frame
        out, note = xla_frame_checks(rx, rk)
        out.update(ms_per_frame=ms, capture_ms=cf.capture_ms,
                   pool_bytes=cf.pool_bytes, bin_cap=rx.cfg.bin_cap,
                   shadow_bin_cap=rx.cfg.shadow_bin_cap)
        result[name] = out
        lines.append(
            f"[26] {name}: config 4 {rx.cfg.width}x{rx.cfg.height}, "
            f"use_pallas=False (pair_capacity {rx.cfg.pair_capacity}, "
            f"shadow_pair_capacity {rx.cfg.shadow_pair_capacity}, bin_cap "
            f"{rx.cfg.bin_cap} for a largest run of {req['main_max_tile']}, "
            f"shadow_bin_cap {rx.cfg.shadow_bin_cap} for "
            f"{req['shadow_max_tile']}), compiled: {FRAMES_WARMUP} warm-up "
            f"+ {FRAMES_TIMED} frames, median {ms:.3f} ms/frame, capture "
            f"{cf.capture_ms:.1f} ms, pool {cf.pool_bytes} bytes; launches "
            f"{counts} (no K1/K2); {note}")
        if name == "xla":
            xla_cfg = rx.cfg
        del rx, cf

    # (c) config 4's scene without its static tables through render(),
    # against a Renderer of the scene with them
    rs = Renderer(scene, cfg4, lights=lights, device=dev)
    rn = Renderer(scene, cfg4, lights=lights, device=dev)
    rn.device_scene = fr.strip_draw_statics(rn.device_scene)
    ms, counts = run_frames(rn, dict(ZERO, ids=1, depth=1))
    launches["p26_no_statics"] = counts
    img_n, img_s = rn.render(0.0), rs.render(0.0)
    diff = (img_n - img_s).abs().amax(dim=-1)
    same = torch.equal(img_n, img_s)
    above = int((diff > 0.02).sum())
    assert same or (float(diff.max()) <= PCF_TOL and above == 0), (
        f"no statics vs statics: max |diff| {float(diff.max())}, {above} "
        f"pixels > 0.02")
    result["no_statics"] = dict(ms_per_frame=ms, equal=same,
                                max=float(diff.max()))
    lines.append(
        f"[26] no_statics: config 4 {r.cfg.width}x{r.cfg.height} with every "
        f"draw's static tables dropped, through Renderer.render (the "
        f"per-vertex stage inside the graph): {FRAMES_WARMUP} warm-up + "
        f"{FRAMES_TIMED} frames, median {ms:.3f} ms/frame; launches "
        f"{counts}; vs the frame with the tables: "
        f"{'torch.equal' if same else 'not equal'}, max |diff| "
        f"{float(diff.max()):.3g}, {above} pixels > 0.02")
    kernel_cfg = rs.cfg
    del rn, rs

    # (d) the compiled band frame of both families on 4 gloo ranks
    consts = r.frame_constants(0.0)
    n = 4
    bcx = sharded.autosize_band_capacities(r.device_scene, consts, xla_cfg,
                                           n)
    cells = {"xla": (bcx, 0), "no_statics": (band_cfg, 1)}
    runs = []
    for cfg, si in cells.values():
        runs += [(cfg, si, (0,)), (cfg, si, (0,), dict(compiled=False))]
    t0 = time.perf_counter()
    ranks = launch.render_sharded(
        [r.device_scene, fr.strip_draw_statics(r.device_scene)], [consts],
        runs, n, "gloo", dev, warmup=P25_WARMUP, timed=P25_TIMED,
        timeout=900)
    job_s = time.perf_counter() - t0
    total = dict(ZERO)
    for k, (name, (cfg, si)) in enumerate(cells.items()):
        for q in range(n):
            g, e = ranks[q][2 * k], ranks[q][2 * k + 1]
            assert np.array_equal(g["img"], e["img"]), (
                f"{name}, rank {q}: replay != eager band frame")
            assert g["graph"]["graphs"] == g["gathers"] + 1 \
                == P26_GRAPHS[name], (name, q, g["graph"]["graphs"])
            for out, extra in ((g, 1), (e, 0)):
                frames = out["frames"] + extra
                band = 0 if name == "xla" else frames
                want = dict(ZERO, band_ids=band, band_depth=band)
                assert out["launches"] == want, (name, q, out["launches"])
                assert not out["overflowed"], (name, q)
                for key in total:
                    total[key] += out["launches"][key]
        ref = fr.render_frame(r.device_scene if si == 0 else
                              fr.strip_draw_statics(r.device_scene), consts,
                              xla_cfg if name == "xla" else kernel_cfg)
        img = ranks[0][2 * k]["img"]
        diff = np.abs(img - ref.cpu().numpy()).max(axis=-1)
        frac = float((diff > 0.02).mean())
        assert frac <= SHARD_FRAC, f"{name} band frame: {frac:.4%} > 0.02"
        ms = [statistics.median(ranks[0][2 * k + j]["ms"]) for j in (0, 1)]
        result[f"band_{name}"] = dict(
            ms_per_frame_compiled=ms[0], ms_per_frame_eager=ms[1],
            graphs=P26_GRAPHS[name], vs_render_frame_max=float(diff.max()),
            ranks=[ranks[q][2 * k]["graph"] for q in range(n)])
        lines.append(
            f"[26] band frame, {name}: config 4 {r.cfg.width}x"
            f"{r.cfg.height} on {n} gloo ranks sharing the card, "
            f"{P25_WARMUP} warm-up + {P25_TIMED} frames compiled then "
            f"eager: every rank's replay torch.equal to its eager frame; vs "
            f"render_frame max |diff| {diff.max():.3g}, {frac:.4%} > 0.02; "
            f"rank 0 median ms/frame compiled {ms[0]:.3f}, eager "
            f"{ms[1]:.3f}; per rank: "
            + " | ".join(_rank_note(ranks[q][2 * k]) for q in range(n)))
    launches["p26_band"] = total
    lines.append(f"[26] band job {job_s:.1f} s with spawn; launches summed "
                 f"over the ranks {total}")
    for line in lines:
        phase(line)
    frame_ms["p26"] = dict(result, card=card, band_job_s=job_s)


if __name__ == "__main__":
    sys.exit(main())
