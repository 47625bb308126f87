"""Timing probes of the port's kernels: the torch counterparts of the JAX
package's probes in ``experiments/`` that launch a Pallas kernel.

- ``fma_kernel_probe``: K4, the raster kernel on field-major records
  against the port's own pair-major layout.
- ``bin_decomp_probe``: K5, the raster kernel launched alone, inside a
  piece-by-piece timing of binning and the record build.
- ``kernel_ab_probe`` and ``sharded_ab_probe``: another checkout's
  kernels, or its band-sharded frame, against this one's, in turns.
- ``alpha_probe``: host and device time, launches and synchronizing
  copies of the alpha-tested layer's two stages.

The first two and ``alpha_probe`` run on ``cuda`` unless the caller
passes ``device="cpu"``; there the kernels take their plain versions and a time is a host-clock time of the
CPU, never a device time.
"""
from __future__ import annotations

import dataclasses
import time

import torch


def time_ms(fn, reps: int, device) -> float:
    """Mean ms per call of fn() after one warm-up: CUDA events around
    `reps` calls on a CUDA device, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1000.0 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def config4_views(device, small: bool = False):
    """The two raster launches of BASELINE config 4's frame at time 0, as
    the probes' main() time them: [(name, tris, width, height, capacity,
    xrange, with_ids)] for the main view (depth + id) and the shadow atlas
    (depth only, column guard). small: 1/8 size, for CPU runs."""
    from ..app.renderer import Renderer
    from ..models.scenes_baseline import CONFIGS
    from ..passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    if small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 8, height=cfg.height // 8,
            shadow_map_size=max(cfg.shadow_map_size // 8, 128))
    r = Renderer(scene, cfg, lights=lights, device=device)
    cfg = r.cfg
    consts = r.frame_constants(0.0)
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    atris, xr = fr.shadow_atlas_tris(r.device_scene, consts.shadow_visibility,
                                     consts.cascade_view_projs, cfg)
    S, C = cfg.shadow_map_size, cfg.num_cascades
    return [("main view", tris, cfg.width, cfg.height, cfg.pair_capacity,
             None, True),
            ("shadow atlas", atris, C * S, S, cfg.shadow_pair_capacity, xr,
             False)]
