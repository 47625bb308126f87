"""A/B times of the raster kernel (K1, K2, K3) and the soft PCF kernel
(K6) of two checkouts, on one card, on BASELINE config 4's 1080p inputs.

    python -m crychic_renderer_tpu_torch.experiments.kernel_ab_probe \
        --other build/parent [--reps 20]

``--other`` is another checkout of the repository (for example a ``git
archive`` of the parent commit unpacked under ``build/``). Its
``csrc/raster.cu`` and ``csrc/pcf.cu`` are built beside this checkout's
and launched through this checkout's wrappers (``ops/raster.raster_tiles``,
``ops/pcf.soft_pcf``) on the main view (K1), the atlas (K2), each owner's
band launch at n=4 (K3) and both cascades of every pixel's receiver with
the 2.5-texel disk (K6) on 2048^2 maps and on 520^2 maps. A ``pcf.cu``
older than the window-ready map (no ``crychic_soft_pcf_limits`` entry)
reads the (C, S, S) map through its own C entry; each side gets the
layout its source reads. Each kernel is timed in turns (other, this,
this, other), two ways:

- device ms: the kernel's own duration per launch, from torch.profiler's
  CUDA kernel records; the host's work in the wrapper is not in it;
- event ms: CUDA events around back-to-back wrapper calls, after one
  warm-up (chip_smoke.py's method). When the host takes longer to issue a
  call than the kernel runs, this is the host's issue time.

The two checkouts' outputs are held equal (torch.equal for the raster,
max |diff| <= 1e-5 for K6). Prints the card (nvidia-smi name, power
limit) and one JSON line. Needs the card: on a CPU there is no kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess

import torch

from ..ops import build, pcf, raster
from . import config4_views, time_ms

SOFT = 2.5
N_BANDS = 4


def device_ms(fn, reps: int, kernel: str, windows: int = 3) -> float:
    """Mean device duration (ms) of one launch of the CUDA kernel whose
    name holds `kernel`, over `reps` calls of fn() after one warm-up; each
    call launches one.

    The profiler may drop records: one of 20 was seen missing, and once
    all 20 of a window. So the mean is over the records a window kept,
    when that is at least half of them; a window that kept fewer is
    profiled again, up to `windows` windows. When none kept enough, the
    time comes from CUDA events around each call instead
    (`queued_event_ms`, all of fn()'s device work), and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if len(times) > reps:
            raise RuntimeError(f"{len(times)} records of {kernel} in {reps} "
                               "calls")
        if len(times) >= reps // 2:
            return sum(times) / len(times) / 1000.0
        kept.append(len(times))
    ms = queued_event_ms(fn, reps)
    print(f"device ms of {kernel} from CUDA events ({ms:.4f} ms): the "
          f"profiler kept {kept} records of {reps} calls in {windows} "
          "windows", flush=True)
    return ms


def queued_event_ms(fn, reps: int, sleep_cycles: int = 4_000_000) -> float:
    """Mean ms per call of fn() between CUDA events recorded just before
    and after it, each call queued behind a device sleep of `sleep_cycles`
    clocks (about 2 ms on an H100) so that the host's issue time of the
    events and of fn()'s launches is not in the interval."""
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


# the C entry of the eager wrapper (beside the error entry): an older
# checkout's pcf.cu lacks the compiled frame's texture entries
PCF_ENTRIES = ("crychic_soft_pcf",)
# the eager entry of a pcf.cu that reads the unpadded (C, S, S) map:
# (map, params, m, C, S, radius, out, stream)
_LEGACY_PCF = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p], ctypes.c_int)


def libraries(root: str):
    """(raster, pcf) KernelLibrary of the checkout at `root`. The pcf
    library's `window_ready` says which map its kernel reads."""
    csrc = os.path.join(os.path.abspath(root), "crychic_renderer_tpu_torch",
                        "csrc")
    with open(os.path.join(csrc, "pcf.cu")) as f:
        window_ready = "crychic_soft_pcf_limits" in f.read()
    sigs = {k: pcf.LIBRARY.signatures[k] for k in PCF_ENTRIES}
    if not window_ready:
        sigs["crychic_soft_pcf"] = _LEGACY_PCF
    lib = build.KernelLibrary(os.path.join(csrc, "pcf.cu"), pcf.LIBRARY.name,
                              sigs, pcf.LIBRARY.error)
    lib.window_ready = window_ready
    return (build.KernelLibrary(os.path.join(csrc, "raster.cu"),
                                raster.LIBRARY.name,
                                raster.LIBRARY.signatures,
                                raster.LIBRARY.error), lib)


@contextlib.contextmanager
def using(libs):
    """The wrappers launch `libs`' kernels inside the block."""
    saved = raster.LIBRARY, pcf.LIBRARY
    raster.LIBRARY, pcf.LIBRARY = libs
    try:
        yield
    finally:
        raster.LIBRARY, pcf.LIBRARY = saved


def pcf_inputs(device, size: int = None):
    """(qmap, params) of config 4's 1080p frame at time 0, on size^2 maps
    if given: the window-ready atlas and both cascades of every pixel's
    receiver (chip_smoke.py phase 7's inputs; phase 19's at 520)."""
    from ..app.renderer import Renderer
    from ..models.scenes_baseline import CONFIGS
    from ..ops import shadows
    from ..passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    if size is not None:
        cfg = dataclasses.replace(cfg, shadow_map_size=size)
    r = Renderer(scene, cfg, lights=lights, device=device)
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
    return (pcf.quantize_map(maps),
            pcf.receiver_params(pos.reshape(-1, 4), cascades.reshape(-1),
                                cfg.shadow_map_size))


def soft_pcf_any(qmap, params):
    """K6 of the pcf library the wrappers use now (`using`): through
    ops/pcf.soft_pcf where it reads the window-ready buffer, else through
    the older C entry on the unpadded (C, S, S) map."""
    lib = pcf.LIBRARY
    if getattr(lib, "window_ready", True):
        return pcf.soft_pcf(qmap, params, SOFT)
    S = pcf.map_size(qmap)
    flat = qmap[:, :S, :S].contiguous()
    m = params.shape[1]
    out = torch.empty((m,), dtype=torch.float32, device=params.device)
    stream = torch.cuda.current_stream(params.device).cuda_stream
    cdll = lib.load()
    rc = cdll.crychic_soft_pcf(flat.data_ptr(), params.data_ptr(), m,
                               flat.shape[0], S, SOFT, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("the other checkout's soft PCF: "
                           + cdll.crychic_soft_pcf_error(rc).decode())
    return out


def launches(device):
    """{kernel: (fn, kernel name, equal)} of K1, K2, K3 (one fn per
    owner) and K6 on the 1080p inputs; equal(a, b) holds two outputs."""
    out = {}
    for name, tris, W, H, cap, xr, ids in config4_views(device):
        key = "K1" if ids else "K2"
        rec, st, cn, over = raster.binned_records(tris, W, H, cap,
                                                  xrange=xr)
        assert not bool(over), f"{key}: capacity overflow"
        args = (rec, st, cn, W, H, ids, xr is not None)
        out[key] = (lambda a=args: raster.raster_tiles(*a))
        band_h = -(-H // (raster.TILE_H * N_BANDS)) * raster.TILE_H
        for d in range(N_BANDS):
            b = raster.binned_records(tris, W, N_BANDS * band_h, cap,
                                      xrange=xr, row_stride=(N_BANDS, d))
            off, rows = raster.band_grid(W, N_BANDS * band_h,
                                         row_stride=(N_BANDS, d))
            a = (*b[:3], W, rows, ids, xr is not None, off)
            out[f"K3 {'main' if ids else 'atlas'} owner {d}"] = (
                lambda a=a: raster.raster_tiles(*a))
    for key, size in (("K6", None), ("K6 S=520", 520)):
        qmap, params = pcf_inputs(device, size)
        out[key] = (lambda q=qmap, p=params: (soft_pcf_any(q, p), None))
    return out


def _same(key, a, b):
    if key.startswith("K6"):
        return float((a[0] - b[0]).abs().max()) <= 1e-5
    return torch.equal(a[0], b[0]) and (
        (a[1] is None and b[1] is None) or torch.equal(a[1], b[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab_probe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = {"other": libraries(args.other), "this": (raster.LIBRARY,
                                                      pcf.LIBRARY)}
    for pair in libs.values():
        for lib in pair:
            lib.load(True)
    fns = launches(dev)
    result = {}
    for key, fn in fns.items():
        kernel = ("soft_pcf_kernel" if key.startswith("K6")
                  else "raster_tiles_kernel")
        times = {"other": {"device_ms": [], "event_ms": []},
                 "this": {"device_ms": [], "event_ms": []}}
        outs = {}
        for side in ("other", "this", "this", "other"):
            with using(libs[side]):
                outs[side] = fn()
                times[side]["device_ms"].append(
                    device_ms(fn, args.reps, kernel))
                times[side]["event_ms"].append(time_ms(fn, args.reps, dev))
        assert _same(key, outs["other"], outs["this"]), \
            f"{key}: the two checkouts' outputs differ"
        result[key] = times
    print(smi)
    print(json.dumps({"card": smi, "other": args.other, "reps": args.reps,
                      "kernels": result}))


if __name__ == "__main__":
    main()
