"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result line.

Set-up (``setup_s``, from the process's start to the window's first
frame): building the kernels where the checkout has not built them yet,
writing the synthetic asset set under TMPDIR from the seed, building the
port's Renderer on the card, walking the traffic's poses with
``ensure_capacity`` where the traffic asks, and warming up the compiled
frame (its eager frame, the graph's capture, then the traffic's frame
loop for WARM_S seconds). The window then issues frames for
``seconds``. After it: the
peak device memory, the Renderer's overflow flags, in a traced run the
stage graphs of ``app/profiler.profile_frame``; then the program's state
is freed and the reference renders the compared frames.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, loop, sides, spec, trace, traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "crychic_renderer_tpu")
COMPARED = 2  # frames drawn from the seed, besides the window's last
SAMPLE_BELOW = 64  # ...among the window's first frames
STRETCH_FRAMES = 12  # frames in the traced run's profiler stretch
STRETCH_START = 1.0 / 3.0  # of the window, where the stretch starts
STAGE_REPS = 3
# Seconds of the traffic's own frame loop in set-up, after the capture:
# on the H100 the same frames ran ~4% slower for the first 1.4-7.6 s of
# full load, then at the steady rate (PERF.md); set-up takes that.
WARM_S = 8.0


@dataclasses.dataclass
class RunData:
    """What a per-layer metric's reader reads (metrics/<name>.py)."""
    config: dict
    traffic: traffic_mod.Traffic
    window: loop.Window
    trace: trace.Summary = None  # the stretch's device trace
    stages: dict = None  # profile_frame's {stage: ms}
    work: list = None  # the reference's counts per stretch frame


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared by the whole top-level name."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def clocks() -> str:
    """The card's SM clock, temperature and power draw (nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def card_name() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _p95(values: list) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=20)[18]


def _walk_capacities(r, tr, cam):
    """Walk every pose of the path: read its counts once
    (capacity_requirements), then, while a pose's counts outrun the
    capacities (the check ensure_capacity makes), ensure_capacity at that
    pose, which sizes them again there by the Renderer's own rule. A
    capacity grown at one pose is sized for that pose alone, so every
    pose is checked again after a growth."""
    from crychic_renderer_tpu_torch.app.renderer import (CapacityError,
                                                         check_counts)

    counts = []
    for k, pose in enumerate(tr.poses()):
        r.camera = cam(pose)
        counts.append((k, pose, r.capacity_requirements(tr.time(k))))
    for _ in range(8):
        for k, pose, c in counts:
            try:
                check_counts(r.cfg, c["main_pairs"], c["shadow_pairs"],
                             c["shade_tiles"], c["ssao_tiles"],
                             c["main_max_tile"], c["shadow_max_tile"])
            except CapacityError:
                r.camera = cam(pose)
                r.ensure_capacity(tr.time(k))
                break
        else:
            return
    raise RuntimeError("the capacities did not settle over the path")


def _assets(config: dict, root: str, seed: int, small: bool):
    """(models dir, texture dir, sky cube path) of the configuration's
    asset set, written under root from the seed; without one, an empty
    texture dir (every slot the white 1x1) and no meshes or cube."""
    if not config.get("assets"):
        empty = os.path.join(root, "no-textures")
        os.makedirs(empty)
        return None, empty, None
    from ..scenes import synthetic_assets as sa

    paths = sa.write_asset_set(root, sa.SMALL if small else sa.FULL,
                               seed=seed)
    return paths["models"], paths["textures"], paths["sky_cube"]


def run(bench: dict, workload: dict, seed: int, seconds: float,
        traced: bool, device: torch.device, t_start: float,
        size: dict = None):
    """One run of the cell; returns (the result line's dict, a dict of
    readings for the record: set-up phases, clocks, frame intervals, each
    compared frame's numbers). `size` replaces render settings and takes
    the small asset set (the CPU tests)."""
    config = spec.config(bench, workload["config"])
    tr = traffic_mod.from_spec(spec.traffic(workload["traffic"]), seed)
    F = tr.frames_in_flight
    phases = {}
    t_phase = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    with tempfile.TemporaryDirectory(prefix="crychic-bench-") as tmp:
        models, textures, cube = _assets(config, tmp, seed, bool(size))
        phase("assets")
        from crychic_renderer_tpu_torch.app.renderer import Renderer

        port = sides.program()
        scene, cfg, lights = sides.build(port, config, models, size)
        aspect = cfg.width / cfg.height

        def cam(pose, side=port):
            return traffic_mod.camera(side.Camera, tr, pose, aspect)

        r = Renderer(scene, cfg, camera=cam(tr.pose(0)), lights=lights,
                     asset_dir=textures, sky_cubemap_path=cube,
                     device=device)
        phase("renderer")
        if tr.walk_capacities:
            _walk_capacities(r, tr, cam)
        else:
            r.ensure_capacity(0.0)
        phase("capacities")

        def issue(n):
            r.camera = cam(tr.pose(n))
            return r.render(tr.time(n))

        issue(0)  # the eager frame, the capture and the first replay
        loop.synchronize(device)
        loop.run(issue, F, WARM_S if device.type == "cuda" else 0.0, device)
        stretch = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # the profiler's first run pays its own start-up
            with torch.profiler.profile(activities=acts):
                issue(0)
                loop.synchronize(device)
            profiler = torch.profiler.profile(activities=acts)
            stretch = loop.Stretch(profiler, device,
                                   STRETCH_START * seconds, STRETCH_FRAMES)
        phase("warm_up")
        rng = np.random.default_rng([seed, 1])
        keep = check.sample_frames(rng, COMPARED, SAMPLE_BELOW)
        clocks_before = clocks() if device.type == "cuda" else ""
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        window = loop.run(issue, F, seconds, device, keep, stretch)
        clocks_after = clocks() if device.type == "cuda" else ""
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        overflow = None
        try:
            r.check_overflow()
        except RuntimeError as e:
            overflow = str(e)
        data = RunData(config=config, traffic=tr, window=window)
        if traced:
            from crychic_renderer_tpu_torch.app.profiler import profile_frame

            data.trace = trace.summarize_profiler(stretch.profiler, tmp)
            data.stages = profile_frame(r, tr.time(window.frames - 1),
                                        reps=STAGE_REPS)
        sized = r.cfg
        r.close()
        del r, issue
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        from ..reference.render import ReferenceFrame

        ref_side = sides.reference()
        rscene, rcfg, rlights = sides.build(ref_side, config, models, size)
        ref = ReferenceFrame(rscene, rcfg, rlights, device,
                             asset_dir=textures, sky_cubemap_path=cube)
        tol = config["check"]["pixel_tolerance"]
        off, finer = {}, {}
        for n, img in sorted(window.kept.items()):
            want = ref.render(cam(tr.pose(n), ref_side), tr.time(n))
            finer[n] = check.numbers(img, want, tol)
            off[n] = finer[n]["max_abs"]
            del want
        if traced:
            by_pose = {}
            data.work = []
            for n in window.profiled:
                p = tr.pose(n)
                if p not in by_pose:
                    by_pose[p] = ref.work(cam(p, ref_side))
                data.work.append(by_pose[p])
        ref_s = time.perf_counter() - t_ref

    limit = config["check"]["max_abs_limit"]
    worst = max(off.values())
    compared_ok = all(v <= limit for v in off.values())
    checks = {
        "max_abs": {"value": worst, "limit": limit},
        "overflow_flags": {"value": int(overflow is not None), "limit": 0},
        "frames_compared": {"value": len(off), "limit": COMPARED + 1},
    }
    correct = (compared_ok and overflow is None
               and len(off) == COMPARED + 1)
    failed = window.frames if overflow else sum(v > limit
                                                for v in off.values())
    metrics = {}
    if traced:
        for m in spec.metrics_of(bench, "per_layer", workload["name"]):
            v = spec.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(frame_ms=1000.0 * window.seconds / window.frames,
                   frame_p95_ms=_p95(window.intervals_ms), setup_s=setup_s)
        for m in spec.metrics_of(bench, "end_to_end", workload["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.frames,
              "failed": int(failed), "metrics": metrics, "device": dev}
    if traced and data.trace is not None:
        dev["busy_s"] = data.trace.busy_s
        dev["window_s"] = data.trace.window_s
        result["breakdown"] = {
            "device_ops": data.trace.top_ops(10),
            "idle_gaps": [[label, s] for label, s in data.trace.gaps]}
    info = {"card": card_name() if device.type == "cuda" else "cpu",
            "frames": window.frames, "window_s": window.seconds,
            "setup_phases_s": phases,
            "clocks_sm_temp_power": [clocks_before, clocks_after],
            "interval_histogram_ms": sorted(collections.Counter(
                round(v * 4) / 4 for v in window.intervals_ms).items()),
            "longest_intervals_ms": sorted(
                ((v, i + 1) for i, v in enumerate(window.intervals_ms)),
                reverse=True)[:5],
            "reference_s": ref_s, "compared": finer, "overflow": overflow,
            "cfg": {k: getattr(sized, k) for k in (
                "pair_capacity", "shadow_pair_capacity",
                "shade_tile_capacity", "ssao_tile_capacity")}}
    result["checks"] = checks
    return result, info
