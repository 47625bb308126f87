"""Headline benchmark of the port: BASELINE config 5 (skull + car,
deferred + shadows + SSAO + PBR) at 1920x1080 on one card, the port's
counterpart of the repository's ``bench.py``.

    python -m crychic_renderer_tpu_torch.bench            # on the card
    python -m crychic_renderer_tpu_torch.bench --device cpu --small

Prints, as its last line, ONE JSON object:
    {"metric": ..., "value": ms_per_frame, "unit": "ms/frame",
     "vs_baseline": BASELINE_MS / value, "rounds_ms": [...],
     "frames_per_round": N_FRAMES, "kernel_launches": {"ids": K1,
     "depth": K2, "pcf": K6}, "frames": 1 + N_FRAMES * ROUNDS,
     "card": "<nvidia-smi name, power.limit>", "assets": ...}

Each round queues N_FRAMES frames back to back through
``Renderer.render`` and reads one value of the last frame back, so a round
times the overlap of host issue and device work (render throughput), not
a per-frame round trip; ``value`` is the median of ROUNDS rounds. On the
card each frame is one replay of the Renderer's CUDA graph; the warm-up
frame, outside the clock, runs the eager frame that precedes the capture,
captures the graph and replays it, so each hand kernel launches once more
than there are frames.
``check_overflow()`` runs after the rounds, outside the clock: a frame
that dropped geometry fails the run instead of making a fast number.

Config 5 renders from the reference's files where
``models.scenes_baseline.REF_MODELS`` holds the meshes and the texture
directory exists; otherwise from the synthetic asset set
(``experiments/synthetic_assets.py``, seed 0) written into a temporary
directory. ``metric`` and ``assets`` say which. There is no fallback to
another config or device: any failure prints its traceback and exits
non-zero. ``--small`` (160x90, 128^2 shadow maps, the SMALL asset set,
2 rounds of 2 frames) is for the CPU tests.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

BASELINE_MS = 16.0
N_FRAMES = 20
ROUNDS = 5
SMALL_FRAMES = 2
SMALL_ROUNDS = 2
# the BASELINE configs built from the reference's Models/ and Textures/
LOADS_FILES = (2, 3, 5)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _have_reference() -> bool:
    from .app.renderer import DEFAULT_ASSET_DIR
    from .models import scenes_baseline as sb

    return (all(os.path.exists(os.path.join(sb.REF_MODELS, f))
                for f in ("skull.txt", "car.txt"))
            and os.path.isdir(DEFAULT_ASSET_DIR))


@contextlib.contextmanager
def assets(small: bool):
    """(Renderer keywords, source) for the configs that load files (2, 3,
    5): the reference's files where they exist, else the synthetic set
    written into a temporary directory, with scenes_baseline.REF_MODELS
    pointed at its meshes inside the block."""
    from .experiments import synthetic_assets as sa
    from .models import scenes_baseline as sb

    if _have_reference():
        yield {}, "reference"
        return
    with tempfile.TemporaryDirectory() as root:
        paths = sa.write_asset_set(root, sa.SMALL if small else sa.FULL,
                                   seed=0)
        models = sb.REF_MODELS
        sb.REF_MODELS = paths["models"]
        try:
            yield (dict(asset_dir=paths["textures"],
                        sky_cubemap_path=paths["sky_cube"]), "synthetic")
        finally:
            sb.REF_MODELS = models


def renderer_files(config: int, kw: dict) -> dict:
    """The keywords of assets() that BASELINE `config`'s Renderer takes:
    config 5 its textures and sky cube, configs 2 and 3 their textures
    (their sky stays procedural); configs 1 and 4 load no file."""
    return {k: v for k, v in kw.items()
            if config == 5 or (config in LOADS_FILES and k == "asset_dir")}


def shrink(cfg):
    """The --small size of a config."""
    return dataclasses.replace(cfg, width=160, height=90,
                               shadow_map_size=128)


def read_back(img: torch.Tensor) -> float:
    """One value of a frame on the host: waits for the frame."""
    return float(img[0, 0, 0])


def frame_rounds(r, n: int, rounds: int):
    """One warm-up frame read back, then `rounds` rounds of n frames
    queued back to back with one read back at the end. Checks the
    overflow flags after the rounds. Returns (ms/frame of each round, host
    clock; the hand kernels' launches over all 1 + n * rounds frames and,
    on the card, the eager frame before the capture, read from the tally
    (ops/tally.py): K1 "ids", K2 "depth", K6 "pcf"; 0 on the CPU, which
    runs their plain versions)."""
    from .ops import tally

    before = tally.snapshot()
    read_back(r.render(0.0))
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        img = None
        for i in range(n):
            img = r.render(i / 60.0)
        read_back(img)
        out.append(1000.0 * (time.perf_counter() - t0) / n)
    r.check_overflow()
    ran = tally.since(before)
    launches = dict(ids=ran.get("raster.ids", 0),
                    depth=ran.get("raster.depth", 0), pcf=ran.get("pcf", 0))
    return out, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="160x90, 128^2 maps, 2 rounds of 2 frames (CPU "
                         "tests)")
    args = ap.parse_args(argv)

    from .app.renderer import Renderer, resolve_device
    from .models import scenes_baseline as sb

    device = resolve_device(args.device)
    n, rounds = ((SMALL_FRAMES, SMALL_ROUNDS) if args.small
                 else (N_FRAMES, ROUNDS))
    with assets(args.small) as (kw, source):
        scene, cfg, lights = sb.config5_full_scene()
        if args.small:
            cfg = shrink(cfg)
        r = Renderer(scene, cfg, lights=lights, device=device, **kw)
        rounds_ms, launches = frame_rounds(r, n, rounds)
    ms = statistics.median(rounds_ms)
    print(json.dumps({
        "metric": f"ms/frame {cfg.width}x{cfg.height} skull+car "
                  f"deferred+shadows+SSAO+PBR ({source} assets)",
        "value": ms,
        "unit": "ms/frame",
        "vs_baseline": BASELINE_MS / ms,
        "rounds_ms": rounds_ms,
        "frames_per_round": n,
        "kernel_launches": launches,
        "frames": 1 + n * rounds,
        "card": card(device),
        "assets": source,
    }), flush=True)


if __name__ == "__main__":
    main()
