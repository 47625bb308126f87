"""Image comparison tooling (torch counterpart of
``crychic_renderer_tpu.app.compare``).

Renders BASELINE configs and reports per-image statistics, with an
optional diff against stored .npy goldens of this tool (``--out-dir``
writes them, ``--check`` reads them). The repository's ``tests/goldens/``
were rendered with texture assets this tree lacks; do not check against
them.

``--parity`` holds each config's frame on the card two ways, each under
the JAX bound (under 0.5% of pixels more than 0.02 apart; the exit code is
nonzero when a config misses either): against the same frame from the
port's CPU path, which runs the kernels' plain versions, and (key
``"xla"``) the JAX package's own comparison, the kernel frame
(``use_pallas=True``) against the pure-tensor raster's frame
(``use_pallas=False``) on the same card: a second rasterizer,
independent of the kernels, at the card's resolution.

Usage::

    python -m crychic_renderer_tpu_torch.app.compare --configs 4 \
        --out-dir goldens [--small] [--check goldens] [--device cuda]
    python -m crychic_renderer_tpu_torch.app.compare --parity --small

Configs 1 and 4 build from code alone; configs 2, 3 and 5 load
Models/skull.txt and Models/car.txt from scenes_baseline.REF_MODELS, and
every config reads its textures from the Renderer's default asset
directory (a missing texture renders as white 1x1).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

PARITY_FRAC = 0.005


def stats(img: np.ndarray) -> dict:
    rgb = img[..., :3]
    return {
        "mean": round(float(rgb.mean()), 6),
        "std": round(float(rgb.std()), 6),
        "p05": round(float(np.quantile(rgb, 0.05)), 6),
        "p95": round(float(np.quantile(rgb, 0.95)), 6),
    }


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return {
        "max": round(float(diff.max()), 6),
        "mean": round(float(diff.mean()), 6),
        "frac_gt_2pct": round(float((diff > 0.02).mean()), 6),
    }


def _config(c: int, small: bool):
    """(scene, cfg, lights) of BASELINE config c; small: 1/4 size, as the
    JAX tool's --small."""
    from ..models.scenes_baseline import CONFIGS

    scene, cfg, lights = CONFIGS[c]()
    if small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 4, height=cfg.height // 4,
            shadow_map_size=max(cfg.shadow_map_size // 4, 128))
    return scene, cfg, lights


def _judged(a: np.ndarray, b: np.ndarray) -> dict:
    d = compare(a, b)
    d["ok"] = d["frac_gt_2pct"] < PARITY_FRAC
    return d


def kernel_vs_xla(scene, cfg, lights, device, kernel_img=None) -> dict:
    """The JAX package's parity check on `device`: the frame with
    use_pallas=True (kernel_img when given, else rendered here) against
    the frame with use_pallas=False (the pure-tensor binned raster, its
    bin caps sized by the Renderer): compare() stats plus "ok"."""
    from .renderer import Renderer

    def frame(pallas):
        return Renderer(scene, dataclasses.replace(cfg, use_pallas=pallas),
                        lights=lights, device=device).render_np(0.0)

    return _judged(frame(True) if kernel_img is None else kernel_img,
                   frame(False))


def parity(configs, small: bool, device) -> dict:
    """Each config's frame on the CUDA `device` against the port's CPU
    path (plain versions of the kernels), and under "xla" against the
    pure-tensor raster's frame on the same card (kernel_vs_xla):
    compare() stats plus "ok" (frac_gt_2pct < 0.5%) for each, per config,
    and "ok" over all. A CPU `device` raises: the CPU path is the
    reference here."""
    from .renderer import Renderer

    if torch.device(device).type != "cuda":
        raise ValueError(f"parity holds the card's frame against the CPU "
                         f"path; device {device!r} is not a CUDA device")
    report = {}
    ok = True
    for c in configs:
        scene, cfg, lights = _config(c, small)
        imgs = [Renderer(scene, cfg, lights=lights, device=d).render_np(0.0)
                for d in (device, "cpu")]
        d = _judged(*imgs)
        d["xla"] = kernel_vs_xla(scene, cfg, lights, device, imgs[0])
        ok = ok and d["ok"] and d["xla"]["ok"]
        report[c] = d
        print(f"config {c}: {report[c]}", flush=True)
    report["ok"] = ok
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="+", default=[4])
    ap.add_argument("--out-dir", type=str, default="crychic_goldens")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--check", type=str, default=None,
                    help="dir of stored goldens (.npy) to diff against")
    ap.add_argument("--parity", action="store_true",
                    help="compare the card's frames with the CPU path's")
    args = ap.parse_args(argv)

    if args.parity:
        report = parity(args.configs, args.small, args.device)
        print(json.dumps(report))
        raise SystemExit(0 if report["ok"] else 1)

    from .renderer import Renderer, write_png

    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    for c in args.configs:
        scene, cfg, lights = _config(c, args.small)
        img = Renderer(scene, cfg, lights=lights,
                       device=args.device).render_np(0.0)
        write_png(os.path.join(args.out_dir, f"config{c}.png"), img)
        np.save(os.path.join(args.out_dir, f"config{c}.npy"),
                (img * 255).astype(np.uint8))
        report[c] = stats(img)
        if args.check:
            ref = np.load(os.path.join(args.check, f"config{c}.npy"))
            report[c]["diff"] = compare(img, ref.astype(np.float32) / 255.0)
        print(f"config {c}: {report[c]}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
