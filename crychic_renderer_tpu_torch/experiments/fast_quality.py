"""The --fast preset's image quality against parity (the port's
counterpart of the repository's ``experiments/fast_quality.py``).

Renders configs 4 and 5 at native resolution with the parity defaults
and with cfg.fast_preset(), then reports PSNR and SSIM of fast vs
parity, plus the fraction of pixels moved >2%. Also writes the pair
config5_{parity,fast}.png (2x box downscale) under --gallery.

SSIM here is the standard Wang et al. formulation with an 11x11
Gaussian window (sigma 1.5), computed per channel on the [0,1] float
image and averaged, in numpy: the JAX script's functions, copied, give
the same numbers bit for bit.

Configs 2, 3 and 5 load their files as the port's bench does
(``bench.assets``: the reference's where they exist, else the synthetic
set written from seed 0); each line names the set it rendered.

    python -m crychic_renderer_tpu_torch.experiments.fast_quality
    python -m crychic_renderer_tpu_torch.experiments.fast_quality \\
        --device cpu --small --configs 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from .. import bench


def _gauss_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def _filter2_sep(img, k):
    """Separable 'valid' 2D filter of (H, W) with 1D kernel k."""
    from numpy.lib.stride_tricks import sliding_window_view

    a = sliding_window_view(img, len(k), axis=0) @ k
    return sliding_window_view(a, len(k), axis=1) @ k


def ssim(a, b, data_range=1.0):
    """Mean SSIM over channels, 11x11 Gaussian window."""
    k = _gauss_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch].astype(np.float64), b[..., ch].astype(np.float64)
        mx, my = _filter2_sep(x, k), _filter2_sep(y, k)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        sx = _filter2_sep(x * x, k) - mxx
        sy = _filter2_sep(y * y, k) - myy
        sxy = _filter2_sep(x * y, k) - mxy
        m = ((2 * mxy + c1) * (2 * sxy + c2)
             / ((mxx + myy + c1) * (sx + sy + c2)))
        vals.append(m.mean())
    return float(np.mean(vals))


def psnr(a, b, data_range=1.0):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range * data_range / mse)


def main(argv=None):
    """Prints one line per config; returns {config: dict(psnr, ssim,
    moved, size, assets)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="1/4 resolution (CPU-friendly smoke run)")
    ap.add_argument("--configs", type=int, nargs="+", default=[4, 5])
    ap.add_argument("--gallery", default=os.path.join("build", "gallery"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..app.renderer import Renderer, resolve_device, write_png
    from ..models import scenes_baseline as sb

    device = resolve_device(args.device)
    rows = {}
    with bench.assets(args.small) as (kw, source):
        for c in args.configs:
            scene, cfg, lights = sb.CONFIGS[c]()
            if args.small:
                cfg = dataclasses.replace(
                    cfg, width=cfg.width // 4, height=cfg.height // 4,
                    shadow_map_size=max(cfg.shadow_map_size // 4, 128))
            files = bench.renderer_files(c, kw)
            par = Renderer(scene, cfg, lights=lights, device=device,
                           **files).render_np(0.1)
            fast = Renderer(scene, cfg.fast_preset(), lights=lights,
                            device=device, **files).render_np(0.1)
            a = np.clip(par[..., :3], 0.0, 1.0)
            b = np.clip(fast[..., :3], 0.0, 1.0)
            moved = (np.abs(a - b).max(-1) > 0.02).mean()
            assets = source if c in bench.LOADS_FILES else "built in"
            rows[c] = dict(psnr=psnr(a, b), ssim=ssim(a, b),
                           moved=float(moved),
                           size=f"{cfg.width}x{cfg.height}", assets=assets)
            print(f"config {c}: fast-vs-parity  PSNR {rows[c]['psnr']:6.2f} "
                  f"dB   SSIM {rows[c]['ssim']:.4f}   pixels moved >2%: "
                  f"{moved:.2%}   ({cfg.width}x{cfg.height}, {assets} "
                  f"assets)", flush=True)
            if c == 5 and not args.small:
                os.makedirs(args.gallery, exist_ok=True)
                for name, img in (("parity", a), ("fast", b)):
                    h, w = (x // 2 * 2 for x in img.shape[:2])
                    d = img[:h, :w].reshape(h // 2, 2, w // 2, 2,
                                            3).mean((1, 3))
                    write_png(f"{args.gallery}/config5_{name}.png",
                              d.astype(np.float32))
                    print(f"wrote {args.gallery}/config5_{name}.png",
                          flush=True)
    return rows


if __name__ == "__main__":
    main()
