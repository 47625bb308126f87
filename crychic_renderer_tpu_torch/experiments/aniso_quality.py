"""The anisotropic-filtering probe schedules against a reference-quality
evaluation (the port's counterpart of the repository's
``experiments/aniso_quality.py``).

The yardstick is ``ops/sampling.sample_pair_aniso_ref``: max_aniso (=8)
probes along the major-axis footprint, each an exact two-gather
trilinear. Candidates:

- legacy4: single-mip pool, 4 probes ALTERNATING mips m0/m1 with weights
  1-f/f: 4 row gathers;
- dual2 / dual4: dual-mip rows (one gather per probe covers BOTH mips),
  2 or 4 purely-spatial probes: 2 / 4 row gathers;
- trilinear: isotropic footprint (1 dual gather) for scale.

Renders the texture-heaviest BASELINE configs (1: single box; 5:
skull+car over the tiled ground at grazing angles) at 1/4 scale with
each schedule and reports PSNR and the shares of pixels off by more than
5 and 2 of 255 against the reference render. Config 5 loads its files as
the port's bench does (``bench.assets``: the reference's where they
exist, else the synthetic set written from seed 0; the config's header
line names the set).

    python -m crychic_renderer_tpu_torch.experiments.aniso_quality
    python -m crychic_renderer_tpu_torch.experiments.aniso_quality \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from .. import bench


def metrics(img, ref):
    d = np.abs(img[..., :3] - ref[..., :3])
    mse = float((d ** 2).mean())
    psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
    u8 = np.abs((np.clip(img[..., :3], 0, 1) * 255 + 0.5).astype(np.int16)
                - (np.clip(ref[..., :3], 0, 1) * 255 + 0.5).astype(np.int16))
    return psnr, float((u8 > 5).mean()), float((u8 > 2).mean())


def main(argv=None):
    """Prints each config's rows; returns {config: {variant: (PSNR dB,
    share > 5/255, share > 2/255)}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..app.renderer import Renderer, resolve_device
    from ..models import scenes_baseline as sb

    device = resolve_device(args.device)
    rows = {}
    with bench.assets(False) as (kw, source):
        for c in (1, 5):
            scene, cfg, lights = sb.CONFIGS[c]()
            k = 4
            cfg = dataclasses.replace(
                cfg, width=cfg.width // k, height=cfg.height // k,
                shadow_map_size=max(cfg.shadow_map_size // k, 128))

            variants = {
                "ref (8x trilinear, 16 gathers)":
                    dataclasses.replace(cfg, aniso_probes=0,
                                        dual_mip_rows=False),
                "legacy4 (4 gathers)":
                    dataclasses.replace(cfg, aniso_probes=4,
                                        dual_mip_rows=False),
                "dual2   (2 gathers)":
                    dataclasses.replace(cfg, aniso_probes=2,
                                        dual_mip_rows=True),
                "dual4   (4 gathers)":
                    dataclasses.replace(cfg, aniso_probes=4,
                                        dual_mip_rows=True),
                "trilinear (1 dual gather)":
                    dataclasses.replace(cfg, anisotropy=1,
                                        dual_mip_rows=True),
            }
            ref = None
            rows[c] = {}
            note = f", {source} assets" if c in bench.LOADS_FILES else ""
            print(f"== config {c} ({cfg.width}x{cfg.height}{note})",
                  flush=True)
            for name, v in variants.items():
                img = Renderer(scene, v, lights=lights, device=device,
                               **bench.renderer_files(c, kw)).render_np(0.0)
                if ref is None:
                    ref = img
                    print(f"  {name:34s}  (reference)", flush=True)
                    continue
                psnr, f5, f2 = rows[c][name] = metrics(img, ref)
                print(f"  {name:34s}  PSNR {psnr:6.2f} dB   "
                      f">2% px {f5:.4%}   >0.8% px {f2:.4%}", flush=True)
    return rows


if __name__ == "__main__":
    main()
