"""Render the README gallery on the port (the counterpart of the
repository's ``experiments/make_gallery.py``).

Writes under --out (default build/gallery; the committed docs/gallery/
stays as the JAX package rendered it): all five BASELINE configs at
native resolution (downscaled 2x) plus the two debug views the reference
exposes (ShadowDebug.hlsl's quad via cfg.debug_view="shadow_cascade3",
and the commented-out cascade colorization as "cascades"). Configs 2, 3
and 5 load their files as the port's bench does (``bench.assets``: the
reference's where they exist, else the synthetic set written from seed
0).

    python -m crychic_renderer_tpu_torch.experiments.make_gallery
    python -m crychic_renderer_tpu_torch.experiments.make_gallery \\
        --device cpu --small
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from .. import bench


def _save(img: np.ndarray, path: str, scale: int = 2):
    from ..app.renderer import write_png

    rgb = np.clip(img[..., :3], 0.0, 1.0).astype(np.float32)
    if scale > 1:  # box downscale (dependency-free, like write_png itself)
        h, w = rgb.shape[:2]
        h2, w2 = h // scale * scale, w // scale * scale
        rgb = rgb[:h2, :w2].reshape(h2 // scale, scale, w2 // scale,
                                    scale, 3).mean((1, 3))
    write_png(path, rgb)
    print(f"wrote {path} ({rgb.shape[1]}x{rgb.shape[0]})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="quarter-res (CPU-friendly smoke run)")
    ap.add_argument("--out", default=os.path.join("build", "gallery"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..app.renderer import Renderer, resolve_device
    from ..models import scenes_baseline as sb

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    captions = {
        1: "crate_forward", 2: "skull_forward", 3: "deferred_lights",
        4: "cascade_shadows_ssao", 5: "full_scene",
    }
    with bench.assets(args.small) as (kw, _):
        for n in sorted(sb.CONFIGS):
            scene, cfg, lights = sb.CONFIGS[n]()
            if args.small:
                # capacities are left alone: Renderer's auto_capacity
                # resizes them from exact pair counts anyway
                cfg = dataclasses.replace(
                    cfg, width=cfg.width // 4, height=cfg.height // 4,
                    shadow_map_size=max(cfg.shadow_map_size // 4, 128))
            r = Renderer(scene, cfg, lights=lights, device=device,
                         **bench.renderer_files(n, kw))
            _save(r.render_np(0.1), f"{args.out}/config{n}_{captions[n]}.png",
                  scale=1 if args.small else 2)
            if n == 4:
                for view in ("cascades", "shadow_cascade3"):
                    r.cfg = dataclasses.replace(r.cfg, debug_view=view)
                    r.rebind_frame_fn()
                    _save(r.render_np(0.1), f"{args.out}/config4_{view}.png",
                          scale=1 if args.small else 2)


if __name__ == "__main__":
    main()
