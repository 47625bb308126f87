"""Scene snapshot (checkpoint/resume); the port's copy of
``crychic_renderer_tpu.io.snapshot``, in the same file format, so a
snapshot written by either package loads in the other.

The reference has no persistence (scenes are rebuilt at boot); the
flattened draw buffers, material bank and lights serialize to one .npz,
so a large scene (mesh parsing, BC decode, mip generation) loads back in
milliseconds. The texture names are stored as a pickled object array, as
the JAX package stores them, so load only snapshots this program wrote.
"""
from __future__ import annotations

import numpy as np

from ..models.materials import Lights, MaterialBank
from ..models.scene import DrawBuffers, Scene

_DRAW_FIELDS = [f for f in DrawBuffers.__dataclass_fields__]
_MAT_FIELDS = [f for f in MaterialBank.__dataclass_fields__]
_LIGHT_ARRAYS = ["strength", "direction", "position", "falloff_start",
                 "falloff_end", "spot_power", "ambient"]


def save_scene(path: str, scene: Scene, lights: Lights = None):
    blob = {}
    for prefix, draw in (("opaque", scene.opaque), ("shadow", scene.shadow)):
        for f in _DRAW_FIELDS:
            blob[f"{prefix}.{f}"] = getattr(draw, f)
    for f in _MAT_FIELDS:
        blob[f"mat.{f}"] = getattr(scene.material_bank, f)
    blob["texture_names"] = np.array(scene.texture_names or [], dtype=object)
    if lights is not None:
        for f in _LIGHT_ARRAYS:
            blob[f"light.{f}"] = getattr(lights, f)
        blob["light.counts"] = np.array(
            [lights.num_dir, lights.num_point, lights.num_spot])
    np.savez_compressed(path, **blob)


def load_scene(path: str):
    """Returns (Scene, Lights or None). Items are not reconstructed (the
    flattened buffers are the render-ready representation)."""
    with np.load(path, allow_pickle=True) as z:
        def draw(prefix):
            return DrawBuffers(**{f: z[f"{prefix}.{f}"]
                                  for f in _DRAW_FIELDS})

        bank = MaterialBank(**{f: z[f"mat.{f}"] for f in _MAT_FIELDS})
        scene = Scene(items=[], materials=[], material_bank=bank,
                      opaque=draw("opaque"), shadow=draw("shadow"),
                      texture_names=list(z["texture_names"]))
        lights = None
        if "light.counts" in z:
            kw = {f: z[f"light.{f}"] for f in _LIGHT_ARRAYS}
            nd, npt, ns = z["light.counts"]
            lights = Lights(**kw, num_dir=int(nd), num_point=int(npt),
                            num_spot=int(ns))
    return scene, lights
