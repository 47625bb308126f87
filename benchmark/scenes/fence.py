"""BASELINE config 4's scene with its AlphaTested layer filled: the
cascade-shadow scene of ``scenes/cascade.py`` (100 boxes, the grid and
their shadow casters, imported, not copied) and two wire-fence crates in
the reference's ``RenderLayer::AlphaTested`` (CRYCHIC.h:44-54), the
``ALPHA_TEST`` PSOs that clip(a - 0.1) in the main view (Default.hlsl:106)
and in the shadow pass (Shadows.hlsl:49-65).

The crates are the port's ``scenes_baseline.fence_scene`` geometry: a
6x6x6 box (create_box(6, 6, 6, 0)) textured with ``WireFence`` and
``default_nmap``, appended as texture slots 10 and 11, at two instances
in a row along the view axis, centred at (0, 3, -3) and (0, 3, 3). From
the reference pose (0, 2, -15) the front crate covers about a third of
the frame and the rear crate shows only through its holes; seen end-on a
ray crosses up to four crate faces. The crates cast shadows only through
the layer's punch into the cascade maps (no shadow-layer duplicate).
"""
from __future__ import annotations

import importlib

import numpy as np

from ..reference.models import geometry as gg
from ..reference.utils import mathutil as mu
from . import cascade

TEXTURE_NAMES = cascade.TEXTURE_NAMES + ["WireFence", "default_nmap"]
CRATE_CENTRES = ((0.0, 3.0, -3.0), (0.0, 3.0, 3.0))


def materials(api):
    """config 4's 5 materials and the wire fence (fence_scene's)."""
    return cascade.materials(api) + [
        api.Material("wirefence", 5, 10, 11, (1, 1, 1, 1), (0.1, 0.1, 0.1),
                     0.25)]


def build(api, models_dir=None):
    base, lights = cascade.build(api, models_dir)
    alpha_layer = importlib.import_module(
        api.Scene.__module__).LAYER_ALPHA_TESTED
    crates = api.make_item(
        "wire_fence_crates", gg.create_box(6.0, 6.0, 6.0, 0), alpha_layer,
        np.stack([mu.translation(*c) for c in CRATE_CENTRES]),
        material_indices=5)
    mats = materials(api)
    scene = api.Scene(items=base.items + [crates], materials=mats,
                      material_bank=api.MaterialBank.from_materials(mats),
                      opaque=base.opaque, shadow=base.shadow,
                      alpha=api.flatten_items([crates]),
                      texture_names=TEXTURE_NAMES)
    return scene, lights
