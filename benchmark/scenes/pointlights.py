"""BASELINE config 3's scene: the skull and the grid under 16 point
lights, lit by the deferred path with the Blinn-Phong ComputeLighting
(LightingUtil.hlsl:156-186; the reference's PBRShading drops point
lights, PBR.hlsl:122). Frozen from the port's
``models/scenes_baseline.config3_deferred_pointlights`` and
``point_light_rig``: the skull loads from ``models_dir`` (skull.txt)
through the frozen mesh loader, the grid is the frozen generator's, and
the main view's items cast the (unused) shadows.

The rig is 16 point lights on a ring of radius 8 about the y axis at
heights 2, 3 and 4 in turn, falloff 1 to 12, colours 0.5 + 0.5 x a
uniform draw from numpy's default_rng(7), ambient (0.15, 0.15, 0.2);
no directional light. LightingUtil.hlsl's light array holds 16 lights
(MAX_LIGHTS), so this is the most the source allows.
"""
from __future__ import annotations

import os

import numpy as np

from ..reference.io.mesh_txt import load_mesh_txt
from ..reference.models import geometry as gg
from ..reference.utils import mathutil as mu
from .cascade import scene_from_items

TEXTURE_NAMES = ["white1x1", "default_nmap", "tile", "tile_nmap",
                 "white1x1", "default_nmap", "sky_cube", "default_nmap",
                 "white1x1", "white1x1"]
NUM_LIGHTS = 16
RING_RADIUS = 8.0
FALLOFF = (1.0, 12.0)
AMBIENT = (0.15, 0.15, 0.2, 1.0)
COLOUR_SEED = 7


def materials(api):
    return [
        api.Material("skullMat", 0, 0, 1, (1, 1, 1, 1), (0.6, 0.6, 0.6),
                     0.8),
        api.Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2),
                     0.7),
    ]


def lights(api):
    out = api.Lights.empty(ambient=AMBIENT)
    rng = np.random.default_rng(COLOUR_SEED)
    for i in range(NUM_LIGHTS):
        ang = 2 * np.pi * i / NUM_LIGHTS
        out.position[i] = (RING_RADIUS * np.cos(ang), 2.0 + (i % 3),
                           RING_RADIUS * np.sin(ang))
        out.strength[i] = tuple(0.5 + 0.5 * rng.random(3))
        out.falloff_start[i], out.falloff_end[i] = FALLOFF
    out.num_dir = 0
    return out


def build(api, models_dir):
    skull = load_mesh_txt(os.path.join(models_dir, "skull.txt"))
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    items = [
        api.make_item("skull", skull, api.LAYER_OPAQUE,
                      mu.scaling(0.4, 0.4, 0.4)
                      @ mu.translation(0.0, 1.0, 0.0), material_indices=0),
        api.make_item("grid", grid, api.LAYER_OPAQUE, mu.scaling(2, 2, 2),
                      material_indices=1),
    ]
    return (scene_from_items(api, items, materials(api), TEXTURE_NAMES),
            lights(api))
