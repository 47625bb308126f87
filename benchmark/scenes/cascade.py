"""BASELINE config 4's scene: the reference's active cascade-shadow scene
(BuildCascadeShadowRenderItems + ...WithShadow, CRYCHIC.cpp:2274-2436),
frozen from the port's ``models/scene.build_cascade_scene``: 100
instanced boxes (materials alternate bricks / tile by row), a ground grid,
and the shadow casters (the boxes with i % 3 materials, and the grid),
81,402 triangles in all; the sky sphere and the debug quad are not drawn.
"""
from __future__ import annotations

import numpy as np

from ..reference.models import geometry as gg
from ..reference.utils import mathutil as mu

TEXTURE_NAMES = ["bricks2", "bricks2_nmap", "tile", "tile_nmap",
                 "white1x1", "default_nmap", "sky_cube", "default_nmap",
                 "white1x1", "white1x1"]
# The light rig (CRYCHIC.cpp:858-864, CRYCHIC.h:173-177).
LIGHT_DIRECTIONS = np.array([[0.57735, -0.57735, 0.57735],
                             [-0.57735, -0.57735, 0.57735],
                             [0.0, -0.707, -0.707]], np.float32)
LIGHT_STRENGTHS = ((2.4, 2.4, 2.5), (0.1, 0.1, 0.1), (0.0, 0.0, 0.0))
AMBIENT = (0.4, 0.4, 0.6, 1.0)


def materials(api):
    """The 5 scene materials (CRYCHIC::BuildMaterials, CRYCHIC.cpp:1768)."""
    return [
        api.Material("bricks0", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.3),
        api.Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2),
                     0.7),
        api.Material("mirror0", 2, 4, 5, (0.0, 0.0, 0.0, 1),
                     (0.98, 0.97, 0.95), 0.1),
        api.Material("skullMat", 3, 4, 5, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        api.Material("sky", 4, 6, 7, (1, 1, 1, 1), (0.1, 0.1, 0.1), 1.0),
    ]


def lights(api):
    out = api.Lights.empty(ambient=AMBIENT)
    out.direction[0:3] = LIGHT_DIRECTIONS
    for i, s in enumerate(LIGHT_STRENGTHS):
        out.strength[i] = s
    out.num_dir = 3
    return out


def box_grid_instances(material_mod: int):
    """100 boxes, 10x10 grid, scale 1.6 (CRYCHIC.cpp:2338-2347)."""
    worlds, mats = [], []
    for i in range(10):
        for j in range(10):
            worlds.append(mu.scaling(1.6, 1.6, 1.6)
                          @ mu.translation((-5 + i) * 5.0, 0.8,
                                           (-5 + j) * 5.0))
            mats.append(i % material_mod)
    return np.stack(worlds), np.array(mats, np.int32)


def scene_from_items(api, items, mats, texture_names):
    """The Scene of the items: the opaque layer, the shadow layer (the
    opaque items where no shadow duplicates are given)."""
    opaque = [i for i in items if i.layer == api.LAYER_OPAQUE]
    shadow = ([i for i in items if i.layer == api.LAYER_OPAQUE_SHADOW]
              or opaque)
    return api.Scene(items=items, materials=mats,
                     material_bank=api.MaterialBank.from_materials(mats),
                     opaque=api.flatten_items(opaque),
                     shadow=api.flatten_items(shadow),
                     texture_names=texture_names)


def build(api, models_dir=None):
    box = gg.create_box(1.0, 1.0, 1.0, 3)
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    sphere = gg.create_sphere(0.5, 20, 20)
    quad = gg.create_quad(0.0, 0.0, 1.0, 1.0, 0.0)
    box_worlds, box_mats = box_grid_instances(2)
    shadow_worlds, shadow_mats = box_grid_instances(3)
    grid_world = mu.scaling(3.0, 3.0, 3.0)
    items = [
        api.make_item("sky", sphere, api.LAYER_SKY,
                      mu.scaling(5000, 5000, 5000), material_indices=4),
        api.make_item("debug_quad", quad, api.LAYER_DEBUG,
                      material_indices=0),
        api.make_item("boxes", box, api.LAYER_OPAQUE, box_worlds,
                      material_indices=box_mats),
        api.make_item("grid", grid, api.LAYER_OPAQUE, grid_world,
                      material_indices=3),
        api.make_item("boxes_shadow", box, api.LAYER_OPAQUE_SHADOW,
                      shadow_worlds, material_indices=shadow_mats,
                      cullable=False),
        api.make_item("grid_shadow", grid, api.LAYER_OPAQUE_SHADOW,
                      grid_world, material_indices=1, cullable=False),
    ]
    return (scene_from_items(api, items, materials(api), TEXTURE_NAMES),
            lights(api))
