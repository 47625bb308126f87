"""BASELINE config 5's scene (skull + car + instanced boxes + grid + the
BoltAnim box), frozen from the port's
``models/scenes_baseline.config5_full_scene``: the meshes load from
``models_dir`` (skull.txt, car.txt) through the frozen mesh loader, and
every item has its shadow-caster duplicate.
"""
from __future__ import annotations

import os

import numpy as np

from ..reference.io.mesh_txt import load_mesh_txt
from ..reference.models import geometry as gg
from ..reference.utils import mathutil as mu
from .cascade import box_grid_instances, lights, scene_from_items

TEXTURE_NAMES = ["bricks2", "bricks2_nmap", "tile", "tile_nmap",
                 "white1x1", "default_nmap", "sky_cube", "default_nmap",
                 "bolt_anim", "fire_anim"]


def materials(api):
    M = api.Material
    return [
        M("bricks0", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.3),
        M("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2), 0.7),
        M("mirror0", 2, 4, 5, (0, 0, 0, 1), (0.98, 0.97, 0.95), 0.1),
        M("skullMat", 3, 4, 5, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        M("sky", 4, 6, 7, (1, 1, 1, 1), (0.1, 0.1, 0.1), 1.0),
        M("carMat", 5, 4, 5, (0.8, 0.2, 0.2, 1), (0.4, 0.4, 0.4), 0.4),
        M("bolt", 6, 8, 5, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.5),
    ]


def build(api, models_dir):
    box = gg.create_box(1.0, 1.0, 1.0, 3)
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    skull = load_mesh_txt(os.path.join(models_dir, "skull.txt"))
    car = load_mesh_txt(os.path.join(models_dir, "car.txt"))
    bolt_box = gg.create_box(2.0, 2.0, 2.0, 0)
    box_worlds, box_mats = box_grid_instances(2)
    skull_world = mu.scaling(0.5, 0.5, 0.5) @ mu.translation(0.0, 1.8, 2.0)
    car_world = (mu.scaling(0.8, 0.8, 0.8) @ mu.rotation_y(np.pi / 4)
                 @ mu.translation(-4.0, 1.2, 2.0))
    grid_world = mu.scaling(3, 3, 3)
    items = [
        api.make_item("boxes", box, api.LAYER_OPAQUE, box_worlds,
                      material_indices=box_mats),
        api.make_item("grid", grid, api.LAYER_OPAQUE, grid_world,
                      material_indices=1),
        api.make_item("skull", skull, api.LAYER_OPAQUE, skull_world,
                      material_indices=3),
        api.make_item("car", car, api.LAYER_OPAQUE, car_world,
                      material_indices=5),
        api.make_item("bolt_box", bolt_box, api.LAYER_OPAQUE,
                      mu.translation(5.0, 1.0, -2.0), material_indices=6),
        api.make_item("boxes_shadow", box, api.LAYER_OPAQUE_SHADOW,
                      box_worlds, material_indices=box_mats, cullable=False),
        api.make_item("grid_shadow", grid, api.LAYER_OPAQUE_SHADOW,
                      grid_world, material_indices=1, cullable=False),
        api.make_item("skull_shadow", skull, api.LAYER_OPAQUE_SHADOW,
                      skull_world, material_indices=3, cullable=False),
        api.make_item("car_shadow", car, api.LAYER_OPAQUE_SHADOW,
                      car_world, material_indices=5, cullable=False),
    ]
    return (scene_from_items(api, items, materials(api), TEXTURE_NAMES),
            lights(api))
