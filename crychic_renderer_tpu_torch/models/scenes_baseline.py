"""The five graded benchmark scenes from BASELINE.json.

| # | Scene |
|---|-------|
| 1 | Single WoodCrate01 textured box, forward, 1 dir light, 800x600   |
| 2 | skull.txt mesh, forward Blinn-Phong, 3 lights, 1080p             |
| 3 | Deferred: skull+grid, 16 point lights (Blinn-Phong path so the   |
|   | point lights actually contribute; the reference's PBRShading     |
|   | drops them — PBR.hlsl:122)                                       |
| 4 | Shadow pipeline: active cascade scene, 2048^2 maps, PCF,          |
|   | half-res SSAO composite, 1080p                                   |
| 5 | Full scene: car + skull + boxes + grid, PBR, sky cubemap,         |
|   | shadows, SSAO, animated BoltAnim/FireAnim textures, 1080p        |

Asset references: Models/skull.txt + Models/car.txt loaders
(CRYCHIC.cpp:1447), WoodCrate01.dds, BoltAnim/FireAnim BMP frames.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import geometry as gg
from .materials import Material, MaterialBank, Lights, build_reference_lights
from .scene import (LAYER_OPAQUE, LAYER_OPAQUE_SHADOW, LAYER_ALPHA_TESTED,
                    Scene, make_item, flatten_items, _box_grid_instances)
from ..config import RenderConfig
from ..utils import mathutil as mu

# The reference repository's checkout, with its Models/ and Textures/: the
# JAX package's absolute location for it, the same on every host.
REFERENCE_DIR = os.path.join(os.sep, "root", "reference")
REF_MODELS = os.path.join(REFERENCE_DIR, "Models")


def _scene_from_items(items, materials, texture_names):
    opaque = flatten_items([i for i in items if i.layer == LAYER_OPAQUE])
    shadow_items = [i for i in items if i.layer == LAYER_OPAQUE_SHADOW]
    if not shadow_items:
        shadow_items = [i for i in items if i.layer == LAYER_OPAQUE]
    shadow = flatten_items(shadow_items)
    alpha_items = [i for i in items if i.layer == LAYER_ALPHA_TESTED]
    alpha = flatten_items(alpha_items) if alpha_items else None
    return Scene(items=items, materials=materials,
                 material_bank=MaterialBank.from_materials(materials),
                 opaque=opaque, shadow=shadow, alpha=alpha,
                 texture_names=texture_names)


def config1_woodcrate():
    """Forward-lit textured crate (the book's 'Crate' demo shape)."""
    mats = [
        Material("crate", 0, 0, 1, (1, 1, 1, 1), (0.05, 0.05, 0.05), 0.25),
    ]
    box = gg.create_box(1.0, 1.0, 1.0, 0)
    items = [
        make_item("crate", box, LAYER_OPAQUE,
                  mu.rotation_y(0.5) @ mu.translation(0.0, 0.5, 0.0),
                  material_indices=0),
    ]
    lights = Lights.empty(ambient=(0.25, 0.25, 0.35, 1.0))
    lights.direction[0] = (0.57735, -0.57735, 0.57735)
    lights.strength[0] = (1.0, 1.0, 0.9)
    lights.num_dir = 1
    scene = _scene_from_items(items, mats, [
        "WoodCrate01", "default_nmap", "white1x1", "default_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "white1x1", "white1x1"])
    cfg = RenderConfig(width=800, height=600, deferred=False,
                       shadows_enabled=False, ssao_enabled=False,
                       sky_enabled=True, num_dir_lights=1,
                       pair_capacity=1 << 14, bin_cap=128,
                       shadow_pair_capacity=1 << 12, shadow_bin_cap=128)
    return scene, cfg, lights


def _skull_mesh():
    from ..io.mesh_txt import load_mesh_txt

    return load_mesh_txt(os.path.join(REF_MODELS, "skull.txt"))


def _car_mesh():
    from ..io.mesh_txt import load_mesh_txt

    return load_mesh_txt(os.path.join(REF_MODELS, "car.txt"))


def config2_skull_forward():
    """Skull, forward Blinn-Phong, the 3-light rig, 1080p."""
    mats = [
        Material("skullMat", 0, 0, 1, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2), 0.7),
    ]
    skull = _skull_mesh()
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    items = [
        make_item("skull", skull, LAYER_OPAQUE,
                  mu.scaling(0.4, 0.4, 0.4) @ mu.translation(0.0, 1.0, 0.0),
                  material_indices=0),
        make_item("grid", grid, LAYER_OPAQUE, mu.scaling(2, 2, 2),
                  material_indices=1),
    ]
    lights = build_reference_lights()
    scene = _scene_from_items(items, mats, [
        "white1x1", "default_nmap", "tile", "tile_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "white1x1", "white1x1"])
    cfg = RenderConfig(width=1920, height=1080, deferred=False,
                       shadows_enabled=False, ssao_enabled=False,
                       use_pbr=False, num_dir_lights=3,
                       pair_capacity=1 << 19, bin_cap=1024)
    return scene, cfg, lights


def point_light_rig() -> Lights:
    """Config 3's light rig: 16 point lights on a ring of radius 8 at
    heights 2-4, seeded colours, falloff 1-12."""
    lights = Lights.empty(ambient=(0.15, 0.15, 0.2, 1.0))
    rng = np.random.default_rng(7)
    for i in range(16):
        ang = 2 * np.pi * i / 16
        lights.position[i] = (8.0 * np.cos(ang), 2.0 + (i % 3),
                              8.0 * np.sin(ang))
        col = 0.5 + 0.5 * rng.random(3)
        lights.strength[i] = tuple(col)
        lights.falloff_start[i] = 1.0
        lights.falloff_end[i] = 12.0
    lights.num_dir = 0
    return lights


def config3_rig_on_config4():
    """Config 3's settings (deferred Blinn-Phong, 16 point lights, no
    shadows or SSAO) and its light rig on config 4's cascade scene: the
    point-light path on geometry that builds without Models/skull.txt."""
    scene, cfg, _ = config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, deferred=True, use_pbr=False,
                              shadows_enabled=False, ssao_enabled=False,
                              num_dir_lights=0, num_point_lights=16)
    return scene, cfg, point_light_rig()


def config3_deferred_pointlights():
    """Deferred skull+grid with 16 point lights (Blinn-Phong evaluators)."""
    mats = [
        Material("skullMat", 0, 0, 1, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2), 0.7),
    ]
    skull = _skull_mesh()
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    items = [
        make_item("skull", skull, LAYER_OPAQUE,
                  mu.scaling(0.4, 0.4, 0.4) @ mu.translation(0.0, 1.0, 0.0),
                  material_indices=0),
        make_item("grid", grid, LAYER_OPAQUE, mu.scaling(2, 2, 2),
                  material_indices=1),
    ]
    lights = point_light_rig()
    scene = _scene_from_items(items, mats, [
        "white1x1", "default_nmap", "tile", "tile_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "white1x1", "white1x1"])
    cfg = RenderConfig(width=1920, height=1080, deferred=True,
                       shadows_enabled=False, ssao_enabled=False,
                       use_pbr=False, num_dir_lights=0, num_point_lights=16,
                       pair_capacity=1 << 19, bin_cap=1024)
    return scene, cfg, lights


def config4_shadow_pipeline():
    """The active cascade-shadow scene with 2048^2 maps + PCF + SSAO."""
    from .scene import build_cascade_scene

    scene = build_cascade_scene()
    # capacities sized from measured pair counts (raster_stats): main view
    # ~40k pairs, shadow atlas (4 cascades in one raster) ~300k
    cfg = RenderConfig(width=1920, height=1080, shadow_map_size=2048,
                       deferred=True, shadows_enabled=True,
                       ssao_enabled=True, use_pbr=True, num_dir_lights=3,
                       pair_capacity=1 << 17, bin_cap=1024,
                       shadow_pair_capacity=1 << 19, shadow_bin_cap=1024)
    return scene, cfg, build_reference_lights()


def config5_full_scene(anim_frame: int = 0):
    """Everything: skull + car + instanced boxes + grid, PBR, sky,
    shadows, SSAO, animated texture slots."""
    mats = [
        Material("bricks0", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.3),
        Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2), 0.7),
        Material("mirror0", 2, 4, 5, (0, 0, 0, 1), (0.98, 0.97, 0.95), 0.1),
        Material("skullMat", 3, 4, 5, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        Material("sky", 4, 6, 7, (1, 1, 1, 1), (0.1, 0.1, 0.1), 1.0),
        Material("carMat", 5, 4, 5, (0.8, 0.2, 0.2, 1), (0.4, 0.4, 0.4), 0.4),
        Material("bolt", 6, 8, 5, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.5),
    ]
    box = gg.create_box(1.0, 1.0, 1.0, 3)
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    skull = _skull_mesh()
    car = _car_mesh()
    bolt_box = gg.create_box(2.0, 2.0, 2.0, 0)

    box_worlds, box_mats = _box_grid_instances(2)
    items = [
        make_item("boxes", box, LAYER_OPAQUE, box_worlds,
                  material_indices=box_mats),
        make_item("grid", grid, LAYER_OPAQUE, mu.scaling(3, 3, 3),
                  material_indices=1),
        make_item("skull", skull, LAYER_OPAQUE,
                  mu.scaling(0.5, 0.5, 0.5) @ mu.translation(0.0, 1.8, 2.0),
                  material_indices=3),
        make_item("car", car, LAYER_OPAQUE,
                  mu.scaling(0.8, 0.8, 0.8) @ mu.rotation_y(np.pi / 4)
                  @ mu.translation(-4.0, 1.2, 2.0),
                  material_indices=5),
        make_item("bolt_box", bolt_box, LAYER_OPAQUE,
                  mu.translation(5.0, 1.0, -2.0), material_indices=6),
        # shadow casters (never culled, like the OpaqueShadow layer)
        make_item("boxes_shadow", box, LAYER_OPAQUE_SHADOW, box_worlds,
                  material_indices=box_mats, cullable=False),
        make_item("grid_shadow", grid, LAYER_OPAQUE_SHADOW,
                  mu.scaling(3, 3, 3), material_indices=1, cullable=False),
        make_item("skull_shadow", skull, LAYER_OPAQUE_SHADOW,
                  mu.scaling(0.5, 0.5, 0.5) @ mu.translation(0.0, 1.8, 2.0),
                  material_indices=3, cullable=False),
        make_item("car_shadow", car, LAYER_OPAQUE_SHADOW,
                  mu.scaling(0.8, 0.8, 0.8) @ mu.rotation_y(np.pi / 4)
                  @ mu.translation(-4.0, 1.2, 2.0),
                  material_indices=5, cullable=False),
    ]
    scene = _scene_from_items(items, mats, [
        "bricks2", "bricks2_nmap", "tile", "tile_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "bolt_anim", "fire_anim"])
    # measured (raster_stats): main 89k pairs incl. clip products,
    # shadow atlas 344k
    cfg = RenderConfig(width=1920, height=1080, shadow_map_size=2048,
                       deferred=True, shadows_enabled=True,
                       ssao_enabled=True, use_pbr=True, num_dir_lights=3,
                       pair_capacity=1 << 18, bin_cap=2048,
                       shadow_pair_capacity=1 << 19, shadow_bin_cap=1024)
    return scene, cfg, build_reference_lights()


def fence_scene(alpha_test: bool = True):
    """AlphaTested-layer demo: a WireFence box over a tiled floor (the
    book's 'Blend/Crate with WireFence' setup; exercises the ALPHA_TEST
    shader variants of Default.hlsl and Shadows.hlsl — holes in both the
    main view and the cast shadow). With alpha_test=False the fence
    renders as an opaque box (for A/B tests)."""
    mats = [
        Material("fence", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.25),
        Material("floor", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2),
                 0.7),
    ]
    box = gg.create_box(6.0, 6.0, 6.0, 0)
    grid = gg.create_grid(30.0, 30.0, 40, 40)
    fence_layer = LAYER_ALPHA_TESTED if alpha_test else LAYER_OPAQUE
    # two fences in a row: through a front hole the SECOND fence's bars
    # are only recovered by the second depth peel
    fence_worlds = np.stack([mu.translation(0.0, 3.0, 0.0),
                             mu.translation(0.0, 3.0, 6.0)])
    items = [
        make_item("fence", box, fence_layer, fence_worlds,
                  material_indices=0),
        make_item("floor", grid, LAYER_OPAQUE, material_indices=1),
        make_item("floor_shadow", grid, LAYER_OPAQUE_SHADOW,
                  material_indices=1, cullable=False),
    ] + ([make_item("fence_shadow", box, LAYER_OPAQUE_SHADOW,
                    fence_worlds, material_indices=0,
                    cullable=False)] if not alpha_test else [])
    lights = Lights.empty(ambient=(0.3, 0.3, 0.35, 1.0))
    # light travels -x/-z: the fence shadow falls toward the camera
    lights.direction[0] = (-0.4103, -0.8165, -0.4061)
    lights.strength[0] = (0.9, 0.9, 0.8)
    lights.num_dir = 1
    scene = _scene_from_items(items, mats, [
        "WireFence", "default_nmap", "tile", "tile_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "white1x1", "white1x1"])
    cfg = RenderConfig(width=480, height=270, deferred=True,
                       shadows_enabled=True, ssao_enabled=False,
                       num_dir_lights=1, shadow_map_size=512,
                       alpha_test_enabled=alpha_test,
                       alpha_shadow_window=256,
                       pair_capacity=1 << 16,
                       shadow_pair_capacity=1 << 16)
    return scene, cfg, lights


def wire_fence_chain(seed: int = 0, size: int = 64) -> list:
    """A synthetic stand-in for WireFence.dds: a (size, size) RGBA8 wire
    grid (bars 5 texels wide every 16, alpha 255; holes alpha 0, a seeded
    tenth of the hole texels opaque too) with random bar colours, and its
    box-filtered mip chain. The fence scene's alpha test needs holes; the
    white 1x1 that stands in for a missing asset passes every clip.
    Returns the chain as a list of (h, w, 4) uint8 levels."""
    from ..io.dds import generate_mips

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:size, :size]
    bar = (x % 16 < 5) | (y % 16 < 5) | (rng.random((size, size)) < 0.1)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = rng.integers(96, 256, (size, size, 3))
    img[..., 3] = np.where(bar, 255, 0)
    return generate_mips(img)


CONFIGS = {
    1: config1_woodcrate,
    2: config2_skull_forward,
    3: config3_deferred_pointlights,
    4: config4_shadow_pipeline,
    5: config5_full_scene,
}
