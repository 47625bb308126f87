"""Materials, lights and the material bank.

Mirrors the reference's data model: ``Material`` host struct
(Common/d3dUtil.h:240-265) uploaded as ``MaterialData``
(FrameResource.h:17-27), and the ``Light`` struct
(Shaders/LightingUtil.hlsl:9-17, MaxLights=16).

Reference quirk replicated on purpose: the host Material has no Metalness
field and UpdateMaterialBuffer never writes it, so every material reaches
the shader with the GPU-struct default Metalness = 0.5 (SURVEY.md §0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_LIGHTS = 16
DEFAULT_METALNESS = 0.5  # FrameResource.h:25 default, never overwritten


@dataclasses.dataclass
class Material:
    name: str
    mat_cb_index: int
    diffuse_map_index: int
    normal_map_index: int
    diffuse_albedo: tuple
    fresnel_r0: tuple
    roughness: float
    mat_transform: np.ndarray = None
    metalness: float = DEFAULT_METALNESS

    def __post_init__(self):
        if self.mat_transform is None:
            self.mat_transform = np.eye(4, dtype=np.float32)


@dataclasses.dataclass
class MaterialBank:
    """Struct-of-arrays material table, ready to ship to the device."""

    diffuse_albedo: np.ndarray  # (M, 4)
    fresnel_r0: np.ndarray  # (M, 3)
    roughness: np.ndarray  # (M,)
    metalness: np.ndarray  # (M,)
    mat_transform: np.ndarray  # (M, 4, 4)
    diffuse_map_index: np.ndarray  # (M,) int32
    normal_map_index: np.ndarray  # (M,) int32

    @staticmethod
    def from_materials(mats) -> "MaterialBank":
        mats = sorted(mats, key=lambda m: m.mat_cb_index)
        return MaterialBank(
            diffuse_albedo=np.array([m.diffuse_albedo for m in mats], np.float32),
            fresnel_r0=np.array([m.fresnel_r0 for m in mats], np.float32),
            roughness=np.array([m.roughness for m in mats], np.float32),
            metalness=np.array([m.metalness for m in mats], np.float32),
            mat_transform=np.stack([m.mat_transform for m in mats]).astype(np.float32),
            diffuse_map_index=np.array([m.diffuse_map_index for m in mats], np.int32),
            normal_map_index=np.array([m.normal_map_index for m in mats], np.int32),
        )


def build_reference_materials():
    """The 5 scene materials (CRYCHIC::BuildMaterials, CRYCHIC.cpp:1768-1821)."""
    return [
        Material("bricks0", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.3),
        Material("tile0", 1, 2, 3, (0.9, 0.9, 0.9, 1), (0.2, 0.2, 0.2), 0.7),
        Material("mirror0", 2, 4, 5, (0.0, 0.0, 0.0, 1), (0.98, 0.97, 0.95), 0.1),
        Material("skullMat", 3, 4, 5, (1, 1, 1, 1), (0.6, 0.6, 0.6), 0.8),
        Material("sky", 4, 6, 7, (1, 1, 1, 1), (0.1, 0.1, 0.1), 1.0),
    ]


@dataclasses.dataclass
class Lights:
    """Fixed-size (MAX_LIGHTS) light table + ambient.

    Layout matches LightingUtil.hlsl: [dir lights | point lights | spot
    lights]; counts are static shader configuration, not data.
    """

    strength: np.ndarray  # (16, 3)
    direction: np.ndarray  # (16, 3)
    position: np.ndarray  # (16, 3)
    falloff_start: np.ndarray  # (16,)
    falloff_end: np.ndarray  # (16,)
    spot_power: np.ndarray  # (16,)
    ambient: np.ndarray  # (4,)
    num_dir: int = 1
    num_point: int = 0
    num_spot: int = 0

    @staticmethod
    def empty(ambient=(0.0, 0.0, 0.0, 1.0)) -> "Lights":
        z = np.zeros((MAX_LIGHTS, 3), np.float32)
        return Lights(
            strength=z.copy(), direction=z.copy(), position=z.copy(),
            falloff_start=np.zeros(MAX_LIGHTS, np.float32),
            falloff_end=np.zeros(MAX_LIGHTS, np.float32),
            spot_power=np.zeros(MAX_LIGHTS, np.float32),
            ambient=np.array(ambient, np.float32),
            num_dir=0,
        )


# The active scene's light rig (CRYCHIC.cpp:858-864 + CRYCHIC.h:173-177).
BASE_LIGHT_DIRECTIONS = np.array(
    [
        [0.57735, -0.57735, 0.57735],
        [-0.57735, -0.57735, 0.57735],
        [0.0, -0.707, -0.707],
    ],
    dtype=np.float32,
)


def build_reference_lights(light_rotation_angle: float = 0.0) -> Lights:
    from ..utils import mathutil as mu

    lights = Lights.empty(ambient=(0.4, 0.4, 0.6, 1.0))
    R = mu.rotation_y(light_rotation_angle)
    dirs = mu.transform_normal(BASE_LIGHT_DIRECTIONS, R)
    lights.direction[0:3] = dirs
    lights.strength[0] = (2.4, 2.4, 2.5)
    lights.strength[1] = (0.1, 0.1, 0.1)
    lights.strength[2] = (0.0, 0.0, 0.0)
    lights.num_dir = 3
    return lights
