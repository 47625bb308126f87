"""Scene assembly: render items, instancing, layers, and the static
flattened draw buffers that feed the device.

Replaces the reference's RenderItem / RenderLayer / instance-buffer model
(CRYCHIC.h:23-54, FrameResource.h:7-15,
CRYCHIC.cpp:2274-2436 scene construction). The D3D12 design uploads one
InstanceData buffer per item per frame and issues one DrawIndexedInstanced
per item; the TPU design pre-flattens every (item, instance) pair into
struct-of-arrays draw buffers once (static shapes!), and per-frame work is
pure device math: transform vertices, mask culled instances, rasterize.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from . import geometry as gg
from .materials import Material, MaterialBank
from ..utils import mathutil as mu

# Render layers (reference: RenderLayer enum, CRYCHIC.h:44-54).
LAYER_OPAQUE = "opaque"
LAYER_OPAQUE_SHADOW = "opaque_shadow"  # shadow-caster duplicates, never culled
LAYER_ALPHA_TESTED = "alpha_tested"  # RenderLayer::AlphaTested (CRYCHIC.h:47)
LAYER_DEBUG = "debug"
LAYER_SKY = "sky"


@dataclasses.dataclass
class RenderItem:
    name: str
    mesh: gg.MeshData
    layer: str
    worlds: np.ndarray  # (I, 4, 4) per-instance world transforms
    tex_transforms: np.ndarray  # (I, 4, 4)
    material_indices: np.ndarray  # (I,) int32
    cullable: bool = True  # items in the shadow layer bypass culling

    @property
    def num_instances(self) -> int:
        return self.worlds.shape[0]


def make_item(name, mesh, layer, worlds=None, tex_transforms=None,
              material_indices=0, cullable=True) -> RenderItem:
    if worlds is None:
        worlds = mu.identity4()[None]
    worlds = np.asarray(worlds, np.float32)
    if worlds.ndim == 2:
        worlds = worlds[None]
    n = worlds.shape[0]
    if tex_transforms is None:
        tex_transforms = np.broadcast_to(mu.identity4(), (n, 4, 4)).copy()
    tex_transforms = np.asarray(tex_transforms, np.float32)
    if tex_transforms.ndim == 2:
        tex_transforms = np.broadcast_to(tex_transforms, (n, 4, 4)).copy()
    material_indices = np.broadcast_to(
        np.asarray(material_indices, np.int32), (n,)
    ).copy()
    return RenderItem(name, mesh, layer, worlds, tex_transforms,
                      material_indices, cullable)


@dataclasses.dataclass
class DrawBuffers:
    """Flattened device-ready geometry for one layer.

    positions: (V, 3) local-space vertices (all instances concatenated)
    normals/tangents: (V, 3); uvs: (V, 2)
    vertex_instance: (V,) int32 — flat instance id per vertex
    indices: (3*T,) int32 into the flat vertex buffer
    worlds / tex_transforms: (D, 4, 4) per flat instance
    material_indices: (D,) int32
    instance_item: (D,) int32 — owning item, for culling masks
    cullable: (D,) bool
    bounds_center/extents: (D, 3) local-space AABB per instance
    """

    positions: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    uvs: np.ndarray
    vertex_instance: np.ndarray
    indices: np.ndarray
    worlds: np.ndarray
    tex_transforms: np.ndarray
    material_indices: np.ndarray
    instance_item: np.ndarray
    cullable: np.ndarray
    bounds_center: np.ndarray
    bounds_extents: np.ndarray

    @property
    def num_vertices(self):
        return self.positions.shape[0]

    @property
    def num_triangles(self):
        return self.indices.shape[0] // 3

    @property
    def num_instances(self):
        return self.worlds.shape[0]


def flatten_items(items) -> DrawBuffers:
    """Expand (item, instance) pairs into flat static draw buffers.

    Vertices are duplicated per instance — the TPU trade: HBM is cheap,
    gathers are not, and duplicated vertices turn per-instance transform
    into one dense batched multiply-add (ops.shading.rowmat).
    """
    pos, nrm, tan, uv, vinst, idx = [], [], [], [], [], []
    worlds, texs, mats, item_ids, cullable, bc, be = [], [], [], [], [], [], []
    v_off = 0
    inst_id = 0
    for item_i, item in enumerate(items):
        m = item.mesh
        c, e = m.aabb()
        for k in range(item.num_instances):
            pos.append(m.positions)
            nrm.append(m.normals)
            tan.append(m.tangents)
            uv.append(m.uvs)
            vinst.append(np.full(m.num_vertices, inst_id, np.int32))
            idx.append(m.indices + v_off)
            worlds.append(item.worlds[k])
            texs.append(item.tex_transforms[k])
            mats.append(item.material_indices[k])
            item_ids.append(item_i)
            cullable.append(item.cullable)
            bc.append(c)
            be.append(e)
            v_off += m.num_vertices
            inst_id += 1
    return DrawBuffers(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        tangents=np.concatenate(tan).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        vertex_instance=np.concatenate(vinst),
        indices=np.concatenate(idx).astype(np.int32),
        worlds=np.stack(worlds).astype(np.float32),
        tex_transforms=np.stack(texs).astype(np.float32),
        material_indices=np.array(mats, np.int32),
        instance_item=np.array(item_ids, np.int32),
        cullable=np.array(cullable, bool),
        bounds_center=np.stack(bc).astype(np.float32),
        bounds_extents=np.stack(be).astype(np.float32),
    )


@dataclasses.dataclass
class Scene:
    items: list
    materials: list
    material_bank: MaterialBank
    opaque: DrawBuffers  # main-view geometry (Opaque layer)
    shadow: DrawBuffers  # shadow-caster geometry (OpaqueShadow layer)
    texture_names: list = None  # slot -> texture file stem
    frustum_culling: bool = True
    # AlphaTested layer (clip(a - 0.1) in both the main view and the
    # shadow passes); None when the scene has no alpha-tested items
    alpha: DrawBuffers = None


def _box_grid_instances(material_mod: int):
    """100 boxes, 10x10 grid, scale 1.6 (CRYCHIC.cpp:2338-2347)."""
    worlds, mats = [], []
    for i in range(10):
        for j in range(10):
            worlds.append(
                mu.scaling(1.6, 1.6, 1.6)
                @ mu.translation((-5 + i) * 5.0, 0.8, (-5 + j) * 5.0)
            )
            mats.append(i % material_mod)
    return np.stack(worlds), np.array(mats, np.int32)


def build_cascade_scene(materials=None) -> Scene:
    """The ACTIVE reference scene (BuildCascadeShadowRenderItems +
    ...WithShadow, CRYCHIC.cpp:2274-2436): sky sphere, debug quad, 100
    instanced boxes (materials alternate bricks/tile by row), ground grid
    (skullMat); shadow casters duplicate boxes (i%3 materials) + grid.
    """
    from .materials import build_reference_materials

    if materials is None:
        materials = build_reference_materials()
    box = gg.create_box(1.0, 1.0, 1.0, 3)
    grid = gg.create_grid(20.0, 30.0, 60, 40)
    sphere = gg.create_sphere(0.5, 20, 20)
    quad = gg.create_quad(0.0, 0.0, 1.0, 1.0, 0.0)

    box_worlds, box_mats = _box_grid_instances(2)
    shadow_worlds, shadow_mats = _box_grid_instances(3)
    grid_world = mu.scaling(3.0, 3.0, 3.0)

    items = [
        make_item("sky", sphere, LAYER_SKY, mu.scaling(5000, 5000, 5000),
                  material_indices=4),
        make_item("debug_quad", quad, LAYER_DEBUG, material_indices=0),
        make_item("boxes", box, LAYER_OPAQUE, box_worlds,
                  material_indices=box_mats),
        make_item("grid", grid, LAYER_OPAQUE, grid_world,
                  material_indices=3),
        make_item("boxes_shadow", box, LAYER_OPAQUE_SHADOW, shadow_worlds,
                  material_indices=shadow_mats, cullable=False),
        make_item("grid_shadow", grid, LAYER_OPAQUE_SHADOW, grid_world,
                  material_indices=1, cullable=False),
    ]
    opaque = flatten_items([i for i in items if i.layer == LAYER_OPAQUE])
    shadow = flatten_items([i for i in items if i.layer == LAYER_OPAQUE_SHADOW])
    return Scene(
        items=items,
        materials=materials,
        material_bank=MaterialBank.from_materials(materials),
        opaque=opaque,
        shadow=shadow,
        texture_names=[
            "bricks2", "bricks2_nmap", "tile", "tile_nmap",
            "white1x1", "default_nmap", "sky_cube", "default_nmap",
            "white1x1", "white1x1",
        ],
    )


def cull_mask(draw: DrawBuffers, cam_frustum_planes_fn) -> np.ndarray:
    """Per-instance visibility mask (host-side reference implementation).

    ``cam_frustum_planes_fn(world)`` returns the 6 frustum planes expressed
    in the instance's local space. Replicates CRYCHIC::UpdateInstanceData
    (CRYCHIC.cpp:515-557): non-cullable instances always pass.
    """
    from .camera import frustum_aabb_intersects

    vis = np.ones(draw.num_instances, dtype=bool)
    for d in range(draw.num_instances):
        if not draw.cullable[d]:
            continue
        planes = cam_frustum_planes_fn(draw.worlds[d])
        vis[d] = frustum_aabb_intersects(
            planes, draw.bounds_center[d][None], draw.bounds_extents[d][None]
        )[0]
    return vis
