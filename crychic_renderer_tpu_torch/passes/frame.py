"""The frame pipeline (torch counterpart of
``crychic_renderer_tpu.passes.frame``).

The D3D12 command-list model of CRYCHIC::Draw (CRYCHIC.cpp:172-436)
becomes one function on tensors::

    render_frame(scene_device, frame_consts, cfg) -> (H, W, 4) image

with every render target an intermediate tensor, in the pass order of the
reference's deferred branch:

    [1] 4x cascade shadow depth renders       (one atlas raster launch)
    [2] normal/depth                          (one visibility buffer ...
    [4] G-buffer                               ... feeds both)
    [3] SSAO occlusion (half-res) + 3x blur
    [5] deferred PBR lighting + cascade PCF + ambient*SSAO + sky

The port renders every RenderConfig setting of the JAX package's
``render_frame``: the deferred and the forward path (``cfg.deferred``;
the forward path takes the shininess from the normal map's alpha, lets
the cascade blend use its PCF factor as is, and draws the ShadowDebug
quad), PBR or Blinn-Phong lighting (``cfg.use_pbr``; Blinn-Phong
evaluates directional, point and spot lights), the alpha-tested layer
(``cfg.alpha_test_enabled``: a dense depth peel merged into the
visibility buffer and punched into the shadow maps) and the render
options (fast preset, soft PCF disk, trilinear and other anisotropy
settings, single-mip pool, cubemap sky, debug views). With
``cfg.use_pallas`` (the default) both raster launches go through
``ops.raster``; with it False the frame takes the JAX package's pure-XLA
path, the binned tensor raster of ``ops.rasterizer`` on 32-row tiles
truncated at ``bin_cap``, per cascade for the shadow maps. The soft PCF
goes through ``ops.pcf``, the G-buffer resolve through ``ops.resolve``,
the alpha layer's depth peel through ``ops.alpha_peel``, SSAO through
``ops.ssao_kernel`` and the light loops through ``ops.light_kernel``
(CUDA kernels on the card, their plain PyTorch versions on the CPU); the
rest is tensor code. A draw without static corner tables
(``strip_draw_statics``, or a scene built without
``attach_draw_statics``) renders through the per-vertex stage
(``vertex_stage``, ``build_tri_attrs``) with the same records. With
``cfg.shade_tile_capacity`` and ``cfg.ssao_tile_capacity`` set (the
Renderer sizes both) the resolve, the SSAO occlusion and the cascade PCF
factor are tile-compacted as in the JAX package: their per-pixel work
runs only for the screen tiles that need it, and the other tiles take the
values their pixels provably have (``_compact``). The JAX package's
dead-pixel gather spreads only move gather indices and are left out. The
resolve, alpha merge, lighting and overlay passes also render a row band
of the screen at global rows (``row_offset``), for the band-sharded frame
of ``parallel/sharded.py``, which stays dense.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RenderConfig
from ..ops import (alpha_peel, clipping, light_kernel, raster, resolve,
                   sampling, shading, shadows)
from ..ops import rasterizer as rz
from ..ops import ssao as ssao_ops
from ..ops import ssao_kernel
from ..ops.consts import device_constant

# ---------------------------------------------------------------------------
# Device-side containers
# ---------------------------------------------------------------------------

def _tensor(x, device):
    """numpy / tensor / scalar -> tensor on `device` (None stays None).
    uint32 arrays (the RGBA8 pools) are reinterpreted as int32 bits."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:  # e.g. views of another framework's buffers
        a = a.copy()
    return torch.from_numpy(a).to(device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A per-frame host array on `device` without waiting for the stream:
    to a CUDA device through a fresh pinned buffer and an asynchronous
    copy. The buffer comes from torch's caching host allocator, which
    hands it out again only after the copy has run, so a frame still
    queued never reads the next frame's data."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _fields_to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: (getattr(obj, f.name).to(device)
                 if hasattr(getattr(obj, f.name), "to")
                 else getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class DeviceDraw:
    """Flattened draw buffers on device (see models.scene.DrawBuffers),
    plus the frame-constant per-corner tables (attach_draw_statics)."""

    positions: torch.Tensor  # (V, 3)
    normals: torch.Tensor
    tangents: torch.Tensor
    uvs: torch.Tensor
    vertex_instance: torch.Tensor  # (V,) int32
    indices: torch.Tensor  # (3T,) int32
    worlds: torch.Tensor  # (D, 4, 4)
    tex_transforms: torch.Tensor  # (D, 4, 4)
    material_indices: torch.Tensor  # (D,) int32
    tri_posw_h: torch.Tensor = None  # (T, 3, 4) world pos, homogeneous
    tri_instance: torch.Tensor = None  # (T,) int32 instance per triangle
    tri_rest: torch.Tensor = None  # (T, 3, 12) [posW3|nrm3|tan3|uv2|mat1]

    @staticmethod
    def from_host(d, device) -> "DeviceDraw":
        """From a models.scene.DrawBuffers (host numpy), on `device`."""
        return DeviceDraw.from_numpy(vars(d), device)

    @staticmethod
    def from_numpy(d: dict, device) -> "DeviceDraw":
        """From a mapping of field name -> numpy array (missing static
        tables are None), on `device`."""
        return DeviceDraw(**{f.name: _tensor(d.get(f.name), device)
                             for f in dataclasses.fields(DeviceDraw)})

    def to(self, device) -> "DeviceDraw":
        return _fields_to(self, device)


@dataclasses.dataclass
class DeviceScene:
    opaque: DeviceDraw
    shadow: DeviceDraw
    # material bank
    mat_albedo: torch.Tensor  # (M, 4)
    mat_fresnel: torch.Tensor  # (M, 3)
    mat_roughness: torch.Tensor  # (M,)
    mat_metalness: torch.Tensor  # (M,)
    mat_transform: torch.Tensor  # (M, 4, 4)
    mat_pair: torch.Tensor  # (M,) int32 — (diffuse, normal) pair in the pool
    # textures (two-class analytic PAIR pool; see ops.sampling.PairPool)
    pair_data: torch.Tensor  # (rows, 16) int32 (uint32 RGBA8 bits)
    cubemap: torch.Tensor  # (6, S, S, 4) int32 quad-packed
    # lights
    light_strength: torch.Tensor  # (16, 3)
    light_direction: torch.Tensor
    light_position: torch.Tensor
    light_falloff_start: torch.Tensor
    light_falloff_end: torch.Tensor
    light_spot_power: torch.Tensor
    ambient: torch.Tensor  # (4,)
    # ssao setup
    ssao_offsets: torch.Tensor  # (14, 3)
    ssao_random_field: torch.Tensor  # (h, w, 3)
    ssao_blur_weights: torch.Tensor  # (11,)
    alpha: DeviceDraw = None  # AlphaTested layer (None when absent)
    n_big_pairs: int = 0  # count of big-class pairs in the pool

    @property
    def pair_pool(self) -> sampling.PairPool:
        return sampling.PairPool(
            self.pair_data, self.n_big_pairs,
            dual=self.pair_data.shape[-1] == sampling.PAIR_ROW_DUAL)

    @staticmethod
    def from_numpy(d: dict, device,
                   attach_statics: bool = True) -> "DeviceScene":
        """From a mapping of field name -> numpy array, with the draws
        (opaque, shadow, alpha) as nested mappings and n_big_pairs an int,
        on `device`. Draws without static tables get them attached here
        unless attach_statics is False (they then render through the
        per-vertex path, as in the JAX package)."""
        kw = {}
        for f in dataclasses.fields(DeviceScene):
            v = d.get(f.name)
            if f.name in ("opaque", "shadow", "alpha"):
                kw[f.name] = (None if v is None
                              else DeviceDraw.from_numpy(v, device))
            elif f.name == "n_big_pairs":
                kw[f.name] = int(v)
            else:
                kw[f.name] = _tensor(v, device)
        scene = DeviceScene(**kw)
        return attach_draw_statics(scene) if attach_statics else scene

    def to(self, device) -> "DeviceScene":
        return _fields_to(self, device)


@dataclasses.dataclass
class FrameConstants:
    """Per-frame uniforms (the reference's PassConstants,
    FrameResource.h:29-51, minus what's derivable). All float32."""

    view: torch.Tensor  # (4, 4)
    proj: torch.Tensor
    view_proj: torch.Tensor
    inv_proj: torch.Tensor
    eye_pos: torch.Tensor  # (3,)
    cascade_view_projs: torch.Tensor  # (4, 4, 4) light-space VPs
    shadow_transforms: torch.Tensor  # (4, 4, 4) world -> shadow uv/z
    opaque_visibility: torch.Tensor  # (D_opaque,) f32 1/0 cull mask
    shadow_visibility: torch.Tensor  # (D_shadow,) f32
    alpha_visibility: torch.Tensor = None  # (D_alpha,) f32
    total_time: torch.Tensor = 0.0

    @staticmethod
    def from_numpy(d: dict, device) -> "FrameConstants":
        """From a mapping of field name -> numpy array / float, on `device`,
        in ONE
        host-to-device copy: the leaves are packed into one float32 vector
        (pinned when the target is a CUDA device, so the copy is
        asynchronous and never waits for the frame in flight) and split
        again on the device."""
        names = [f.name for f in dataclasses.fields(FrameConstants)
                 if d.get(f.name) is not None]
        arrays = [np.asarray(d[n], np.float32) for n in names]
        flat = upload(np.concatenate([a.ravel() for a in arrays]), device)
        out, o = {}, 0
        for n, a in zip(names, arrays):
            out[n] = flat[o:o + a.size].reshape(a.shape)
            o += a.size
        return FrameConstants(**out)

    def to(self, device) -> "FrameConstants":
        return _fields_to(self, device)


class _LightsView:
    """DeviceScene light tensors with the static counts of the config."""

    def __init__(self, scene: DeviceScene, cfg: RenderConfig):
        self.strength = scene.light_strength
        self.direction = scene.light_direction
        self.position = scene.light_position
        self.falloff_start = scene.light_falloff_start
        self.falloff_end = scene.light_falloff_end
        self.spot_power = scene.light_spot_power
        self.num_dir = cfg.num_dir_lights
        self.num_point = cfg.num_point_lights
        self.num_spot = cfg.num_spot_lights


# ---------------------------------------------------------------------------
# Vertex stage (static per-corner tables + the per-frame projection)
# ---------------------------------------------------------------------------

def _homogeneous(p: torch.Tensor, w: float) -> torch.Tensor:
    """(..., k) -> (..., k + 1) with w appended."""
    return torch.cat([p, torch.full_like(p[..., :1], w)], dim=-1)


def _vertex_uv(draw: DeviceDraw, mat_transform: torch.Tensor):
    """Per-vertex final uv: (u, v, 0, 1) @ TexTransform @ MatTransform
    (Default.hlsl:69-70)."""
    vi = draw.vertex_instance.long()
    uvh = torch.cat([draw.uvs, torch.zeros_like(draw.uvs[..., :1]),
                     torch.ones_like(draw.uvs[..., :1])], dim=-1)
    M = mat_transform[draw.material_indices.long()[vi]]
    return shading.rowmat(shading.rowmat(uvh, draw.tex_transforms[vi]),
                          M)[:, :2]


def vertex_stage(draw: DeviceDraw, visibility: torch.Tensor,
                 view_proj: torch.Tensor, mat_transform: torch.Tensor):
    """All instances' vertices -> world space + clip space + final uvs:
    the VS of Default.hlsl/GeometryPass.hlsl:22-42 for every (item,
    instance) pair at once, the path of a draw without static tables.
    Culled instances get clip w = 0, which the rasterizer's near-plane
    test discards. Returns (pos_w, nrm_w, tan_w, uv, clip) per vertex."""
    vi = draw.vertex_instance.long()
    W = draw.worlds[vi]  # (V, 4, 4)
    pos_w = shading.rowmat(_homogeneous(draw.positions, 1.0), W)[:, :3]
    nrm_w = shading.rowmat(draw.normals, W[:, :3, :3])
    tan_w = shading.rowmat(draw.tangents, W[:, :3, :3])
    clip = shading.rowmat(_homogeneous(pos_w, 1.0), view_proj)
    clip = clip * visibility[vi][:, None]
    return pos_w, nrm_w, tan_w, _vertex_uv(draw, mat_transform), clip


def vertex_records(draw: DeviceDraw, pos_w, nrm_w, tan_w, uv, clip):
    """Per-VERTEX records (V, 16): [clip4 | posW3 | nrm3 | tan3 | uv2 |
    mat1], the quantities near-plane clipping interpolates and the
    resolve reads."""
    mat = draw.material_indices.long()[draw.vertex_instance.long()]
    return torch.cat([clip, pos_w, nrm_w, tan_w, uv,
                      mat.to(torch.float32)[:, None]], dim=-1)


def build_tri_attrs(draw: DeviceDraw, pos_w, nrm_w, tan_w, uv, clip):
    """Per-triangle vertex records (T, 3, 16): vertex_records gathered to
    triangles (3 row gathers per triangle; parallel.sharded splits this
    gather by triangle ranges)."""
    vrec = vertex_records(draw, pos_w, nrm_w, tan_w, uv, clip)
    return vrec[draw.indices.long().reshape(-1, 3)]


def _world_positions(draw: DeviceDraw) -> torch.Tensor:
    """(V, 4) homogeneous world positions: each vertex by its instance's
    world transform."""
    return shading.rowmat(_homogeneous(draw.positions, 1.0),
                          draw.worlds[draw.vertex_instance.long()])


def _culled_world_positions(draw: DeviceDraw,
                            visibility: torch.Tensor) -> torch.Tensor:
    """_world_positions with culled instances' vertices zeroed."""
    vis = visibility[draw.vertex_instance.long()]
    return _world_positions(draw) * vis[:, None]


def shadow_clip(draw: DeviceDraw, visibility: torch.Tensor,
                cascade_vp: torch.Tensor):
    """Per-vertex world positions of shadow casters projected by one
    cascade's view-projection, culled instances zeroed."""
    vis = visibility[draw.vertex_instance.long()]
    return shading.rowmat(_world_positions(draw), cascade_vp) * vis[:, None]


def draw_with_statics(draw: DeviceDraw,
                      mat_transform: torch.Tensor = None) -> DeviceDraw:
    """Precompute the frame-constant per-corner tables: world-space
    positions (and, given mat_transform, the rest of the main-layer
    vertex record) gathered to triangles. worlds, tex_transforms and
    mat_transform never change after scene build, so per frame only the
    camera projection and the visibility multiply remain."""
    vi = draw.vertex_instance.long()
    W = draw.worlds[vi]
    ph = torch.cat([draw.positions, torch.ones_like(draw.positions[..., :1])],
                   dim=-1)
    pos_w4 = shading.rowmat(ph, W)  # (V, 4) — w column kept (shadow path)
    tri_idx = draw.indices.long().reshape(-1, 3)
    rest = None
    if mat_transform is not None:
        nrm_w = shading.rowmat(draw.normals, W[:, :3, :3])
        tan_w = shading.rowmat(draw.tangents, W[:, :3, :3])
        uvh = torch.cat([draw.uvs, torch.zeros_like(draw.uvs[..., :1]),
                         torch.ones_like(draw.uvs[..., :1])], dim=-1)
        mat_v = draw.material_indices.long()[vi]
        T = draw.tex_transforms[vi]
        M = mat_transform[mat_v]
        uv = shading.rowmat(shading.rowmat(uvh, T), M)[:, :2]
        mat = mat_v.to(torch.float32)
        rest = torch.cat([pos_w4[:, :3], nrm_w, tan_w, uv, mat[:, None]],
                         dim=-1)[tri_idx]
    return dataclasses.replace(
        draw, tri_posw_h=pos_w4[tri_idx],
        tri_instance=draw.vertex_instance[tri_idx[:, 0]], tri_rest=rest)


def attach_draw_statics(scene: DeviceScene) -> DeviceScene:
    """Fill every draw's static corner tables (scene build time); draws
    that already carry them are kept as they are."""
    def attach(draw, mt):
        if draw is None or draw.tri_posw_h is not None:
            return draw
        return draw_with_statics(draw, mt)

    return dataclasses.replace(
        scene,
        opaque=attach(scene.opaque, scene.mat_transform),
        shadow=attach(scene.shadow, None),
        alpha=attach(scene.alpha, scene.mat_transform))


def strip_draw_statics(scene: DeviceScene) -> DeviceScene:
    """The scene with every draw's static corner tables taken off: its
    frames run the per-vertex path (vertex_stage, build_tri_attrs), the
    path of a JAX DeviceScene built without attach_draw_statics, and
    equal the frames with the tables."""
    def strip(draw):
        if draw is None:
            return None
        return dataclasses.replace(draw, tri_posw_h=None, tri_instance=None,
                                   tri_rest=None)

    return dataclasses.replace(scene, opaque=strip(scene.opaque),
                               shadow=strip(scene.shadow),
                               alpha=strip(scene.alpha))


def tri_attrs(draw: DeviceDraw, visibility: torch.Tensor,
              view_proj: torch.Tensor, mat_transform: torch.Tensor):
    """Per-triangle vertex records (T, 3, 16) for one main-layer draw:
    [clip4 | posW3 | nrm3 | tan3 | uv2 | mat1].

    With the static tables attached: a dense (T,3,4)@(4,4) clip
    projection, the per-triangle visibility multiply, a concat. Without
    them: the per-vertex vertex_stage and the corner gather, which give
    the same records bit for bit (rowmat is per row, so it commutes with
    the gather, and a triangle's corners share one instance)."""
    if draw.tri_rest is None:
        return build_tri_attrs(draw, *vertex_stage(
            draw, visibility, view_proj, mat_transform))
    poswh = torch.cat([draw.tri_posw_h[..., :3],
                       torch.ones_like(draw.tri_posw_h[..., :1])], dim=-1)
    clip = shading.rowmat(poswh, view_proj)
    clip = clip * visibility[draw.tri_instance.long()][:, None, None]
    return torch.cat([clip, draw.tri_rest], dim=-1)


def shadow_tri_world(draw: DeviceDraw, visibility: torch.Tensor):
    """Per-triangle world-space homogeneous vertices (T, 3, 4), culled
    instances zeroed; shared by all cascades. With the static tables
    only the visibility multiply runs per frame; without them the world
    transform runs per vertex and the corners are gathered."""
    if draw.tri_posw_h is not None:
        return (draw.tri_posw_h
                * visibility[draw.tri_instance.long()][:, None, None])
    pos_w = _culled_world_positions(draw, visibility)
    return pos_w[draw.indices.long().reshape(-1, 3)]  # (T, 3, 4)


def _view_tris(draw: DeviceDraw, visibility: torch.Tensor,
               mat_transform: torch.Tensor, consts: FrameConstants,
               cfg: RenderConfig):
    """Vertex stage + near clip + screen setup of one main-layer draw."""
    tri_attr = tri_attrs(draw, visibility, consts.view_proj, mat_transform)
    tri_attr, tri_valid = clipping.clip_near(
        tri_attr, torch.ones(tri_attr.shape[0], dtype=torch.bool,
                             device=tri_attr.device))
    tris = rz.setup_tri_verts(tri_attr[..., :4], tri_valid,
                              cfg.width, cfg.height)
    return tris, tri_attr


def main_view_tris(scene: DeviceScene, consts: FrameConstants,
                   cfg: RenderConfig):
    """Vertex stage + near clip + screen setup for the main view."""
    return _view_tris(scene.opaque, consts.opaque_visibility,
                      scene.mat_transform, consts, cfg)


# ---------------------------------------------------------------------------
# Shadow pass
# ---------------------------------------------------------------------------

def _shadow_bias(tris: rz.ScreenTris) -> rz.ScreenTris:
    """Shadow PSO depth bias (CRYCHIC.cpp:1601-1603): 10000 UNORM24 steps +
    slope-scaled 2.0, from the triangle's depth-plane slopes."""
    A, B, C, area2, _ = rz._edge_coeffs(tris.xy)
    inv_a2 = 1.0 / torch.where(area2 == 0, torch.ones_like(area2), area2)
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    max_slope = torch.maximum(torch.abs(zA), torch.abs(zB))
    bias = 10000.0 / (1 << 24) + 2.0 * max_slope
    return tris._replace(z=torch.clamp(tris.z + bias[:, None], 0.0, 1.0))


def shadow_atlas_tris(scene: DeviceScene, shadow_visibility,
                      vps: torch.Tensor, cfg: RenderConfig, tri_world=None):
    """Screen-space triangle setup for the (S, k*S) cascade atlas: every
    cascade's projected triangles, xy shifted into its atlas column, with
    the shadow PSO depth bias applied. Returns (tris, xrange) where xrange
    is the per-triangle column guard — a triangle extending past its
    cascade's viewport must not rasterize into the neighbor's column."""
    S = cfg.shadow_map_size
    k = vps.shape[0]
    if tri_world is None:
        tri_world = shadow_tri_world(scene.shadow, shadow_visibility)
    # each cascade's column offset (c * S, 0), made on the device: a
    # tensor of host data would wait for the stream
    dev = tri_world.device
    shifts = torch.stack(
        [torch.arange(k, dtype=torch.float32, device=dev) * S,
         torch.zeros(k, dtype=torch.float32, device=dev)], dim=-1)
    parts = []
    for c in range(k):
        t = rz.setup_tri_verts(shading.rowmat(tri_world, vps[c]), None, S, S)
        parts.append(t._replace(xy=t.xy + shifts[c]))
    tris = rz.ScreenTris(*(torch.cat(f) for f in zip(*parts)))
    tris = _shadow_bias(tris)
    T1 = tris.xy.shape[0] // k
    col = torch.repeat_interleave(
        torch.arange(k, dtype=torch.float32, device=tris.xy.device), T1)
    return tris, (col * S, (col + 1) * S)


def render_shadow_atlas(scene: DeviceScene, shadow_visibility,
                        vps: torch.Tensor, cfg: RenderConfig,
                        stats: dict = None,
                        occupancy: dict = None) -> torch.Tensor:
    """The cascades rasterized in ONE launch into a horizontal (S, k*S)
    atlas, then split to (k, S, S). The D3D12 reference records k
    sequential depth passes (DrawSceneToShadowMap, CRYCHIC.cpp:2479).
    stats (optional dict) receives "shadow_overflowed"; occupancy
    (optional dict) "pairs", the atlas binning's pairs (raster.rasterize)."""
    S = cfg.shadow_map_size
    k = vps.shape[0]
    tris, xrange = shadow_atlas_tris(scene, shadow_visibility, vps, cfg)
    depth, _, overflowed = raster.rasterize(
        tris, k * S, S, cfg.shadow_pair_capacity, with_ids=False,
        xrange=xrange, occupancy=occupancy)
    if stats is not None:
        stats["shadow_overflowed"] = overflowed
    return torch.stack([depth[:, c * S:(c + 1) * S] for c in range(k)])


def render_one_shadow_map(scene: DeviceScene, shadow_visibility, vp,
                          cfg: RenderConfig, tri_world=None,
                          stats: dict = None,
                          occupancy: dict = None) -> torch.Tensor:
    """One cascade's depth-only render in its own S x S viewport -> (S, S)
    f32, with the shadow PSO's depth bias (_shadow_bias): the raster
    kernel's launch with cfg.use_pallas, else the pure-tensor binned
    raster at cfg.shadow_bin_cap. stats (optional dict) receives
    "shadow_overflowed" and, on the pure-tensor path,
    "shadow_bin_overflowed" (0-d bool tensors); occupancy (optional
    dict) "pairs", the binning's pairs."""
    S = cfg.shadow_map_size
    if tri_world is None:
        tri_world = shadow_tri_world(scene.shadow, shadow_visibility)
    tris = _shadow_bias(rz.setup_tri_verts(shading.rowmat(tri_world, vp),
                                           None, S, S))
    stats = {} if stats is None else stats
    if cfg.use_pallas:
        depth, _, stats["shadow_overflowed"] = raster.rasterize(
            tris, S, S, cfg.shadow_pair_capacity, with_ids=False,
            occupancy=occupancy)
    else:
        depth, _, stats["shadow_overflowed"], \
            stats["shadow_bin_overflowed"] = rz.binned_raster(
                tris, S, S, cfg.shadow_pair_capacity, cfg.shadow_bin_cap,
                with_ids=False, occupancy=occupancy)
    return depth


def render_shadow_maps(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, stats: dict = None,
                       occupancy: dict = None) -> torch.Tensor:
    """The cascades' depth-only renders -> (C, S, S) f32: with
    cfg.use_pallas the atlas's one raster launch (render_shadow_atlas),
    else each cascade in its own viewport through the pure-tensor raster
    (render_one_shadow_map), the world-space table shared. stats
    (optional dict) receives the flags OR-ed over the cascades;
    occupancy (optional dict) "shadow_pairs", the pairs binned, summed
    over the cascades (what shadow_pair_capacity bounds)."""
    vps = consts.cascade_view_projs
    # each raster's "pairs", with occupancy only
    pairs = [None if occupancy is None else {}
             for _ in range(1 if cfg.use_pallas else vps.shape[0])]
    if cfg.use_pallas:
        maps = render_shadow_atlas(scene, consts.shadow_visibility, vps,
                                   cfg, stats, pairs[0])
    else:
        tri_world = shadow_tri_world(scene.shadow, consts.shadow_visibility)
        flags = [{} for _ in pairs]
        maps = [render_one_shadow_map(scene, consts.shadow_visibility,
                                      vps[c], cfg, tri_world, flags[c],
                                      pairs[c])
                for c in range(vps.shape[0])]
        if stats is not None:
            for k in flags[0]:
                stats[k] = torch.stack([f[k] for f in flags]).any()
        maps = torch.stack(maps)
    if occupancy is not None:
        occupancy["shadow_pairs"] = (
            pairs[0]["pairs"] if len(pairs) == 1
            else torch.stack([p["pairs"] for p in pairs]).sum())
    return maps


# ---------------------------------------------------------------------------
# Geometry / attribute interpolation (the visibility-buffer resolve)
# ---------------------------------------------------------------------------

def _mat_select(table: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Per-pixel material attribute lookup as one-hot selects over the
    tiny (<= 16 row) material table; a mat outside the table selects 0."""
    expand = table.dim() > 1
    out = None
    for m in range(table.shape[0]):
        sel = mat == m
        if expand:
            sel = sel[..., None]
        term = torch.where(sel, table[m], torch.zeros_like(table[m]))
        out = term if out is None else out + term
    return out


def _build_resolve_records(tris: rz.ScreenTris, tri_attr: torch.Tensor,
                           width: int = 43):
    """The per-TRIANGLE resolve record table (T, 43): screen xy + 1/w + 3
    vertices' attrs + material in ONE row, so a pixel pays one gather.
    A larger width pads each row with zeros (K7 reads rows of
    ops.resolve.RECORD_FLOATS as float4)."""
    a = tri_attr[:, :, 4:]  # (T, 3, 12): posW3 nrm3 tan3 uv2 mat1
    cols = [
        tris.xy.reshape(-1, 6), tris.inv_w,             # 0:9
        a[:, 0, 0:3], a[:, 1, 0:3], a[:, 2, 0:3],       # 9:18 posW
        a[:, 0, 3:6], a[:, 1, 3:6], a[:, 2, 3:6],       # 18:27 nrm
        a[:, 0, 6:9], a[:, 1, 6:9], a[:, 2, 6:9],       # 27:36 tan
        a[:, 0, 9:11], a[:, 1, 9:11], a[:, 2, 9:11],    # 36:42 uv
        a[:, 0, 11:12],                                 # 42 material
    ]
    if width > 43:
        cols.append(torch.zeros_like(a[:, 0, :1]).expand(-1, width - 43))
    return torch.cat(cols, dim=-1)


def _resolve_core(scene: DeviceScene, consts: FrameConstants,
                  cfg: RenderConfig, rec, tid, px, py):
    """The per-pixel resolve: record gather -> perspective barycentric
    interpolation -> per-primitive uv derivatives -> texture sampling
    (anisotropic, reference-quality or trilinear, by cfg.anisotropy and
    cfg.aniso_probes) -> G-buffer planes."""
    valid = tid >= 0
    r = rec[torch.where(valid, tid, torch.zeros_like(tid)).long()]

    xy = r[..., :6].reshape(r.shape[:-1] + (3, 2))
    inv_w = r[..., 6:9]

    def weights_at(px_, py_):
        w = rz.barycentrics_at(xy, px_, py_) * inv_w
        den = w.sum(-1, keepdim=True)
        # sign-preserving guard: extrapolated barycentrics can sum
        # NEGATIVE; clamping to +1e-20 would flip the sign and explode uv
        tiny = torch.full_like(den, 1e-20)
        return w / torch.where(torch.abs(den) < 1e-20, tiny, den)

    wgt = weights_at(px, py)
    w0, w1, w2 = wgt[..., 0:1], wgt[..., 1:2], wgt[..., 2:3]

    def lerp3(base, width):
        return (w0 * r[..., base:base + width]
                + w1 * r[..., base + width:base + 2 * width]
                + w2 * r[..., base + 2 * width:base + 3 * width])

    pix_pos_w = lerp3(9, 3)
    pix_nrm_w = lerp3(18, 3)
    pix_tan_w = lerp3(27, 3)
    pix_uv = lerp3(36, 2)
    mat = r[..., 42].long()

    pool = scene.pair_pool
    pairidx = _mat_select(scene.mat_pair, mat).long()

    # Per-PRIMITIVE uv derivatives: evaluate this pixel's triangle at
    # (x+1, y) and (x, y+1) and difference (never mixes triangles)
    def uv_at(px_, py_):
        w = weights_at(px_, py_)
        return (w[..., 0:1] * r[..., 36:38] + w[..., 1:2] * r[..., 38:40]
                + w[..., 2:3] * r[..., 40:42])

    duv_x = uv_at(px + 1.0, py) - pix_uv
    duv_y = uv_at(px, py + 1.0) - pix_uv
    # Uncovered (sky) pixels' extrapolated record-0 uv is replaced by a
    # compact in-texture window for the SAMPLER INPUT only; their samples
    # are discarded below, and the substitute keeps them finite.
    dead3 = ~valid[..., None]
    ix = px.to(torch.int32)
    iy = py.to(torch.int32)
    uv_dead = torch.stack([((ix % 32).to(torch.float32) + 0.5) / 512.0,
                           ((iy % 32).to(torch.float32) + 0.5) / 512.0],
                          dim=-1)
    samp_uv = torch.where(dead3, uv_dead, pix_uv)
    zero2 = torch.zeros_like(duv_x)
    duv_x = torch.where(dead3, zero2, duv_x)
    duv_y = torch.where(dead3, zero2, duv_y)
    if cfg.anisotropy > 1:
        if cfg.aniso_probes == 0:
            # reference-quality evaluation (max_aniso exact-trilinear
            # probes), the yardstick the probe schedules are measured by
            diffuse_sample, normal_sample = sampling.sample_pair_aniso_ref(
                pool, pairidx, samp_uv, duv_x, duv_y, cfg.anisotropy)
        else:
            diffuse_sample, normal_sample = sampling.sample_pair_aniso(
                pool, pairidx, samp_uv, duv_x, duv_y, cfg.anisotropy,
                probes=cfg.aniso_probes)
    else:
        lod_uv = sampling.lod_from_derivatives(duv_x, duv_y)
        diffuse_sample, normal_sample = sampling.sample_pair_trilinear(
            pool, pairidx, samp_uv, lod_uv)

    albedo = _mat_select(scene.mat_albedo, mat) * diffuse_sample
    unit_n = shading.normalize(pix_nrm_w)
    bumped_n = shading.normal_sample_to_world(
        normal_sample[..., :3], unit_n, pix_tan_w)

    # DrawNormals.hlsl:91: view-space normal from the UNBUMPED vertex normal
    normal_v = shading.rowmat(unit_n, consts.view[:3, :3])

    # Uncovered pixels carry the reference's render-target CLEAR values:
    # view-space normal (0,0,1) (CRYCHIC.cpp:2525), black G-buffer
    # (CRYCHIC.cpp:2554)
    v1 = valid[..., None]
    sky_n_v = torch.cat([torch.zeros_like(normal_v[..., :2]),
                         torch.ones_like(normal_v[..., 2:])], dim=-1)

    def keep(x):
        return torch.where(v1, x, torch.zeros_like(x))

    return dict(
        pos_w=keep(pix_pos_w),
        normal_w=keep(bumped_n),
        normal_v=torch.where(v1, normal_v, sky_n_v),
        albedo=keep(albedo),
        roughness=keep(_mat_select(scene.mat_roughness, mat)[..., None]),
        metalness=keep(_mat_select(scene.mat_metalness, mat)[..., None]),
        shininess_alpha=keep(normal_sample[..., 3:4]),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Tile compaction (the JAX package's _resolve_compacted,
# _ssao_occlusion_compacted and _pcf_factor_compacted)
# ---------------------------------------------------------------------------

# Compacted shade tiles: the raster kernel's (8, 128) tile.
SHADE_TILE_H = 8
SHADE_TILE_W = 128
# Compacted SSAO tiles, in half-res pixels. SSAO needs the exact
# occlusion at every half-res pixel within 16 px (L-inf) of a covered one:
# 3 blur passes x radius 5 per axis, + 1 for the full-res bilinear
# upsample. The JAX package measured (8, 32) tiles at 58% occupancy on
# config 5 against 65% for (8, 128) tiles, whose dilation over-includes.
SSAO_TILE_H = 8
SSAO_TILE_W = 32
_SSAO_DILATE_TILES = (2, 1)  # tile radii (16 / 8, ceil(16 / 32)) >= 16 px

# G-buffer clear values per plane (the reference's RTV clears, see
# _resolve_core): the compacted resolve fills the skipped tiles with them.
_G_CLEAR = dict(pos_w=(0.0, 0.0, 0.0), normal_w=(0.0, 0.0, 0.0),
                normal_v=(0.0, 0.0, 1.0), albedo=(0.0,) * 4,
                roughness=(0.0,), metalness=(0.0,),
                shininess_alpha=(0.0,))


def _tiles(a: torch.Tensor, tile_h: int, tile_w: int, pad_value):
    """(H, W) or (H, W, C) map -> ((NT, tile_h * tile_w, C) row-major
    tiles of the map padded to whole tiles with pad_value, nty, ntx)."""
    a = a[..., None] if a.dim() == 2 else a
    H, W, C = a.shape
    nty, ntx = -(-H // tile_h), -(-W // tile_w)
    a = F.pad(a, (0, 0, 0, ntx * tile_w - W, 0, nty * tile_h - H),
              value=pad_value)
    t = a.reshape(nty, tile_h, ntx, tile_w, C).permute(0, 2, 1, 3, 4)
    return t.reshape(nty * ntx, tile_h * tile_w, C), nty, ntx


def _untile(t: torch.Tensor, nty: int, ntx: int, tile_h: int, tile_w: int,
            H: int, W: int) -> torch.Tensor:
    """_tiles' inverse: (NT, tile_h * tile_w, C) -> (H, W, C)."""
    C = t.shape[-1]
    t = t.reshape(nty, ntx, tile_h, tile_w, C).permute(0, 2, 1, 3, 4)
    return t.reshape(nty * tile_h, ntx * tile_w, C)[:H, :W]


def _compact(tv: torch.Tensor, capacity: int):
    """The slot tables of a compacted pass, built on the device with no
    host read (a fixed-size buffer, a cumsum and one scatter).

    tv: (NT,) bool, the tiles the pass must evaluate; capacity: CB, the
    slots (capped at NT). Returns (kept, inv, over, needed):
    - kept (CB,) int64: slot -> tile, in tile order; unused slots hold NT,
      the row the caller appends to its tile table as the sentinel;
    - inv (NT,) int64: tile -> slot; CB, the row the caller appends to
      the slots' results as the fill, for the tiles not evaluated, those
      past the capacity included (the JAX package's drop);
    - over: 0-d bool, more tiles than slots (Renderer.check_overflow);
    - needed: 0-d int64, the tiles to evaluate (a view of the running
      count, no kernel of its own)."""
    NT = tv.shape[0]
    CB = min(int(capacity), NT)
    dev = tv.device
    running = torch.cumsum(tv.to(torch.int64), 0)
    pos = running - 1
    # slot CB of the buffer takes every dropped write and is cut off
    slot = torch.clamp(torch.where(tv, pos, CB), max=CB)
    kept = torch.full((CB + 1,), NT, dtype=torch.int64, device=dev)
    kept.scatter_(0, slot, torch.arange(NT, dtype=torch.int64, device=dev))
    inv = torch.where(tv & (pos < CB), pos, CB)
    return kept[:CB], inv, pos[-1] >= CB, running[-1]


def _slot_pixels(kept: torch.Tensor, nty: int, ntx: int, tile_h: int,
                 tile_w: int):
    """(x, y) int64 pixel coordinates of every slot's lanes, (CB, tile_h *
    tile_w) each. The sentinel tile NT takes row nty - 1's coordinates
    (the JAX package clamps them the same way), so its pixels stay on
    the padded grid."""
    lane = torch.arange(tile_h * tile_w, device=kept.device)[None, :]
    x = (kept[:, None] % ntx) * tile_w + lane % tile_w
    y = (torch.clamp(kept[:, None] // ntx, max=nty - 1) * tile_h
         + lane // tile_w)
    return x, y


def _resolve_compacted(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, rec, tid, row_offset: int = 0,
                       occupancy: dict = None):
    """Tile-compacted resolve: _resolve_core runs only on the (8, 128)
    tiles that hold a covered pixel, cfg.shade_tile_capacity slots of
    them; the other tiles take the clear values (_G_CLEAR), which the
    dense resolve gives every uncovered pixel. The same math on the same
    values, so the G-buffer equals the dense one. Expanded back with one
    gather of the packed 16 channels and one transpose.
    Returns (g, over) (see _compact); occupancy (optional dict) receives
    "shade_tiles", _compact's needed."""
    H, W = tid.shape
    TH, TW = SHADE_TILE_H, SHADE_TILE_W
    tiles, nty, ntx = _tiles(tid, TH, TW, -1)
    tiles = tiles[..., 0]  # (NT, LANES)
    kept, inv, over, needed = _compact((tiles >= 0).any(dim=1),
                                       cfg.shade_tile_capacity)
    tid_c = torch.cat([tiles, torch.full_like(tiles[:1], -1)])[kept]
    x, y = _slot_pixels(kept, nty, ntx, TH, TW)
    px = x.to(torch.float32) + 0.5
    py = y.to(torch.float32) + row_offset + 0.5
    g = _resolve_core(scene, consts, cfg, rec, tid_c, px, py)

    packed = torch.cat([g[n] for n in _G_CLEAR], dim=-1)  # (CB, LANES, 16)
    fill = device_constant(tuple(v for n in _G_CLEAR for v in _G_CLEAR[n]),
                           packed.dtype, packed.device)
    packed = torch.cat([packed, fill.expand(1, TH * TW, -1)])
    out = _untile(packed[inv], nty, ntx, TH, TW, H, W)
    full, o = {}, 0
    for n in _G_CLEAR:
        k = g[n].shape[-1]
        full[n] = out[..., o:o + k]
        o += k
    full["valid"] = tid >= 0
    if occupancy is not None:
        occupancy["shade_tiles"] = needed
    return full, over


def resolve_gbuffer(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig, tris: rz.ScreenTris,
                    depth: torch.Tensor, tid: torch.Tensor,
                    tri_attr: torch.Tensor, row_offset: int = 0,
                    out_rows: int = None, stats: dict = None,
                    occupancy: dict = None):
    """Gather the winning triangle's vertex data per pixel and build the
    G-buffer (GeometryPass.hlsl PS + GBuffer.hlsl encode, fused with the
    DrawNormals.hlsl view-space-normal output).

    Returns dict with pos_w (H,W,3), normal_w bumped (H,W,3), normal_v
    view (H,W,3), albedo (H,W,4), roughness, metalness (H,W,1), valid
    (H,W). Uncovered pixels carry the render targets' clear values.

    cfg.shade_tile_capacity selects the tile-compacted resolve
    (_resolve_compacted, the same G-buffer); stats (optional dict) then
    receives "shade_tiles_overflowed", a 0-d bool tensor, and occupancy
    (optional dict) "shade_tiles", the tiles with a covered pixel (0-d
    int64), what shade_tile_capacity bounds.

    Band rendering (parallel.sharded, always dense): depth/tid are rows
    starting at global pixel row ``row_offset`` (barycentrics are
    evaluated there, so band pixels equal the full frame's), and
    ``out_rows`` trims the halo row the band carries below itself off
    every output. The uv derivatives are per-primitive, so the halo row
    changes no pixel.

    CUDA tensors go through the kernel K7 (ops/resolve.py), which writes
    the same G-buffer bit for bit; the planes are then views into its
    (rows, W, 16) buffer, which the dict also holds as "buffer" (what K10
    reads, direct_light). CPU tensors take resolve_gbuffer_plain."""
    if not tid.is_cuda:
        return resolve_gbuffer_plain(scene, consts, cfg, tris, depth, tid,
                                     tri_attr, row_offset, out_rows, stats,
                                     occupancy)
    tid = tid.contiguous()  # the pure-tensor raster's is a cropped view
    H, W = tid.shape
    rows = H if out_rows is None else out_rows
    rec = _build_resolve_records(tris, tri_attr, resolve.RECORD_FLOATS)
    inv, capacity = None, 0
    if cfg.shade_tile_capacity:
        tiles, _, _ = _tiles(tid, SHADE_TILE_H, SHADE_TILE_W, -1)
        _, inv, over, needed = _compact((tiles[..., 0] >= 0).any(dim=1),
                                        cfg.shade_tile_capacity)
        capacity = min(int(cfg.shade_tile_capacity), inv.shape[0])
        if stats is not None:
            stats["shade_tiles_overflowed"] = over
        if occupancy is not None:
            occupancy["shade_tiles"] = needed
    out = resolve.resolve(
        rec, tid, rows, row_offset, inv, capacity, scene.pair_data,
        scene.n_big_pairs, scene.mat_albedo, scene.mat_roughness,
        scene.mat_metalness, scene.mat_pair, consts.view, cfg.anisotropy,
        cfg.aniso_probes)
    g, o = {}, 0
    for n, clear in _G_CLEAR.items():
        g[n] = out[..., o:o + len(clear)]
        o += len(clear)
    g["valid"] = tid[:rows] >= 0
    g["buffer"] = out
    return g


def resolve_gbuffer_plain(scene: DeviceScene, consts: FrameConstants,
                          cfg: RenderConfig, tris: rz.ScreenTris,
                          depth: torch.Tensor, tid: torch.Tensor,
                          tri_attr: torch.Tensor, row_offset: int = 0,
                          out_rows: int = None, stats: dict = None,
                          occupancy: dict = None):
    """resolve_gbuffer's plain version (PyTorch ops on any device): the
    CPU's path, and what the card tests hold K7 against."""
    H, W = depth.shape
    dev = depth.device
    rec = _build_resolve_records(tris, tri_attr)
    if cfg.shade_tile_capacity:
        g, over = _resolve_compacted(scene, consts, cfg, rec, tid,
                                     row_offset, occupancy)
        if stats is not None:
            stats["shade_tiles_overflowed"] = over
    else:
        px = (torch.arange(W, dtype=torch.float32, device=dev)
              + 0.5)[None, :]
        py = (torch.arange(H, dtype=torch.float32, device=dev) + row_offset
              + 0.5)[:, None]
        g = _resolve_core(scene, consts, cfg, rec, tid, px.expand(H, W),
                          py.expand(H, W))
    if out_rows is not None and out_rows != H:
        g = {k: v[:out_rows] for k, v in g.items()}
    return g


# ---------------------------------------------------------------------------
# SSAO
# ---------------------------------------------------------------------------

def ssao_inputs_half(cfg: RenderConfig, normal_v: torch.Tensor,
                     depth: torch.Tensor):
    """Downsample to the SSAO resolution, matching the reference's sampler
    footprints: normals point-sampled, depth box-filtered."""
    k = cfg.ssao_scale
    sh_, sw_ = depth.shape[0] // k, depth.shape[1] // k
    n_half = normal_v[k - 1::k, k - 1::k][:sh_, :sw_]
    d_half = depth[: sh_ * k, : sw_ * k].reshape(sh_, k, sw_, k).mean((1, 3))
    return n_half, d_half


def ssao_blur(scene: DeviceScene, consts: FrameConstants, cfg: RenderConfig,
              access: torch.Tensor, n_half: torch.Tensor,
              d_half: torch.Tensor) -> torch.Tensor:
    """N two-pass (horizontal + vertical) bilateral blurs.

    CUDA tensors go through K9 (ops/ssao_kernel.blur), one launch an
    iteration, which gives the same map bit for bit; CPU tensors take
    ssao_blur_plain."""
    if not access.is_cuda:
        return ssao_blur_plain(scene, consts, cfg, access, n_half, d_half)
    for _ in range(cfg.ssao_blur_count):
        access = ssao_kernel.blur(access, n_half, d_half,
                                  scene.ssao_blur_weights, consts.proj)
    return access


def ssao_blur_plain(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig, access: torch.Tensor,
                    n_half: torch.Tensor,
                    d_half: torch.Tensor) -> torch.Tensor:
    """ssao_blur's plain version (PyTorch ops on any device): the CPU's
    path, and what the card tests hold K9 against."""
    A, B = consts.proj[2, 2], consts.proj[3, 2]
    d_view = ssao_ops.ndc_depth_to_view(d_half, A, B)
    # off-screen neighbor taps read the white depth border (NDC 1 = the
    # far plane in view space) through gsamDepthMap — SsaoBlur.hlsl:112
    border = ssao_ops.ndc_depth_to_view(1.0, A, B)
    w = scene.ssao_blur_weights
    for _ in range(cfg.ssao_blur_count):
        access = ssao_ops.bilateral_blur(access, n_half, d_view, w, True,
                                         border_depth_view=border)
        access = ssao_ops.bilateral_blur(access, n_half, d_view, w, False,
                                         border_depth_view=border)
    return access


def _dilate(occ: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(nty, ntx) bool -> the tiles within (dy, dx) tiles of a True one."""
    grown = F.max_pool2d(occ.to(torch.float32)[None, None],
                         (2 * dy + 1, 2 * dx + 1), stride=1,
                         padding=(dy, dx))
    return grown[0, 0] > 0


def _ssao_tile_occupancy(valid_half: torch.Tensor, nty: int,
                         ntx: int) -> torch.Tensor:
    """(h, w) half-res validity -> (NT,) bool: the (8, 32) tiles within
    _SSAO_DILATE_TILES of a tile with a valid pixel."""
    h, w = valid_half.shape
    vp = F.pad(valid_half.to(torch.float32),
               (0, ntx * SSAO_TILE_W - w, 0, nty * SSAO_TILE_H - h))
    tv = vp.reshape(nty, SSAO_TILE_H, ntx, SSAO_TILE_W).amax(dim=(1, 3)) > 0
    return _dilate(tv, *_SSAO_DILATE_TILES).reshape(-1)


def _ssao_occupied(cfg: RenderConfig, h: int, w: int,
                   valid: torch.Tensor) -> torch.Tensor:
    """(NT,) bool: the (8, 32) tiles of the (h, w) SSAO map the compacted
    occlusion evaluates (_ssao_tile_occupancy of the half-res validity:
    any covered full-res pixel in the k x k block)."""
    k = cfg.ssao_scale
    vh = valid[:h * k, :w * k].reshape(h, k, w, k).any(dim=3).any(dim=1)
    return _ssao_tile_occupancy(vh, -(-h // SSAO_TILE_H),
                                -(-w // SSAO_TILE_W))


def _ssao_occlusion_compacted(scene: DeviceScene, consts: FrameConstants,
                              cfg: RenderConfig, n_half, d_half, depth,
                              valid, occupancy: dict = None):
    """Tile-compacted SSAO occlusion: the 14 taps run only on the (8, 32)
    half-res tiles within the blurs' and the upsample's reach of a covered
    pixel (_ssao_tile_occupancy), cfg.ssao_tile_capacity slots of them;
    the other tiles take 1.0.

    The fill is the true value: a skipped pixel's depth is the clear 1.0
    and its 14 taps read far-plane depth only (the depth clears to 1.0,
    the border reads opaque white, and a tap lands at most
    occlusionRadius * proj / z, about 7 full-res texels, from its pixel at
    the far plane, well inside the 16-px dilation), so dist_z is 0 <
    surface_eps and every tap occludes nothing. The per-pixel uv comes
    from the slot table; on the CPU the result equals the dense
    occlusion (the JAX package bounds it at 1e-5, as XLA folds the dense
    uv as a constant). Returns ((h, w) access, over) (see _compact);
    occupancy (optional dict) receives "ssao_tiles", _compact's needed."""
    TH, TW = SSAO_TILE_H, SSAO_TILE_W
    h, w = d_half.shape
    nty, ntx = -(-h // TH), -(-w // TW)
    kept, inv, over, needed = _compact(_ssao_occupied(cfg, h, w, valid),
                                       cfg.ssao_tile_capacity)
    # ONE packed (depth, normal, random field) tile table + the fill row:
    # depth 1, normal (0, 0, 1), field 0
    stack = torch.cat([_tiles(d_half, TH, TW, 1.0)[0],
                       _tiles(n_half, TH, TW, 0.0)[0],
                       _tiles(scene.ssao_random_field, TH, TW, 0.0)[0]],
                      dim=-1)  # (NT, LANES, 7)
    fill = device_constant((1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0),
                           stack.dtype, stack.device)
    sel = torch.cat([stack, fill.expand(1, TH * TW, -1)])[kept]
    x, y = _slot_pixels(kept, nty, ntx, TH, TW)
    U = (x.to(torch.float32) + 0.5) / w
    V = (y.to(torch.float32) + 0.5) / h
    acc = ssao_ops.ssao_occlusion(
        sel[..., 1:4], sel[..., 0], consts.proj, consts.inv_proj,
        scene.ssao_offsets, random_field=sel[..., 4:7], tap_depth=depth,
        pixel_uv=(U, V))  # (CB, LANES)
    accp = torch.cat([acc, torch.ones_like(acc[:1])])
    if occupancy is not None:
        occupancy["ssao_tiles"] = needed
    return _untile(accp[inv][..., None], nty, ntx, TH, TW, h, w)[..., 0], \
        over


def ssao_pass(scene: DeviceScene, consts: FrameConstants, cfg: RenderConfig,
              normal_v: torch.Tensor, depth: torch.Tensor,
              valid: torch.Tensor = None,
              stats: dict = None, occupancy: dict = None) -> torch.Tensor:
    """Half-res occlusion + N two-pass bilateral blurs -> (h, w) access.
    The 14 taps sample the full-res depth (Ssao.hlsl binds the full depth
    buffer with the linear border-white gsamDepthMap).

    valid: optional (H, W) full-res coverage (tid >= 0). With it and
    cfg.ssao_tile_capacity, the occlusion is tile-compacted
    (_ssao_occlusion_compacted) and stats (optional dict) receives
    "ssao_tiles_overflowed", a 0-d bool tensor, occupancy (optional dict)
    "ssao_tiles", the tiles evaluated (0-d int64), what
    ssao_tile_capacity bounds; the blurs stay dense.

    CUDA tensors go through K9 (ops/ssao_kernel.py): one occlusion launch
    over _compact's tile -> slot table (every pixel for the dense pass)
    that writes the (h, w) map, then ssao_blur's launches; the same map
    bit for bit. CPU tensors take ssao_pass_plain."""
    if not depth.is_cuda:
        return ssao_pass_plain(scene, consts, cfg, normal_v, depth, valid,
                               stats, occupancy)
    n_half, d_half = ssao_inputs_half(cfg, normal_v, depth)
    inv, capacity = None, 0
    if cfg.ssao_tile_capacity and valid is not None:
        _, inv, over, needed = _compact(
            _ssao_occupied(cfg, *d_half.shape, valid), cfg.ssao_tile_capacity)
        capacity = min(int(cfg.ssao_tile_capacity), inv.shape[0])
        if stats is not None:
            stats["ssao_tiles_overflowed"] = over
        if occupancy is not None:
            occupancy["ssao_tiles"] = needed
    access = ssao_kernel.occlusion(
        n_half, d_half, consts.proj, consts.inv_proj, scene.ssao_offsets,
        random_field=scene.ssao_random_field, tap_depth=depth.contiguous(),
        inv=inv, capacity=capacity)
    return ssao_blur(scene, consts, cfg, access, n_half, d_half)


def ssao_pass_plain(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig, normal_v: torch.Tensor,
                    depth: torch.Tensor, valid: torch.Tensor = None,
                    stats: dict = None,
                    occupancy: dict = None) -> torch.Tensor:
    """ssao_pass's plain version (PyTorch ops on any device): the CPU's
    path, and what the card tests hold K9 against."""
    n_half, d_half = ssao_inputs_half(cfg, normal_v, depth)
    if cfg.ssao_tile_capacity and valid is not None:
        access, over = _ssao_occlusion_compacted(
            scene, consts, cfg, n_half, d_half, depth, valid, occupancy)
        if stats is not None:
            stats["ssao_tiles_overflowed"] = over
    else:
        access = ssao_ops.ssao_occlusion(
            n_half, d_half, consts.proj, consts.inv_proj, scene.ssao_offsets,
            random_field=scene.ssao_random_field, tap_depth=depth)
    return ssao_blur_plain(scene, consts, cfg, access, n_half, d_half)


def _upsample_bilinear(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Half-res -> full-res bilinear (the lighting pass samples the SSAO map
    with gsamLinearClamp at full-res screen uv). Half-pixel centres with
    the edge sample clamped, as jax.image.resize's bilinear upsampling."""
    return F.interpolate(img[None, None], size=(H, W), mode="bilinear",
                         align_corners=False)[0, 0]


# ---------------------------------------------------------------------------
# Lighting + sky
# ---------------------------------------------------------------------------

def _pcf_factor_compacted(cfg: RenderConfig, pos_w, valid, sf_fn):
    """Tile-compacted cascade PCF factor: sf_fn (the cascade select, the
    PCF and the blend) runs only on the (8, 128) tiles that hold a covered
    pixel. The factor is pointwise, so these are the resolve's shade tiles
    and cfg.shade_tile_capacity sizes both. The map equals the dense one:
    covered pixels evaluate the same math on the same values, and
    uncovered ones are 1.0 through the dense path's dead mask and the
    skipped tiles' fill here. With the soft disk, K6 (ops.pcf) runs once
    over both cascades of the CB * 1024 receivers."""
    H, W = valid.shape
    TH, TW = SHADE_TILE_H, SHADE_TILE_W
    # ONE packed (position, coverage) tile table + the sentinel row
    stack, nty, ntx = _tiles(
        torch.cat([pos_w, valid[..., None].to(pos_w.dtype)], dim=-1),
        TH, TW, 0.0)  # (NT, LANES, 4)
    kept, inv, _, _ = _compact(stack[..., 3].amax(dim=1) > 0.5,
                               cfg.shade_tile_capacity)
    sel = torch.cat([stack, torch.zeros_like(stack[:1])])[kept]
    f = sf_fn(sel[..., :3], sel[..., 3] < 0.5)  # (CB, LANES)
    fp = torch.cat([f, torch.ones_like(f[:1])])
    return _untile(fp[inv][..., None], nty, ntx, TH, TW, H, W)[..., 0]


def shadow_factor_pass(consts: FrameConstants, cfg: RenderConfig, g: dict,
                       shadow_maps, row_offset: int = 0,
                       full_height: int = None) -> torch.Tensor:
    """Light 0's cascade PCF factor, (H, W): the compiled zero radius, or
    the soft disk of cfg.pcf_radius_texels. With cfg.fast_shadow_factor
    it is evaluated on every other pixel of every other row and
    upsampled bilinearly. cfg.shade_tile_capacity selects the
    tile-compacted factor (_pcf_factor_compacted, the same map) on the
    full-resolution branch of a whole screen; the fast preset's half-res
    factor and bands (rows from global row ``row_offset`` of a
    ``full_height``-row screen) stay dense."""
    valid = g["valid"]
    pos_w = g["pos_w"]
    H, W = valid.shape
    if full_height is None:
        full_height = H

    def sf_fn(pw, dead):
        return shadows.cascade_shadow_factor(
            shadow_maps, consts.shadow_transforms, pw, consts.eye_pos,
            cfg.shadow_map_size, deferred_blend_quirk=cfg.deferred,
            soft_radius_texels=cfg.pcf_radius_texels, dead=dead)

    if cfg.fast_shadow_factor:
        # performance mode: the (smooth) PCF factor on a half-res grid,
        # upsampled; the quality cost is at shadow silhouettes
        return _upsample_bilinear(sf_fn(pos_w[::2, ::2], ~valid[::2, ::2]),
                                  H, W)
    if cfg.shade_tile_capacity and row_offset == 0 and full_height == H:
        # one card: the PCF only on the covered tiles (a band's occupancy
        # is not what the capacity was sized for)
        return _pcf_factor_compacted(cfg, pos_w, valid, sf_fn)
    return sf_fn(pos_w, ~valid)


def direct_light(scene: DeviceScene, consts: FrameConstants,
                 cfg: RenderConfig, g: dict,
                 shadow_factor: torch.Tensor = None,
                 in_reach: torch.Tensor = None) -> dict:
    """The light loops: PBRShading (PBR.hlsl:91-149, directional lights
    only), or the Blinn-Phong ComputeLighting (LightingUtil.hlsl:156-186)
    with cfg.use_pbr False, over every pixel, with light 0 taking
    ``shadow_factor`` ((H, W); None: unshadowed). Returns the direct light
    before the tonemap ("direct", (H, W, 3)) with the surface terms that
    the rest of the lighting reads ("normal", "view", "fresnel_r0",
    "shininess"). in_reach (optional, (H, W, 1) float) receives each
    local light's in-range mask, added in place (shading.compute_lighting;
    the frame trace's light reach).

    CUDA tensors go through K10 (ops/light_kernel.py), one launch that
    reads K7's G-buffer in place (g["buffer"], resolve_gbuffer's on the
    card) and writes the same five outputs bit for bit, contiguous planes
    of one buffer. CPU tensors take direct_light_plain."""
    if not g["pos_w"].is_cuda:
        return direct_light_plain(scene, consts, cfg, g, shadow_factor,
                                  in_reach)
    return light_kernel.light(g.get("buffer"), consts.eye_pos,
                              _LightsView(scene, cfg), cfg.use_pbr,
                              cfg.deferred, shadow_factor, in_reach)


def direct_light_plain(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, g: dict,
                       shadow_factor: torch.Tensor = None,
                       in_reach: torch.Tensor = None) -> dict:
    """direct_light's plain version (PyTorch ops on any device): the CPU's
    path, and what the card tests hold K10 against."""
    pos_w = g["pos_w"]
    albedo = g["albedo"]
    roughness = g["roughness"]
    metalness = g["metalness"]
    normal = shading.normalize(g["normal_w"])
    view = shading.normalize(consts.eye_pos - pos_w)
    fresnel_r0 = 0.04 * (1.0 - metalness) + albedo[..., :3] * metalness
    sf = (torch.ones_like(roughness) if shadow_factor is None
          else shadow_factor[..., None])
    lights = _LightsView(scene, cfg)
    # deferred shininess alpha is gBuffer2.w == 1 (GBuffer.hlsl:28);
    # forward uses the normal map alpha (Default.hlsl:159)
    alpha = (torch.ones_like(roughness) if cfg.deferred
             else g["shininess_alpha"])
    shininess = (1.0 - roughness) * alpha
    if cfg.use_pbr:
        direct = shading.pbr_shading(lights, normal, view, pos_w, albedo,
                                     roughness, metalness, sf)
    else:
        direct = shading.compute_lighting(lights, normal, view, pos_w,
                                          albedo, fresnel_r0, shininess, sf,
                                          in_reach=in_reach)
    return dict(direct=direct, normal=normal, view=view,
                fresnel_r0=fresnel_r0, shininess=shininess)


def finish_lighting(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig, g: dict, lit: dict, ambient_access,
                    row_offset: int = 0,
                    full_height: int = None) -> torch.Tensor:
    """The lighting after its light loops: the ambient term (with the
    SSAO access), the tonemapped direct light of direct_light's ``lit``
    and the sky (procedural, or sampled from the scene's cubemap) as the
    reflection on geometry and as the background. Rows from global row
    ``row_offset`` of a ``full_height``-row screen (the sky ray's NDC
    y). Returns the (H, W, 4) image."""
    valid = g["valid"]
    albedo = g["albedo"]
    H, W = valid.shape
    dev = valid.device
    if full_height is None:
        full_height = H
    ambient = (ambient_access[..., None] * scene.ambient[None, None, :]
               * albedo)
    lit_rgb = ambient[..., :3] + shading.tonemap_direct(lit["direct"])

    valid3 = valid[..., None]
    if cfg.sky_enabled:
        normal, view = lit["normal"], lit["view"]
        # sky reflection on geometry (Default.hlsl:176-179) and the sky
        # pass for empty pixels (sky.hlsl:33-47) are exclusive per pixel,
        # so one sky evaluation serves both
        r = shading.reflect(-view, normal)
        ndc_x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) \
            / W * 2.0 - 1.0
        ndc_y = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev)
                       + row_offset + 0.5) / full_height * 2.0
        ndc = torch.stack(
            [ndc_x[None, :].expand(H, W), ndc_y[:, None].expand(H, W),
             torch.ones((H, W), dtype=torch.float32, device=dev),
             torch.ones((H, W), dtype=torch.float32, device=dev)], dim=-1)
        # inv_ex: no error check, so no host sync
        inv_vp = torch.linalg.inv_ex(consts.view_proj).inverse
        far_h = ndc @ inv_vp
        far_w = far_h[..., :3] / far_h[..., 3:4]
        ray = far_w - consts.eye_pos
        cube_dir = torch.where(valid3, r, ray)
        if cfg.procedural_sky:
            cube_col = sampling.procedural_sky_color(cube_dir)
        else:
            cube_col = sampling.sample_cubemap(scene.cubemap,
                                               cube_dir)[..., :3]
        fres = shading.schlick_fresnel(lit["fresnel_r0"], normal, r)
        lit_rgb = torch.where(valid3,
                              lit_rgb + lit["shininess"] * fres * cube_col,
                              cube_col)

    alpha_out = torch.where(valid3, albedo[..., 3:4],
                            torch.ones_like(albedo[..., 3:4]))
    return torch.cat([lit_rgb, alpha_out], dim=-1)


def lighting_pass(scene: DeviceScene, consts: FrameConstants,
                  cfg: RenderConfig, g: dict, shadow_maps, ambient_access,
                  depth: torch.Tensor, row_offset: int = 0,
                  full_height: int = None,
                  shadow_factor: torch.Tensor = None) -> torch.Tensor:
    """Lighting (DeferredShading.hlsl PS, or the forward Default.hlsl PS
    with cfg.deferred False): shadow_factor_pass with shadows on,
    direct_light, then finish_lighting; render_frame runs the three as
    stages of their own. depth is not read (the rows lit are g's); it
    keeps the JAX package's signature.

    Band rendering (parallel.sharded): the rows start at global row
    ``row_offset`` of a ``full_height``-row screen, and
    ``shadow_factor`` ((H, W)), when given, replaces the PCF evaluation
    (the sharded fast preset computes it across bands)."""
    sf = None
    if cfg.shadows_enabled:
        sf = (shadow_factor if shadow_factor is not None
              else shadow_factor_pass(consts, cfg, g, shadow_maps,
                                      row_offset, full_height))
    lit = direct_light(scene, consts, cfg, g, sf)
    return finish_lighting(scene, consts, cfg, g, lit, ambient_access,
                           row_offset, full_height)


# ---------------------------------------------------------------------------
# Alpha-tested layer (the ALPHA_TEST shader variants, CRYCHIC.cpp:1205-1218:
# Default.hlsl / Shadows.hlsl clip(a - 0.1))
# ---------------------------------------------------------------------------

# Elements of one (triangles, rows, columns) slab of the alpha peel: the
# triangles are evaluated in chunks of this many pixel-triangle pairs
PEEL_CHUNK_ELEMS = 1 << 23


def alpha_view_tris(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig):
    """Vertex stage + near clip for the AlphaTested layer (same pipeline
    as main_view_tris, over scene.alpha)."""
    return _view_tris(scene.alpha, consts.alpha_visibility,
                      scene.mat_transform, consts, cfg)


def _peel_setup(tris: rz.ScreenTris, uv_tri, mat_tri):
    """The peel's per-triangle set-up, over the T triangles: the edge
    coefficients A, B, C (T, 3) and top-left flags of rz._edge_coeffs,
    the depth plane zA, zB, zC (T,), and the 16-wide record xy(6) inv_w(3)
    uv(6) mat(1), one row gather per pixel per peel recovering the
    winner's interpolation data."""
    A, B, C, area2, top_left = rz._edge_coeffs(tris.xy)
    inv_a2 = 1.0 / torch.where(area2 == 0, torch.ones_like(area2), area2)
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    zC = (C * tris.z * inv_a2[:, None]).sum(-1)
    rec = torch.cat([tris.xy.reshape(-1, 6), tris.inv_w, uv_tri[:, 0],
                     uv_tri[:, 1], uv_tri[:, 2],
                     mat_tri.to(torch.float32)[:, None]], dim=-1)
    return A, B, C, top_left, zA, zB, zC, rec


def _alpha_peel(tris: rz.ScreenTris, uv_tri, mat_tri, scene: DeviceScene,
                px, py, n_peels: int, clip_thr: float, unresolved=None):
    """Dense small-N rasterization of alpha-tested triangles with depth
    peeling: per pixel, the nearest fragment whose sampled alpha passes
    clip(a - thr).

    A GPU's pixel shader clips before the depth test (Shadows.hlsl:49-65);
    a visibility-buffer rasterizer decides coverage without textures, so
    the layer (a handful of fence or foliage quads) is rasterized densely
    here: ``n_peels`` rounds of (nearest fragment above the last peel's
    depth, its uv and alpha). Fragments behind ``n_peels`` failing layers
    are dropped (the JAX package's approximation; 2 covers every
    two-sided fence).

    The JAX package loops over the triangles one at a time; here chunks
    of triangles are evaluated as dense (chunk, rows, columns) tensors
    (PEEL_CHUNK_ELEMS elements at most), with the same arithmetic and the
    same strict ``<``: the earliest triangle wins a depth tie, as in the
    sequential order. This is the plain version of the kernel K8
    (ops/alpha_peel.py), which depth_peel launches for CUDA tensors.

    tris: (T,) screen triangles; uv_tri: (T, 3, 2); mat_tri: (T,).
    px/py: pixel-center coordinate grids (broadcastable to the output).
    unresolved (optional list) receives, after each peel, the pixels
    that peel found a fragment in and that are still unresolved (its
    fragment failed the clip), 0-d int64: a pixel the last peel counts
    may hold a passing fragment behind it that is dropped.
    Returns (z, idx): idx -1 where no passing fragment."""
    A, B, C, top_left, zA, zB, zC, rec = _peel_setup(tris, uv_tri, mat_tri)
    T = tris.xy.shape[0]
    shape = torch.broadcast_shapes(px.shape, py.shape)
    pxb, pyb = px.expand(shape), py.expand(shape)
    dev = pxb.device
    inf = float("inf")
    chunk = max(1, PEEL_CHUNK_ELEMS // max(1, shape[0] * shape[1]))

    def nearest_above(zfloor):
        zb = torch.full(shape, inf, device=dev)
        ib = torch.full(shape, -1, dtype=torch.int32, device=dev)
        for t0 in range(0, T, chunk):
            t1 = min(T, t0 + chunk)

            def per_tri(x):  # (T,) -> (chunk, 1, 1)
                return x[t0:t1, None, None]

            cov = None
            for e in range(3):
                E = (per_tri(A[:, e]) * pxb + per_tri(B[:, e]) * pyb
                     + per_tri(C[:, e]))
                c = (E > 0) | ((E == 0) & per_tri(top_left[:, e]))
                cov = c if cov is None else cov & c
            z = per_tri(zA) * pxb + per_tri(zB) * pyb + per_tri(zC)
            cand = (cov & per_tri(tris.valid) & (z >= 0.0) & (z <= 1.0)
                    & (z > zfloor))
            zc = torch.where(cand, z, inf)
            zmin = zc.amin(0)
            t = torch.arange(t0, t1, dtype=torch.int32, device=dev)
            first = torch.where(cand & (zc == zmin), t[:, None, None],
                                T).amin(0)
            better = zmin < zb
            zb = torch.where(better, zmin, zb)
            ib = torch.where(better, first, ib)
        return zb, ib

    res_z = torch.full(shape, inf, device=dev)
    res_id = torch.full(shape, -1, dtype=torch.int32, device=dev)
    resolved = torch.zeros(shape, dtype=torch.bool, device=dev)
    zfloor = torch.full(shape, -1.0, device=dev)
    pool = scene.pair_pool
    for _ in range(n_peels):
        zb, ib = nearest_above(zfloor)
        r = rec[torch.clamp(ib, min=0).long()]
        xy = r[..., :6].reshape(shape + (3, 2))
        wgt = rz.barycentrics_at(xy, pxb, pyb) * r[..., 6:9]
        den = wgt.sum(-1, keepdim=True)
        # sign-preserving guard: extrapolated barycentrics (a pixel whose
        # record is a fallback triangle) can sum NEGATIVE; clamping to
        # +1e-20 would flip the sign and explode uv, which leaks into
        # neighbors through the uv derivatives
        wgt = wgt / torch.where(torch.abs(den) < 1e-20,
                                torch.full_like(den, 1e-20), den)
        uv = (wgt[..., 0:1] * r[..., 9:11] + wgt[..., 1:2] * r[..., 11:13]
              + wgt[..., 2:3] * r[..., 13:15])
        mat = r[..., 15].long()
        pairidx = _mat_select(scene.mat_pair, mat).long()
        lod = sampling.lod_from_derivatives(*sampling.uv_derivatives(uv))
        dsample, _ = sampling.sample_pair_trilinear(pool, pairidx, uv, lod)
        aval = dsample[..., 3] * _mat_select(scene.mat_albedo, mat)[..., 3]
        passing = (ib >= 0) & (aval - clip_thr >= 0.0)
        take = ~resolved & passing
        res_z = torch.where(take, zb, res_z)
        res_id = torch.where(take, ib, res_id)
        resolved = resolved | take
        zfloor = torch.where(ib >= 0, zb, inf)
        if unresolved is not None:
            unresolved.append(((ib >= 0) & ~resolved).sum())
    return res_z, res_id


def depth_peel(scene: DeviceScene, tris: rz.ScreenTris, uv_tri, mat_tri,
               rows: int, cols: int, oy, ox, n_peels: int, clip_thr: float,
               counted: bool = False):
    """The alpha layer's depth peel over the rows x cols pixel grid whose
    first pixel is (oy, ox): ints, or 0-d int64 tensors on the device (a
    punch window's origin; no host read).

    CUDA tensors launch K8 (ops/alpha_peel.py, two launches a peel
    round), which gives depth_peel_plain's result bit for bit; CPU
    tensors take depth_peel_plain. Returns (z, idx, unresolved):
    unresolved is, with counted, the (n_peels,) int64 per-peel count of
    _alpha_peel's ``unresolved``, else None."""
    if not tris.xy.is_cuda:
        return depth_peel_plain(scene, tris, uv_tri, mat_tri, rows, cols, oy,
                                ox, n_peels, clip_thr, counted)
    table = alpha_peel.peel_table(_peel_setup(tris, uv_tri, mat_tri),
                                  tris.valid)
    return alpha_peel.peel(table, rows, cols, oy, ox, scene.pair_data,
                           scene.n_big_pairs, scene.mat_albedo,
                           scene.mat_pair, n_peels, clip_thr, counted)


def depth_peel_plain(scene: DeviceScene, tris: rz.ScreenTris, uv_tri,
                     mat_tri, rows: int, cols: int, oy, ox, n_peels: int,
                     clip_thr: float, counted: bool = False):
    """depth_peel's plain version: _alpha_peel at the pixel centres (o +
    i) + 0.5 of both axes."""
    dev = tris.xy.device

    def centres(o, n):
        o = o.to(torch.float32) if isinstance(o, torch.Tensor) else float(o)
        return (o + torch.arange(n, dtype=torch.float32, device=dev)) + 0.5

    unresolved = [] if counted else None
    z, idx = _alpha_peel(tris, uv_tri, mat_tri, scene,
                         centres(ox, cols)[None, :],
                         centres(oy, rows)[:, None], n_peels, clip_thr,
                         unresolved)
    return z, idx, torch.stack(unresolved) if counted else None


def alpha_merge_main(scene: DeviceScene, consts: FrameConstants,
                     cfg: RenderConfig, depth, tid, tris, tri_attr,
                     row_offset: int = 0, occupancy: dict = None):
    """Rasterize the AlphaTested layer and merge it into the opaque
    visibility buffer; the layer's triangle records are APPENDED to the
    screen-triangle and attribute tables, so resolve_gbuffer shades its
    winners through the same path (tid indexes the concatenated table).

    row_offset: first GLOBAL pixel row of `depth` (band rendering: the
    peel evaluates at global rows, so bands equal the full frame).
    occupancy (optional dict) receives "alpha_unresolved", (alpha_peels,)
    int64: per peel, the pixels it found a fragment in that are still
    unresolved after it (_alpha_peel's unresolved)."""
    H, W = depth.shape
    a_tris, a_attr = alpha_view_tris(scene, consts, cfg)
    az, aid, unresolved = depth_peel(
        scene, a_tris, a_attr[:, :, 13:15], a_attr[:, 0, 15], H, W,
        row_offset, 0, cfg.alpha_peels, cfg.alpha_clip,
        counted=occupancy is not None)
    if occupancy is not None:
        occupancy["alpha_unresolved"] = unresolved
    t_base = tris.xy.shape[0]
    win = (aid >= 0) & (az < depth)
    depth = torch.where(win, az, depth)
    tid = torch.where(win, t_base + aid, tid)
    tris = rz.ScreenTris(*(torch.cat([a, b]) for a, b in zip(tris, a_tris)))
    return depth, tid, tris, torch.cat([tri_attr, a_attr])


def alpha_shadow_geom(scene: DeviceScene, consts: FrameConstants):
    """Cascade-independent inputs of the alpha shadow punch, computed
    once: per-triangle world-space vertices, and the uv and material ids
    of each corner: from the draw's static corner tables (frame-constant),
    or without them through the vertex stage's uv chain and a gather."""
    draw = scene.alpha
    tri_world = shadow_tri_world(draw, consts.alpha_visibility)
    if draw.tri_rest is not None:
        return (tri_world, draw.tri_rest[..., 9:11],
                draw.tri_rest[:, 0, 11].long())
    tri_idx = draw.indices.long().reshape(-1, 3)
    mat = draw.material_indices.long()[draw.vertex_instance.long()]
    return (tri_world, _vertex_uv(draw, scene.mat_transform)[tri_idx],
            mat[tri_idx[:, 0]])


def alpha_window(cfg: RenderConfig) -> int:
    """The punch window's side in texels: cfg.alpha_shadow_window, at
    most the map."""
    return min(cfg.alpha_shadow_window, cfg.shadow_map_size)


def _alpha_light_tris(cfg: RenderConfig, tri_world, vp) -> rz.ScreenTris:
    """The alpha triangles in one cascade's S x S map, with the shadow
    PSO's depth bias."""
    S = cfg.shadow_map_size
    return _shadow_bias(rz.setup_tri_verts(shading.rowmat(tri_world, vp),
                                           None, S, S))


def _alpha_light_corner(t: rz.ScreenTris, high: bool = False):
    """(2,): the low (or high) corner of the map-space bounding box of
    the valid triangles' vertices; +inf (-inf) where none is valid."""
    fill = torch.full_like(t.xy, float("-inf") if high else float("inf"))
    v = torch.where(t.valid[:, None, None], t.xy, fill)
    return v.amax((0, 1)) if high else v.amin((0, 1))


def _window_start(lo, S: int):
    """The first texel row or column a punch window may start at: floor
    of the box's low corner less one, clamped to the map (in float: the
    JAX package's int32 clip for any finite corner, and defined for the
    +inf of an empty box)."""
    return torch.clamp(torch.floor(lo) - 1.0, 0.0, float(S))


def _window_extent(t: rz.ScreenTris, S: int):
    """The side of the smallest punch window that holds every texel the
    valid triangles can cover, 0-d int64: from the window's first texel
    (_window_start) to the box's high corner rounded up, clamped to the
    map, the larger of the two axes (0 with no valid triangle). A window
    of at least this side clips nothing of the layer; a smaller one
    drops the layer's fragments past its far edge."""
    last = torch.clamp(torch.ceil(_alpha_light_corner(t, high=True)), 0.0,
                       float(S))
    first = _window_start(_alpha_light_corner(t), S)
    return torch.clamp(last - first, min=0.0).amax().long()


def _punch_window(scene: DeviceScene, cfg: RenderConfig, t, uv_tri,
                  mat_tri):
    """alpha_punch_window on the cascade's set-up triangles."""
    S = cfg.shadow_map_size
    Wn = alpha_window(cfg)
    lo = _alpha_light_corner(t)
    oy, ox = (torch.clamp(_window_start(lo[k], S), max=float(S - Wn)).long()
              for k in (1, 0))
    az, aid, _ = depth_peel(scene, t, uv_tri, mat_tri, Wn, Wn, oy, ox,
                            cfg.alpha_peels, cfg.alpha_clip)
    return az, aid, oy, ox


def alpha_punch_window(scene: DeviceScene, cfg: RenderConfig, tri_world,
                       uv_tri, mat_tri, vp):
    """One cascade's punch data: depth-peel the alpha triangles inside a
    statically sized window (alpha_window(cfg) texels a side) placed at
    the layer's light-space bounding box's low corner. Returns (az
    (Wn, Wn), aid (Wn, Wn) int32, oy, ox) with the window's origin as 0-d
    int64 tensors (no host read). Where the box is wider than the window
    (_window_extent), the layer's fragments past it are not punched:
    alpha_merge_shadow flags that. The shadow map is not read, so this
    can run on another rank than the merge (parallel.sharded distributes
    the cascades)."""
    return _punch_window(scene, cfg, _alpha_light_tris(cfg, tri_world, vp),
                         uv_tri, mat_tri)


def alpha_apply_punch(shadow_map, az, aid, oy, ox):
    """Min-merge one cascade's punch window into its (S, S) shadow map
    (a new tensor; index tensors, so the origin stays on the device)."""
    Wn = az.shape[0]
    ramp = torch.arange(Wn, device=shadow_map.device)
    rows, cols = (oy + ramp)[:, None], (ox + ramp)[None, :]
    window = shadow_map[rows, cols]
    out = shadow_map.clone()
    out[rows, cols] = torch.where(aid >= 0, torch.minimum(window, az),
                                  window)
    return out


def alpha_merge_shadow(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, shadow_maps, stats: dict = None,
                       occupancy: dict = None):
    """Punch the AlphaTested casters into the cascade shadow maps
    (Shadows.hlsl ALPHA_TEST PS, :49-65): per cascade, depth-peel the
    alpha triangles inside a statically sized window over the layer's
    light-space bounding box and min-merge the passing fragments.

    stats (optional dict) receives "alpha_window_overflowed", a 0-d bool
    tensor: the layer's box in some cascade is wider than the window, so
    shadow holes past it were lost; occupancy (optional dict)
    "alpha_window", the widest _window_extent over the cascades (0-d
    int64), what alpha_window(cfg) bounds."""
    tri_world, uv_tri, mat_tri = alpha_shadow_geom(scene, consts)
    maps, extents = [], []
    for c in range(shadow_maps.shape[0]):
        t = _alpha_light_tris(cfg, tri_world, consts.cascade_view_projs[c])
        maps.append(alpha_apply_punch(
            shadow_maps[c], *_punch_window(scene, cfg, t, uv_tri, mat_tri)))
        if stats is not None or occupancy is not None:
            extents.append(_window_extent(t, cfg.shadow_map_size))
    if extents:
        widest = torch.stack(extents).amax()
        if stats is not None:
            stats["alpha_window_overflowed"] = widest > alpha_window(cfg)
        if occupancy is not None:
            occupancy["alpha_window"] = widest
    return torch.stack(maps)


def alpha_enabled(scene: DeviceScene, cfg: RenderConfig) -> bool:
    """Whether the frame runs the alpha layer: alpha_test_enabled with no
    alpha draw in the scene counts as off, as in the JAX package."""
    return cfg.alpha_test_enabled and scene.alpha is not None


# ---------------------------------------------------------------------------
# Capacity counts
# ---------------------------------------------------------------------------

def _tile_counts(bbox) -> torch.Tensor:
    """(nty, ntx) int32: how many valid triangles' bounding boxes touch
    each tile, from rz._tile_bbox's output. Each box adds +-1 at its four
    corners (inclusion-exclusion); a 2D cumsum gives the count per tile,
    with no pair expansion."""
    tx0, ty0, bw, bh, ntx, nty = bbox
    tx0, ty0, bw, bh = tx0.long(), ty0.long(), bw.long(), bh.long()
    one = (bw > 0).to(torch.int32)
    img = torch.zeros((nty + 1, ntx + 1), dtype=torch.int32,
                      device=one.device)
    img.index_put_((torch.cat([ty0, ty0, ty0 + bh, ty0 + bh]),
                    torch.cat([tx0, tx0 + bw, tx0, tx0 + bw])),
                   torch.cat([one, -one, -one, one]), accumulate=True)
    return img.cumsum(0).cumsum(1)[:nty, :ntx]


def _bbox_occupancy(tris: rz.ScreenTris, width: int, height: int,
                    tile_h: int, tile_w: int) -> torch.Tensor:
    """(nty, ntx) bool: the tiles some valid triangle's bounding box
    touches, a superset of the tiles with a covered pixel."""
    return _tile_counts(rz._tile_bbox(tris, width, height, tile_h,
                                      tile_w)) > 0


def _pairs_and_max_tile(tris: rz.ScreenTris, width: int, height: int,
                        tile_h: int):
    """(pairs, largest per-tile count) of one binning, 0-d tensors."""
    bbox = rz._tile_bbox(tris, width, height, tile_h, rz.TILE_W)
    _, _, bw, bh, _, _ = bbox
    return (bw * bh).sum(), _tile_counts(bbox).max().to(torch.int64)


def capacity_requirements(scene: DeviceScene, consts: FrameConstants,
                          cfg: RenderConfig) -> dict:
    """Exact (tile, triangle) pair counts the frame's rasters expand to —
    what pair_capacity / shadow_pair_capacity must reach, else pairs are
    dropped (and the raster reports overflowed) — the largest per-tile
    triangle counts, which bin_cap / shadow_bin_cap must reach on the
    pure-tensor path (use_pallas False), else a tile's run is truncated,
    and bounds on the tiles the compacted passes evaluate, which
    shade_tile_capacity / ssao_tile_capacity must reach, else covered
    tiles are shaded as sky.

    Tile heights per path, as the rasters bin: the kernel path on
    raster.TILE_H-row tiles, the pure-tensor path on rz.XLA_TILE_H-row
    tiles. The kernel path's shadow counts bin the 4S-wide ATLAS
    triangles as render_shadow_atlas does; the JAX package sums
    per-cascade counts with each cascade clipped to its own S x S map
    (frame.py:1394-1404), which misses the pairs of triangles whose bbox
    runs into a neighbouring column and undercounts the atlas at 1080p.
    The pure-tensor path renders each cascade in its own viewport, so
    there the counts are the JAX package's: the cascades' pairs summed
    (each cascade's binning holds one of them) and the largest tile of
    any cascade.

    shade_tiles counts the (8, 128) tiles the main view's and the alpha
    layer's triangle boxes touch (the alpha layer sets tid >= 0 where no
    opaque box reaches: a fence over the sky); ssao_tiles the (8k, 32k)
    full-res tiles, the SSAO tiles, that the same boxes touch, grown by
    _SSAO_DILATE_TILES, as the JAX package counts them. With the alpha
    layer and shadows on, alpha_window is the widest light-space extent
    of the layer over the cascades (_window_extent), which
    alpha_window(cfg) must reach, else the punch drops the layer's
    shadow holes past the window (the frame flags it; the port's
    capacities do not grow it). Returns 0-d int tensors."""
    tris, _ = main_view_tris(scene, consts, cfg)
    th = raster.TILE_H if cfg.use_pallas else rz.XLA_TILE_H
    main_pairs, main_max_tile = _pairs_and_max_tile(tris, cfg.width,
                                                    cfg.height, th)
    views = [tris]
    if alpha_enabled(scene, cfg):
        views.append(alpha_view_tris(scene, consts, cfg)[0])

    def occupancy(tile_h, tile_w):
        occ = [_bbox_occupancy(t, cfg.width, cfg.height, tile_h, tile_w)
               for t in views]
        return occ[0] if len(occ) == 1 else occ[0] | occ[1]

    shade_tiles = occupancy(SHADE_TILE_H, SHADE_TILE_W).sum()
    ssao_tiles = torch.zeros_like(shade_tiles)
    if cfg.ssao_enabled:
        k = cfg.ssao_scale
        ssao_tiles = _dilate(occupancy(SSAO_TILE_H * k, SSAO_TILE_W * k),
                             *_SSAO_DILATE_TILES).sum()
    shadow_pairs = torch.zeros_like(main_pairs)
    shadow_max_tile = torch.zeros_like(main_max_tile)
    if cfg.shadows_enabled:
        S = cfg.shadow_map_size
        vps = consts.cascade_view_projs
        if cfg.use_pallas:
            atris, _ = shadow_atlas_tris(scene, consts.shadow_visibility,
                                         vps, cfg)
            shadow_pairs, shadow_max_tile = _pairs_and_max_tile(
                atris, vps.shape[0] * S, S, raster.TILE_H)
        else:
            tri_world = shadow_tri_world(scene.shadow,
                                         consts.shadow_visibility)
            for c in range(cfg.num_cascades):
                t = rz.setup_tri_verts(shading.rowmat(tri_world, vps[c]),
                                       None, S, S)
                pairs, top = _pairs_and_max_tile(t, S, S, rz.XLA_TILE_H)
                shadow_pairs = shadow_pairs + pairs
                shadow_max_tile = torch.maximum(shadow_max_tile, top)
    req = dict(main_pairs=main_pairs, shadow_pairs=shadow_pairs,
               main_max_tile=main_max_tile, shadow_max_tile=shadow_max_tile,
               shade_tiles=shade_tiles, ssao_tiles=ssao_tiles)
    if cfg.shadows_enabled and alpha_enabled(scene, cfg):
        tri_world = shadow_tri_world(scene.alpha, consts.alpha_visibility)
        req["alpha_window"] = torch.stack([_window_extent(
            _alpha_light_tris(cfg, tri_world, consts.cascade_view_projs[c]),
            cfg.shadow_map_size) for c in range(cfg.num_cascades)]).amax()
    return req


# ---------------------------------------------------------------------------
# Full frame
# ---------------------------------------------------------------------------

# render_frame's stages in frame order, the names its mark hook is called
# with after each (app/profiler.profile_frame's keys)
FRAME_STAGES = ("raster_main", "alpha_merge_main", "resolve_gbuffer",
                "shadow_maps_x4", "alpha_merge_shadow", "ssao",
                "shadow_factor", "direct_light", "lighting")

def render_frame(scene: DeviceScene, consts: FrameConstants,
                 cfg: RenderConfig, stats: dict = None,
                 mark=None) -> torch.Tensor:
    """One full frame -> (H, W, 4) float32 linear color (see module doc).

    cfg.use_pallas selects the rasters: the CUDA kernels of ops.raster
    (the main view and the cascade atlas, one launch each), or the
    pure-tensor binned raster of ops.rasterizer (the main view, and each
    cascade in its own viewport, render_shadow_maps), the JAX package's
    XLA path. Only the cfg selects; neither path stands in for the other.

    stats (optional dict) receives the rasters' and the compacted passes'
    overflow flags as 0-d bool tensors ("main_overflowed",
    "shadow_overflowed", on the pure-tensor path "main_bin_overflowed"
    and "shadow_bin_overflowed", "shade_tiles_overflowed",
    "ssao_tiles_overflowed", with the alpha layer's shadow punch
    "alpha_window_overflowed"), read by nobody here, so the frame never
    waits on the device.

    mark (optional), the frame trace's hook (app/profiler.FrameTrace
    .mark): called with "start" before the frame's first op and with
    each stage's name (FRAME_STAGES, app/profiler.profile_frame's keys)
    after its last: "raster_main" (the main view's vertex stage, clip,
    binning, records and raster), "alpha_merge_main" (with the alpha
    layer), "resolve_gbuffer", "shadow_maps_x4" (the atlas's binning,
    records and raster), "alpha_merge_shadow" (with the alpha layer),
    "ssao" (occlusion and blurs), "shadow_factor" (light 0's PCF factor,
    with shadows on), "direct_light" (the light loops, direct_light) and
    "lighting" (the SSAO upsample, the ambient, tonemap and sky of
    finish_lighting, and the debug overlay); a stage the cfg turns off is
    not marked. With mark, stats also receives the counts the capacities
    bound, under capacity_requirements' keys, as device tensors:
    "main_pairs" and "shadow_pairs" (the pairs binned), and with the
    compacted passes "shade_tiles" and "ssao_tiles" (the tiles they
    evaluate); with the alpha layer "alpha_unresolved" (alpha_merge_main)
    and "alpha_window" (alpha_merge_shadow); with the Blinn-Phong loop
    over local lights "light_reach_pairs", the (local light, covered
    pixel) pairs within the light's falloff_end, and "covered_pixels"
    (direct_light). Without mark the frame is the same ops as with it,
    less the marks and the counts' bookkeeping."""
    H, W = cfg.height, cfg.width
    dev = consts.view_proj.device
    stats = {} if stats is None else stats
    occ = main_occ = None  # the counts' dicts, with mark only
    if mark is not None:
        occ, main_occ = stats, {}
        mark("start")

    # vertex stage + near-plane clip + main rasterization (one visibility
    # buffer feeds the normal/depth, G-buffer and lighting passes)
    tris, tri_attr = main_view_tris(scene, consts, cfg)
    if cfg.use_pallas:
        depth, tid, stats["main_overflowed"] = raster.rasterize(
            tris, W, H, cfg.pair_capacity, occupancy=main_occ)
    else:
        depth, tid, stats["main_overflowed"], \
            stats["main_bin_overflowed"] = rz.binned_raster(
                tris, W, H, cfg.pair_capacity, cfg.bin_cap,
                occupancy=main_occ)
    if mark is not None:
        occ["main_pairs"] = main_occ["pairs"]
        mark("raster_main")

    alpha_on = alpha_enabled(scene, cfg)
    if alpha_on:
        depth, tid, tris, tri_attr = alpha_merge_main(
            scene, consts, cfg, depth, tid, tris, tri_attr, occupancy=occ)
        if mark is not None:
            mark("alpha_merge_main")

    g = resolve_gbuffer(scene, consts, cfg, tris, depth, tid, tri_attr,
                        stats=stats, occupancy=occ)
    if mark is not None:
        mark("resolve_gbuffer")

    if cfg.shadows_enabled:
        shadow_maps = render_shadow_maps(scene, consts, cfg, stats, occ)
        if mark is not None:
            mark("shadow_maps_x4")
        if alpha_on:
            shadow_maps = alpha_merge_shadow(scene, consts, cfg,
                                             shadow_maps, stats, occ)
            if mark is not None:
                mark("alpha_merge_shadow")
    else:
        shadow_maps = torch.ones((cfg.num_cascades, 2, 2),
                                 dtype=torch.float32, device=dev)

    if cfg.ssao_enabled:
        access_half = ssao_pass(scene, consts, cfg, g["normal_v"], depth,
                                valid=tid >= 0, stats=stats, occupancy=occ)
        if mark is not None:
            mark("ssao")

    sf = None
    if cfg.shadows_enabled:
        sf = shadow_factor_pass(consts, cfg, g, shadow_maps)
        if mark is not None:
            mark("shadow_factor")
    reach = None
    if (mark is not None and not cfg.use_pbr
            and cfg.num_point_lights + cfg.num_spot_lights):
        reach = torch.zeros_like(g["roughness"])
    lit = direct_light(scene, consts, cfg, g, sf, in_reach=reach)
    if mark is not None:
        if reach is not None:
            occ["light_reach_pairs"] = (reach[..., 0].to(torch.int64)
                                        * g["valid"]).sum()
            occ["covered_pixels"] = g["valid"].sum()
        mark("direct_light")

    if cfg.ssao_enabled:
        ambient_access = _upsample_bilinear(access_half, H, W)
    else:
        ambient_access = torch.ones((H, W), dtype=torch.float32, device=dev)
    img = finish_lighting(scene, consts, cfg, g, lit, ambient_access)
    img = apply_debug_overlay(consts, cfg, img, shadow_maps, g["pos_w"])
    if mark is not None:
        mark("lighting")
    return img


def apply_debug_overlay(consts: FrameConstants, cfg: RenderConfig,
                        img: torch.Tensor, shadow_maps: torch.Tensor,
                        pos_w: torch.Tensor, row_offset: int = 0,
                        full_height: int = None) -> torch.Tensor:
    """Debug-layer overlays on the lit image (`img`/`pos_w` may be a row
    band whose first row is global row `row_offset` of a
    `full_height`-row screen).

    - ShadowDebug.hlsl quad (CRYCHIC.cpp:406-407, PSO "debug"): the
      reference's forward branch always draws the shadow-map blit quad;
      drawn whenever the forward path has shadow maps to show, or on
      demand with cfg.debug_view == "shadow_cascade3".
    - "cascades": Default.hlsl:152-156 (commented out in the reference)
      colorizes pixels by their selected cascade.
    """
    H, W = img.shape[:2]
    full_h = H if full_height is None else full_height
    dev = img.device
    draw_quad = cfg.debug_view == "shadow_cascade3" or (
        not cfg.deferred and cfg.shadows_enabled and cfg.debug_view is None)
    if draw_quad:
        # blit gShadowMap[3] onto the debug quad, which
        # CreateQuad(0,0,1,1,0) places in the bottom-right screen quadrant
        qh, qw = full_h // 2, W // 2
        S = shadow_maps.shape[1]
        # row within the quad (<0 above it)
        qy = torch.arange(H, device=dev) + row_offset - (full_h - qh)
        ys = torch.div(torch.clamp(qy, 0, qh - 1) * S, qh,
                       rounding_mode="floor")
        xs = torch.div(torch.arange(qw, device=dev) * S, qw,
                       rounding_mode="floor")
        blit = shadow_maps[3][ys[:, None], xs[None, :]]  # (H, qw)
        patch = torch.cat([blit[..., None].expand(H, qw, 3),
                           torch.ones_like(blit[..., None])], dim=-1)
        right = torch.where((qy >= 0)[:, None, None], patch, img[:, W - qw:])
        img = torch.cat([img[:, :W - qw], right], dim=1)
    elif cfg.debug_view == "cascades":
        from ..models.cascades import CASCADE_RADII

        radii = device_constant(tuple(CASCADE_RADII), torch.float32, dev)
        dist = torch.sqrt(((consts.eye_pos - pos_w) ** 2).sum(-1))
        past = (dist[..., None] >= radii).sum(-1)
        colors = device_constant(((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1),
                                  (0.3, 0.3, 0.3)), torch.float32, dev)
        img = torch.cat([colors[torch.clamp(past, 0, 4)], img[..., 3:4]],
                        dim=-1)
    return img
