"""The reference frame: one frame of a scene at a camera pose and a time,
rendered eagerly by the frozen plain path of this package.

It repeats what the port's Renderer derives from the same inputs (the
texture pair pool, the sky cube, the device scene, the camera matrices,
the cascade fit, the culling masks, BoltAnim's pair indices and the raster
pair capacities at the pose), then ``passes.frame.render_frame`` with the
plain rasterizer, the plain PCF and the dense shading passes (no tile
compaction), in float32 with TF32 off unless the caller asks for TF32
(the lower-precision control).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from .io import dds
from .models import cascades as casc
from .models.camera import BoundingFrustum, cull_instances
from .ops import raster, sampling, ssao as ssao_ops
from .passes import frame as fr

# Texture slot names -> DDS file names (LoadTextures, CRYCHIC.cpp:939-974).
_TEXTURE_FILES = {
    "bricks2": "bricks2.dds", "bricks2_nmap": "bricks2_nmap.dds",
    "tile": "tile.dds", "tile_nmap": "tile_nmap.dds",
    "white1x1": "white1x1.dds", "default_nmap": "default_nmap.dds",
    "WoodCrate01": "WoodCrate01.dds", "WoodCrate02": "WoodCrate02.dds",
    "bricks": "bricks.dds", "bricks_nmap": "bricks_nmap.dds",
    "stone": "stone.dds", "checkboard": "checkboard.dds", "ice": "ice.dds",
    "grass": "grass.dds", "WireFence": "WireFence.dds",
    "water1": "water1.dds",
}
# animated texture slots: name -> (frames dir, subsample step, fps)
_ANIM_SLOTS = {"bolt_anim": ("BoltAnim", 4, 30.0),
               "fire_anim": ("FireAnim", 8, 30.0)}


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products and convolutions on (tf32=True) or off inside
    the block; the previous settings come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def load_texture_chains(names, asset_dir):
    """Mip chains of the named slots from the DDS files (and the BMP frames
    of the animated slots) under asset_dir; a missing file is a white 1x1.
    Returns (chains, {slot: ([frame chains], fps)})."""
    white = [np.full((1, 1, 4), 255, np.uint8)]
    chains, anim_frames = [], {}
    for slot, name in enumerate(names):
        if name == "sky_cube":
            chains.append(white)
            continue
        if name in _ANIM_SLOTS:
            subdir, step, fps = _ANIM_SLOTS[name]
            d = os.path.join(asset_dir, subdir) if asset_dir else ""
            files = sorted(os.listdir(d))[::step] if os.path.isdir(d) else []
            frames = [dds.generate_mips(dds.load_bmp(os.path.join(d, f)))
                      for f in files] or [white]
            chains.append(frames[0])
            anim_frames[slot] = (frames, fps)
            continue
        fn = _TEXTURE_FILES.get(name)
        if (fn is None or not asset_dir
                or not os.path.exists(os.path.join(asset_dir, fn))):
            chains.append(white)
            continue
        mips = dds.load_dds(os.path.join(asset_dir, fn)).mips
        if len(mips) == 1 and mips[0].shape[0] > 1:
            mips = dds.generate_mips(mips[0])
        chains.append(mips)
    return chains, anim_frames


def build_pair_pool(scene, asset_dir, dual: bool = True):
    """(pool, mat_pair (M,) int32, {material: (first pair, frames, fps)}):
    static (diffuse, normal) pairs deduplicated into the big class, one
    small-class pair per frame of an animated material."""
    chains, anim_frames = load_texture_chains(scene.texture_names, asset_dir)
    mb = scene.material_bank
    dmap = np.asarray(mb.diffuse_map_index)
    nmap = np.asarray(mb.normal_map_index)
    big, key_to_idx, small = [], {}, []
    mat_pair = np.zeros(len(dmap), np.int32)
    anim_local = {}
    for m in range(len(dmap)):
        d, n = int(dmap[m]), int(nmap[m])
        if d in anim_frames:
            frames, fps = anim_frames[d]
            anim_local[m] = (len(small), len(frames), fps)
            small += [(fc, chains[n]) for fc in frames]
        else:
            if (d, n) not in key_to_idx:
                key_to_idx[(d, n)] = len(big)
                big.append((chains[d], chains[n]))
            mat_pair[m] = key_to_idx[(d, n)]
    n_big = len(big)
    for m, (first, _, _) in anim_local.items():
        mat_pair[m] = n_big + first
    anim = {m: (n_big + first, count, fps)
            for m, (first, count, fps) in anim_local.items()}
    return (sampling.PairPool.build(big + small, n_big, dual=dual),
            mat_pair, anim)


def load_sky_cubemap(path: str) -> np.ndarray:
    """(6, S, S, 4) float faces of a DDS cubemap, D3D face order."""
    tex = dds.load_dds(path)
    if not tex.is_cubemap:
        raise ValueError(f"{path} is not a cubemap")
    faces = np.stack([f[0] for f in tex.faces])
    if faces.dtype == np.uint8:
        return faces.astype(np.float32) / 255.0
    return faces.astype(np.float32)


def _pairs(needed: int) -> int:
    """A pair capacity that holds `needed`: 1.5x, rounded up to 64k."""
    return max(1 << 14, -(-int(needed * 1.5) // 65536) * 65536)


class ReferenceFrame:
    """The scene's device containers, built once; ``render(camera, t)``
    gives the frame at that pose and time."""

    def __init__(self, scene, cfg, lights, device, asset_dir=None,
                 sky_cubemap_path=None):
        if sky_cubemap_path:
            cfg = dataclasses.replace(cfg, procedural_sky=False)
        self.scene, self.lights, self.device = scene, lights, device
        self.cfg = dataclasses.replace(cfg, shade_tile_capacity=None,
                                       ssao_tile_capacity=None)
        pool, self.mat_pair, self.anim = build_pair_pool(
            scene, asset_dir, dual=cfg.dual_mip_rows)
        mb = scene.material_bank
        cube = (load_sky_cubemap(sky_cubemap_path) if sky_cubemap_path
                else sampling.procedural_sky_cubemap(256))

        def t(x):
            return fr._tensor(x, device)

        self.device_scene = fr.attach_draw_statics(fr.DeviceScene(
            opaque=fr.DeviceDraw.from_host(scene.opaque, device),
            shadow=fr.DeviceDraw.from_host(scene.shadow, device),
            alpha=(fr.DeviceDraw.from_host(scene.alpha, device)
                   if scene.alpha is not None else None),
            mat_albedo=t(mb.diffuse_albedo), mat_fresnel=t(mb.fresnel_r0),
            mat_roughness=t(mb.roughness), mat_metalness=t(mb.metalness),
            mat_transform=t(mb.mat_transform), mat_pair=t(self.mat_pair),
            pair_data=t(pool.data), cubemap=t(sampling.pack_cubemap(cube)),
            light_strength=t(lights.strength),
            light_direction=t(lights.direction),
            light_position=t(lights.position),
            light_falloff_start=t(lights.falloff_start),
            light_falloff_end=t(lights.falloff_end),
            light_spot_power=t(lights.spot_power), ambient=t(lights.ambient),
            ssao_offsets=t(ssao_ops.build_offset_vectors()),
            ssao_random_field=t(ssao_ops.build_random_field(
                ssao_ops.build_random_vector_texture(), cfg.ssao_height,
                cfg.ssao_width)),
            ssao_blur_weights=t(ssao_ops.calc_gauss_weights(2.5)),
            n_big_pairs=pool.n_big))

    def _visibility(self, camera, draw) -> np.ndarray:
        if not self.cfg.frustum_culling:
            return np.ones(draw.num_instances, np.float32)
        vis = cull_instances(BoundingFrustum(camera.proj),
                             np.linalg.inv(camera.view),
                             np.linalg.inv(draw.worlds), draw.bounds_center,
                             draw.bounds_extents)
        return (vis | ~draw.cullable).astype(np.float32)

    def constants(self, camera, total_time: float) -> fr.FrameConstants:
        view, proj = camera.view, camera.proj
        ct = casc.fit_cascades(camera, self.lights.direction[0],
                               self.cfg.shadow_map_size)
        alpha = self.scene.alpha
        return fr.FrameConstants.from_numpy(dict(
            alpha_visibility=(self._visibility(camera, alpha)
                              if alpha is not None else None),
            view=view.astype(np.float32), proj=proj.astype(np.float32),
            view_proj=(view @ proj).astype(np.float32),
            inv_proj=np.linalg.inv(proj).astype(np.float32),
            eye_pos=camera.position.astype(np.float32),
            cascade_view_projs=ct.view_projs.astype(np.float32),
            shadow_transforms=ct.shadow_transforms,
            opaque_visibility=self._visibility(camera, self.scene.opaque),
            shadow_visibility=self._visibility(camera, self.scene.shadow),
            total_time=np.float32(total_time)), self.device)

    def _sized(self, consts) -> "RenderConfig":
        """The cfg with pair capacities that hold this frame's pairs."""
        req = fr.capacity_requirements(self.device_scene, consts, self.cfg)
        return dataclasses.replace(
            self.cfg, pair_capacity=_pairs(int(req["main_pairs"])),
            shadow_pair_capacity=_pairs(int(req["shadow_pairs"])))

    def render(self, camera, total_time: float, tf32: bool = False):
        """(H, W, 4) float32 image of the frame at this pose and time, in
        float32 with TF32 off, or with TF32 on (the control)."""
        pair = self.mat_pair.copy()
        for mat, (base, count, fps) in self.anim.items():
            pair[mat] = base + int(total_time * fps) % count
        self.device_scene.mat_pair = fr._tensor(pair, self.device)
        with precision(tf32), torch.no_grad():
            consts = self.constants(camera, total_time)
            stats = {}
            img = fr.render_frame(self.device_scene, consts,
                                  self._sized(consts), stats)
            dropped = [k for k, v in stats.items()
                       if k.endswith("overflowed") and bool(v)]
        if dropped:
            raise RuntimeError(f"the reference frame overflowed: {dropped}")
        return img

    def work(self, camera) -> dict:
        """What the frame at this pose asks of the shadow atlas raster and
        of the soft PCF: the shadow triangles and cascades, the map size,
        the atlas's covered (triangle, texel) fragments, and the pixels the
        main view covers (the receivers, the pixels not sky)."""
        with precision(False), torch.no_grad():
            consts = self.constants(camera, 0.0)
            cfg = self._sized(consts)
            raster.reset_fragments()
            fr.render_shadow_maps(self.device_scene, consts, cfg)
            tris, _ = fr.main_view_tris(self.device_scene, consts, cfg)
            raster.rasterize(tris, cfg.width, cfg.height, cfg.pair_capacity)
            return dict(shadow_triangles=self.scene.shadow.num_triangles,
                        cascades=cfg.num_cascades,
                        map_size=cfg.shadow_map_size,
                        atlas_fragments=int(raster.FRAGMENTS["depth"]),
                        receivers=int(raster.FRAGMENTS["covered_pixels"]))
