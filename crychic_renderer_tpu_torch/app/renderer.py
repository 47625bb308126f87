"""Host-side renderer orchestration (torch counterpart of
``crychic_renderer_tpu.app.renderer``).

Builds the device scene once on the card (``device="cuda"``, the default;
``device="cpu"`` runs the kernels' plain PyTorch versions), computes per-frame
constants (camera matrices, cascade fits, culling masks) on the host,
packs them into one float32 vector (``_pack_frame_constants``, the JAX
package's layout) and runs ``frame_packed``: ``passes.frame.render_frame``
on the unpacked constants for the bound cfg. As the JAX Renderer jits
``frame_packed``, the port captures it on the card into a CUDA graph
(``app/graphs.CompiledFrame``) at the first ``render()`` and replays it
for every later frame; on the CPU it runs eagerly. ``rebind_frame_fn``
binds the frame to the current cfg (``resize`` and ``ensure_capacity``
call it; ``render`` calls it when ``self.cfg`` was replaced), and a
render whose device-scene leaves are not the bound ones captures anew.
The card queues the frames, so the host runs ahead until something reads
a frame — the reference's fence-wait pattern without explicit fences.
The Renderer sizes the raster pair capacities and the tile capacities of
the compacted passes from the start pose (``_autosize_capacity``), and
with ``cfg.use_pallas`` False the pure-tensor raster's per-tile caps
``bin_cap`` and ``shadow_bin_cap`` too. The cfg's ``use_pallas`` is kept
as given on every device: the JAX Renderer turns it off on a CPU backend
(its Mosaic kernel targets the TPU), while on the CPU the port's kernel
path runs the kernels' plain versions, so the CPU renders the path the
cfg names.
Capacity overflows are flagged on the device and OR-ed across frames
inside the frame; ``check_overflow`` reads them when the caller chooses
to wait.
``Renderer(..., trace=True)`` traces every frame from inside
(``app/profiler.FrameTrace``, read through ``self.trace.rows()``): its
host parts in ``render()``, its stages' device time inside the compiled
frame's replay and its counts; with ``trace=False``, the default, the
frame and its graph are those of an untraced build.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..config import RenderConfig
from ..io import dds
from ..models import cascades as casc
from ..models.camera import BoundingFrustum, Camera, cull_instances
from ..models.materials import build_reference_lights
from ..models.scene import Scene
from ..models.scenes_baseline import REFERENCE_DIR
from ..ops import sampling, ssao as ssao_ops
from ..passes import frame as fr
from . import graphs

DEFAULT_ASSET_DIR = os.path.join(REFERENCE_DIR, "Textures")

# Texture slot names -> DDS file stems (LoadTextures, CRYCHIC.cpp:939-974).
_TEXTURE_FILES = {
    "bricks2": "bricks2.dds",
    "bricks2_nmap": "bricks2_nmap.dds",
    "tile": "tile.dds",
    "tile_nmap": "tile_nmap.dds",
    "white1x1": "white1x1.dds",
    "default_nmap": "default_nmap.dds",
    "WoodCrate01": "WoodCrate01.dds",
    "WoodCrate02": "WoodCrate02.dds",
    "bricks": "bricks.dds",
    "bricks_nmap": "bricks_nmap.dds",
    "stone": "stone.dds",
    "checkboard": "checkboard.dds",
    "ice": "ice.dds",
    "grass": "grass.dds",
    "WireFence": "WireFence.dds",
    "water1": "water1.dds",
}

# animated texture slots: name -> (frames dir, subsample step, fps)
_ANIM_SLOTS = {
    "bolt_anim": ("BoltAnim", 4, 30.0),
    "fire_anim": ("FireAnim", 8, 30.0),
}


def load_texture_chains(names, asset_dir=DEFAULT_ASSET_DIR):
    """The named texture slots as mip chains, decoded from the DDS files
    (and the BMP frames of the animated slots) under asset_dir; mips are
    generated for a mipless texture. A missing asset falls back to a white
    1x1 chain, as in the JAX package.

    Returns (chains, anim_frames): chains[slot] = [(H, W, 4) u8 mips];
    anim_frames[slot] = ([per-frame chains], fps) for animated slots
    (the BoltAnim/FireAnim BMP sequences, every `step`-th frame).
    """
    white = [np.full((1, 1, 4), 255, np.uint8)]
    chains = []
    anim_frames = {}
    for slot, name in enumerate(names):
        if name == "sky_cube":
            chains.append(white)  # cube slots don't live in the 2D pool
            continue
        if name in _ANIM_SLOTS:
            subdir, step, fps = _ANIM_SLOTS[name]
            d = os.path.join(asset_dir, subdir)
            files = sorted(os.listdir(d))[::step] if os.path.isdir(d) else []
            frames = [dds.generate_mips(dds.load_bmp(os.path.join(d, f)))
                      for f in files]
            if not frames:
                frames = [white]
            chains.append(frames[0])  # slot shows frame 0
            anim_frames[slot] = (frames, fps)
            continue
        fn = _TEXTURE_FILES.get(name)
        if fn is None or not os.path.exists(os.path.join(asset_dir, fn)):
            chains.append(white)
            continue
        mips = dds.load_dds(os.path.join(asset_dir, fn)).mips
        if len(mips) == 1 and mips[0].shape[0] > 1:
            mips = dds.generate_mips(mips[0])
        chains.append(mips)
    return chains, anim_frames


@contextlib.contextmanager
def synthetic_wire_fence():
    """In the block, load_texture_chains gives the WireFence slot the
    synthetic wire grid of models.scenes_baseline.wire_fence_chain (the
    asset is not in the repository, and the white 1x1 that stands in for
    it passes every alpha clip); the other slots load as before."""
    global load_texture_chains
    from ..models.scenes_baseline import wire_fence_chain

    real = load_texture_chains

    def chains(names, asset_dir=DEFAULT_ASSET_DIR):
        out, anim = real(names, asset_dir)
        return [wire_fence_chain() if n == "WireFence" else c
                for n, c in zip(names, out)], anim

    load_texture_chains = chains
    try:
        yield
    finally:
        load_texture_chains = real


def build_pair_pool(scene: Scene, asset_dir=DEFAULT_ASSET_DIR,
                    dual: bool = True):
    """Build the (diffuse, normal) pair pool for a scene's materials (see
    ops.sampling.PairPool). Static material pairs are deduplicated into
    the big class; animated materials get one small-class pair per
    animation frame.

    Returns (pool (host numpy), mat_pair (M,) int32, anim_specs) where
    anim_specs maps material index -> (first_pair_index, frame_count,
    fps)."""
    chains, anim_frames = load_texture_chains(scene.texture_names, asset_dir)
    mb = scene.material_bank
    dmap = np.asarray(mb.diffuse_map_index)
    nmap = np.asarray(mb.normal_map_index)
    M = len(dmap)

    big_pairs = []  # (diffuse chain, normal chain)
    key_to_idx = {}
    small_pairs = []
    mat_pair = np.zeros(M, np.int32)
    anim_local = {}  # mat -> (local first index in small_pairs, count, fps)
    for m in range(M):
        d, n = int(dmap[m]), int(nmap[m])
        if d in anim_frames:
            frames, fps = anim_frames[d]
            anim_local[m] = (len(small_pairs), len(frames), fps)
            for fc in frames:
                small_pairs.append((fc, chains[n]))
        else:
            key = (d, n)
            if key not in key_to_idx:
                key_to_idx[key] = len(big_pairs)
                big_pairs.append((chains[d], chains[n]))
            mat_pair[m] = key_to_idx[key]
    n_big = len(big_pairs)
    for m, (first, count, fps) in anim_local.items():
        mat_pair[m] = n_big + first
    anim_specs = {m: (n_big + first, count, fps)
                  for m, (first, count, fps) in anim_local.items()}
    pool = sampling.PairPool.build(big_pairs + small_pairs, n_big,
                                   dual=dual)
    return pool, mat_pair, anim_specs


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device without CUDA raises: the
    renderer never falls back to the CPU unless asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA device is available; the renderer "
            f"runs on the card by default, pass device='cpu' to run it on "
            f"the CPU")
    return dev


def load_sky_cubemap(path: str) -> np.ndarray:
    """(6, S, S, 4) float [0,1] faces from a DDS cubemap file, D3D face
    order: the LoadTextures path for gCubeMap (CRYCHIC.cpp:960 requests
    snowcube1024.dds, which the reference repository does not ship; any
    DDS cubemap slots in here). BC6H faces are HDR float32, used as they
    are."""
    tex = dds.load_dds(path)
    if not tex.is_cubemap:
        raise ValueError(f"{path} is not a cubemap")
    faces = np.stack([f[0] for f in tex.faces])
    if faces.dtype == np.uint8:
        return faces.astype(np.float32) / 255.0
    return faces.astype(np.float32)


def build_device_scene(scene: Scene, asset_dir=DEFAULT_ASSET_DIR,
                       lights=None, ssao_dims=(540, 960),
                       sky_cubemap_path: str = None,
                       dual_mip_rows: bool = True, device="cuda"):
    """The scene's device containers on `device`, static tables attached;
    the sky cube is the file at sky_cubemap_path, else the procedural
    sky's. Returns (DeviceScene, anim_specs)."""
    device = resolve_device(device)
    if lights is None:
        lights = build_reference_lights()
    pool, mat_pair, anim_specs = build_pair_pool(scene, asset_dir,
                                                 dual=dual_mip_rows)
    mb = scene.material_bank
    if sky_cubemap_path:
        cubemap = sampling.pack_cubemap(load_sky_cubemap(sky_cubemap_path))
    else:
        cubemap = sampling.pack_cubemap(sampling.procedural_sky_cubemap(256))

    def t(x):
        return fr._tensor(x, device)

    return fr.attach_draw_statics(fr.DeviceScene(
        opaque=fr.DeviceDraw.from_host(scene.opaque, device),
        shadow=fr.DeviceDraw.from_host(scene.shadow, device),
        alpha=(fr.DeviceDraw.from_host(scene.alpha, device)
               if scene.alpha is not None else None),
        mat_albedo=t(mb.diffuse_albedo),
        mat_fresnel=t(mb.fresnel_r0),
        mat_roughness=t(mb.roughness),
        mat_metalness=t(mb.metalness),
        mat_transform=t(mb.mat_transform),
        mat_pair=t(mat_pair),
        pair_data=t(pool.data),
        cubemap=t(cubemap),
        light_strength=t(lights.strength),
        light_direction=t(lights.direction),
        light_position=t(lights.position),
        light_falloff_start=t(lights.falloff_start),
        light_falloff_end=t(lights.falloff_end),
        light_spot_power=t(lights.spot_power),
        ambient=t(lights.ambient),
        ssao_offsets=t(ssao_ops.build_offset_vectors()),
        ssao_random_field=t(ssao_ops.build_random_field(
            ssao_ops.build_random_vector_texture(), *ssao_dims)),
        ssao_blur_weights=t(ssao_ops.calc_gauss_weights(2.5)),
        n_big_pairs=pool.n_big,
    )), anim_specs


class CapacityError(RuntimeError):
    """A frame would expand more raster pairs, or need more compacted
    tiles, than a sized capacity holds."""


# The frame's overflow flags (passes.frame.render_frame's stats keys) and
# what check_overflow says of each.
_OVERFLOWS = {
    "main_overflowed": "main raster overflow: pairs past pair_capacity "
                       "were dropped",
    "shadow_overflowed": "shadow raster overflow: pairs past "
                         "shadow_pair_capacity were dropped",
    "shade_tiles_overflowed": "shade tile overflow: covered tiles past "
                              "shade_tile_capacity were shaded as sky",
    "ssao_tiles_overflowed": "ssao tile overflow: tiles past "
                             "ssao_tile_capacity took no occlusion",
    "main_bin_overflowed": "main tile overflow: triangles past bin_cap in "
                           "a tile were dropped",
    "shadow_bin_overflowed": "shadow tile overflow: triangles past "
                             "shadow_bin_cap in a tile were dropped",
    "alpha_window_overflowed": "alpha shadow window overflow: the alpha "
                               "layer's light-space extent in a cascade "
                               "passed alpha_shadow_window; its shadow "
                               "holes past the window were lost",
}


class Renderer:
    """Owns the device scene; produces frames on `device` (the card unless
    the caller asks for the CPU). With trace=True every frame is traced
    (``trace``, an app/profiler.FrameTrace): rebind_frame_fn binds the
    trace's marks and counts into the frame, and render() records its
    host parts."""

    def __init__(self, scene: Scene, cfg: RenderConfig,
                 camera: Camera = None, asset_dir=DEFAULT_ASSET_DIR,
                 lights=None, auto_capacity: bool = True,
                 sky_cubemap_path: str = None, device="cuda",
                 trace: bool = False):
        self.device = resolve_device(device)
        if sky_cubemap_path and cfg.procedural_sky:
            # a file-loaded sky is sampled from its cube, not evaluated
            cfg = dataclasses.replace(cfg, procedural_sky=False)
        self.scene = scene
        self.cfg = cfg
        self.camera = camera or self._default_camera()
        self.light_dir0 = (lights.direction[0] if lights is not None
                           else build_reference_lights().direction[0])
        self.device_scene, self.anim_specs = build_device_scene(
            scene, asset_dir, lights,
            ssao_dims=(cfg.ssao_height, cfg.ssao_width),
            sky_cubemap_path=sky_cubemap_path,
            dual_mip_rows=cfg.dual_mip_rows, device=self.device)
        # a copy: on the CPU the tensor's numpy view shares its memory,
        # and _animate_materials writes into the tensor
        self._base_mat_pair = self.device_scene.mat_pair.cpu().numpy().copy()
        self._auto_capacity = auto_capacity
        if auto_capacity:
            self._autosize_capacity()
        self._overflow = {k: torch.zeros((), dtype=torch.bool,
                                         device=self.device)
                          for k in _OVERFLOWS}
        self._frame_fn = None
        self.trace = None
        if trace:
            from .profiler import FrameTrace

            self.trace = FrameTrace(self.device)
        self.rebind_frame_fn()

    def capacity_requirements(self, total_time: float = 0.0) -> dict:
        """Exact (tile, triangle) pair counts and largest per-tile counts
        of the frame's rasters for the current camera (the atlas counted
        as it is binned), and the tiles the compacted passes need
        (passes.frame.capacity_requirements)."""
        consts = self.frame_constants(total_time)
        req = fr.capacity_requirements(self.device_scene, consts, self.cfg)
        return {k: int(v) for k, v in req.items()}

    def _autosize_capacity(self):
        """Size the static capacities from the initial camera's counts, as
        the JAX package does: the raster pairs with 1.5x headroom rounded
        up to 64k pairs, at least 16k; the compacted passes' tiles with
        1.25x headroom rounded up to 64 tiles, at least 64 and at most the
        whole tile grid (the shade tiles always, the SSAO tiles with SSAO
        on). The tile capacity sets how many tiles the passes evaluate
        every frame, so its headroom is smaller: a pose that outruns it is
        reported (check_capacity, check_overflow) or grown
        (ensure_capacity). With use_pallas False the pure-tensor raster
        truncates each tile's run at bin_cap (main view) and
        shadow_bin_cap (each cascade), so both are sized as the JAX
        package sizes them: twice the largest run rounded up to 32, at
        least 64."""
        req = self.capacity_requirements(0.0)
        cfg = self.cfg

        def size(needed):
            return max(1 << 14, -(-int(needed * 1.5) // 65536) * 65536)

        def tiles(needed, h, w, tile_h, tile_w):
            grid = -(-h // tile_h) * -(-w // tile_w)
            return min(grid, max(64, -(-int(needed * 1.25) // 64) * 64))

        kw = dict(pair_capacity=size(req["main_pairs"]),
                  shadow_pair_capacity=size(req["shadow_pairs"]),
                  shade_tile_capacity=tiles(
                      req["shade_tiles"], cfg.height, cfg.width,
                      fr.SHADE_TILE_H, fr.SHADE_TILE_W))
        if cfg.ssao_enabled:
            kw["ssao_tile_capacity"] = tiles(
                req["ssao_tiles"], cfg.ssao_height, cfg.ssao_width,
                fr.SSAO_TILE_H, fr.SSAO_TILE_W)
        if not cfg.use_pallas:
            kw["bin_cap"] = max(64, -(-(req["main_max_tile"] * 2) // 32) * 32)
            kw["shadow_bin_cap"] = max(
                64, -(-(req["shadow_max_tile"] * 2) // 32) * 32)
        self.cfg = dataclasses.replace(cfg, **kw)

    def resize(self, width: int, height: int):
        """The OnResize analogue (the reference's d3dApp.cpp:141 +
        CRYCHIC::OnResize, CRYCHIC.cpp:110-128): rebuild every
        resolution-dependent piece of state — the camera lens aspect (its
        culling frustum is derived per frame), the SSAO random-vector
        field at the new SSAO grid, and the auto-sized raster and tile
        capacities — and rebind the frame (``rebind_frame_fn``): on the
        card the next render() captures the new shapes into a new CUDA
        graph, as the JAX package re-jits its frame."""
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)
        cam = self.camera
        cam.set_lens(cam.fov_y, width / height, cam.near_z, cam.far_z)
        self.device_scene.ssao_random_field = fr._tensor(
            ssao_ops.build_random_field(
                ssao_ops.build_random_vector_texture(),
                self.cfg.ssao_height, self.cfg.ssao_width), self.device)
        if self._auto_capacity:
            self._autosize_capacity()
        self.rebind_frame_fn()

    def rebind_frame_fn(self):
        """Bind the frame to the CURRENT self.cfg: frame_packed(scene,
        packed) unpacks the constants and renders with this cfg, OR-ing
        the frame's overflow flags into the Renderer's. On the card it
        runs as a CUDA graph captured at the next render()
        (graphs.CompiledFrame; the graph of the cfg bound before is freed
        now), on the CPU eagerly. The JAX Renderer must be rebound after
        an outside change of self.cfg; this one's render() rebinds
        itself when self.cfg differs from the bound cfg, and its graph
        captures anew when a device-scene leaf is not the bound tensor.
        A traced Renderer's frame also hands render_frame the trace's
        mark hook and writes the frame's counts into the trace
        (FrameTrace.mark, write_counts), so the graph holds them."""
        cfg = self.cfg
        n_op = self.scene.opaque.num_instances
        n_sh = self.scene.shadow.num_instances
        n_al = (self.scene.alpha.num_instances
                if self.scene.alpha is not None else 0)
        unpack = self._unpack_frame_constants
        flags = self._overflow
        trace = self.trace
        hook = {} if trace is None else dict(mark=trace.mark)

        def frame_packed(scene, packed):
            consts = unpack(packed, n_op, n_sh, n_al)
            stats = {}
            img = fr.render_frame(scene, consts, cfg, stats, **hook)
            for k, flag in flags.items():
                if k in stats:
                    flag |= stats[k]
            if trace is not None:
                trace.write_counts(stats)
            return img

        self.close()
        self._frame_fn = (graphs.CompiledFrame(frame_packed, self.device)
                          if self.device.type == "cuda" else frame_packed)
        self._bound_cfg = cfg

    @property
    def compiled_frame(self):
        """The frame's graphs.CompiledFrame on the card (its capture_ms,
        pool_bytes and launches per replay), None on the CPU."""
        fn = self._frame_fn
        return fn if isinstance(fn, graphs.CompiledFrame) else None

    def close(self):
        """Free the frame's CUDA graph, its memory pool and its texture
        objects (also done when the Renderer is collected); the next
        render() captures anew."""
        if self.compiled_frame is not None:
            self.compiled_frame.release()

    def check_capacity(self, total_time: float = 0.0) -> dict:
        """Raise CapacityError if the current camera's frame would expand
        more raster pairs, bin more triangles in a tile of the
        pure-tensor raster, or need more compacted tiles, than a sized
        capacity holds (callable per frame from an app loop; it waits for
        the device). Returns the counts (capacity_requirements)."""
        req = self.capacity_requirements(total_time)
        check_counts(self.cfg, req["main_pairs"], req["shadow_pairs"],
                     req["shade_tiles"], req["ssao_tiles"],
                     req["main_max_tile"], req["shadow_max_tile"])
        return req

    def ensure_capacity(self, total_time: float = 0.0) -> dict:
        """check_capacity, but GROW instead of raising: when the pose
        outruns the sized capacities, size them again at this pose and
        rebind the frame (on the card, one capture at the next render).
        Returns the counts."""
        try:
            return self.check_capacity(total_time)
        except CapacityError:
            self._autosize_capacity()
            self.rebind_frame_fn()
            return self.check_capacity(total_time)

    def viewer_step_fn(self, disp_rows: int, disp_cols: int):
        """One frame for the interactive loop, display-sized: returns
        step(scene, consts) -> (disp (disp_rows, disp_cols, 3) uint8, the
        exact main_pairs and shadow_pairs of that frame and its
        shade_tiles and ssao_tiles, as 0-d tensors), all on the device and
        queued without waiting for it, so the pipelined viewer fetches a
        small image and raises on overflow frames later (check_counts)
        instead of dropping geometry or shading covered tiles as sky. The
        counts come from passes.frame.capacity_requirements, which repeats
        the frame's front end (the JAX package's jit shares it; its step
        returns the pair counts only).

        On the card the step is its own CUDA graph (graphs.CompiledFrame,
        the counterpart of the JAX package's ``jax.jit(step)``): the
        first call captures it, later calls copy consts into it and
        replay, and each returns fresh tensors. The display rows and
        columns are sampled from the frame size at this call; after
        resize(), ask for a new step. A step whose Renderer's cfg was
        replaced since (grown capacities) binds the new cfg and captures
        anew."""
        H, W = self.cfg.height, self.cfg.width
        ys = fr._tensor(np.linspace(0, H - 1, disp_rows).astype(np.int64),
                        self.device)
        xs = fr._tensor(np.linspace(0, W - 1, disp_cols).astype(np.int64),
                        self.device)
        bound = {}

        def frame(cfg, names):
            def run(scene, *leaves):
                consts = fr.FrameConstants(**dict(zip(names, leaves)))
                img = fr.render_frame(scene, consts, cfg)
                req = fr.capacity_requirements(scene, consts, cfg)
                disp = (torch.clamp(img[ys][:, xs, :3], 0.0, 1.0) * 255.0
                        + 0.5).to(torch.uint8)
                return (disp, req["main_pairs"], req["shadow_pairs"],
                        req["shade_tiles"], req["ssao_tiles"])

            return run

        def step(scene, consts):
            cfg = self.cfg
            if (cfg.height, cfg.width) != (H, W):
                raise ValueError(
                    f"the renderer was resized to {cfg.width}x{cfg.height} "
                    f"after this step was made for {W}x{H}")
            names = tuple(f.name for f in dataclasses.fields(consts)
                          if isinstance(getattr(consts, f.name),
                                        torch.Tensor))
            if bound.get("key") != (cfg, names):
                if isinstance(bound.get("fn"), graphs.CompiledFrame):
                    bound["fn"].release()
                fn = frame(cfg, names)
                bound.update(key=(cfg, names), fn=(
                    graphs.CompiledFrame(fn, self.device)
                    if self.device.type == "cuda" else fn))
            return bound["fn"](scene, *(getattr(consts, n) for n in names))

        return step

    def check_overflow(self):
        """Raise if any frame since the last call outran a sized capacity:
        dropped raster pairs, had more tiles to shade than a compacted
        pass's slots, or had an alpha layer wider in light space than the
        shadow punch's window (cfg.alpha_shadow_window, which the
        Renderer does not size). This is the one place that waits for the
        device; render() itself never does."""
        flags = torch.stack(list(self._overflow.values())).tolist()
        for v in self._overflow.values():
            v.zero_()
        said = [_OVERFLOWS[k] for k, f in zip(self._overflow, flags) if f]
        if said:
            cfg = self.cfg
            raise RuntimeError(
                f"{'; '.join(said)} (a frame's pose outran the capacities: "
                f"pair_capacity {cfg.pair_capacity}, shadow_pair_capacity "
                f"{cfg.shadow_pair_capacity}, shade_tile_capacity "
                f"{cfg.shade_tile_capacity}, ssao_tile_capacity "
                f"{cfg.ssao_tile_capacity}, bin_cap {cfg.bin_cap}, "
                f"shadow_bin_cap {cfg.shadow_bin_cap}, alpha_shadow_window "
                f"{cfg.alpha_shadow_window})")

    def _default_camera(self):
        cam = Camera()
        cam.set_position(0.0, 2.0, -15.0)  # CRYCHIC.cpp:46
        cam.set_lens(0.25 * np.pi, self.cfg.width / self.cfg.height,
                     1.0, 100.0)  # CRYCHIC.cpp:114
        return cam

    # -- per-frame host update (CRYCHIC::Update) ---------------------------
    def frame_constants_np(self, total_time: float = 0.0) -> dict:
        """Per-frame constants as HOST numpy leaves, keyed by the
        FrameConstants field names."""
        c = self._view_constants(total_time)
        c.update(self._visibilities())
        return c

    def _view_constants(self, total_time: float) -> dict:
        """frame_constants_np's camera matrices, cascade fit and time."""
        cam = self.camera
        view = cam.view
        proj = cam.proj
        ct = casc.fit_cascades(cam, self.light_dir0, self.cfg.shadow_map_size)
        return dict(
            view=view.astype(np.float32),
            proj=proj.astype(np.float32),
            view_proj=(view @ proj).astype(np.float32),
            inv_proj=np.linalg.inv(proj).astype(np.float32),
            eye_pos=cam.position.astype(np.float32),
            cascade_view_projs=ct.view_projs.astype(np.float32),
            shadow_transforms=ct.shadow_transforms,
            total_time=np.float32(total_time),
        )

    def _visibilities(self) -> dict:
        """frame_constants_np's culling masks."""
        return dict(
            alpha_visibility=(self._visibility(self.scene.alpha)
                              if self.scene.alpha is not None else None),
            opaque_visibility=self._visibility(self.scene.opaque),
            shadow_visibility=self._visibility(self.scene.shadow),
        )

    def frame_constants(self, total_time: float = 0.0) -> fr.FrameConstants:
        return fr.FrameConstants.from_numpy(
            self.frame_constants_np(total_time), self.device)

    def _visibility(self, draw) -> np.ndarray:
        """Per-instance frustum culling (UpdateInstanceData,
        CRYCHIC.cpp:515-557), vectorized over all instances. Non-cullable
        instances (the OpaqueShadow layer) always pass."""
        if not self.cfg.frustum_culling:
            return np.ones(draw.num_instances, np.float32)
        frustum = BoundingFrustum(self.camera.proj)
        inv_view = np.linalg.inv(self.camera.view)
        inv_worlds = np.linalg.inv(draw.worlds)
        vis = cull_instances(frustum, inv_view, inv_worlds,
                             draw.bounds_center, draw.bounds_extents)
        return (vis | ~draw.cullable).astype(np.float32)

    # -- frame -------------------------------------------------------------
    def _animate_materials(self, total_time: float):
        """Cycle animated texture slots by rewriting material->pair
        indices: a host-side update, uploaded without waiting for the
        frames in flight and copied INTO the scene's mat_pair tensor on
        the stream, which the captured frame reads (assigning a new
        tensor would leave the graph reading the old one)."""
        if not self.anim_specs:
            return
        pair = self._base_mat_pair.copy()
        for mat, (base, count, fps) in self.anim_specs.items():
            pair[mat] = base + int(total_time * fps) % count
        self.device_scene.mat_pair.copy_(fr.upload(pair, self.device))

    # -- packed per-frame constants (the JAX Renderer's layout) -------------
    # One flat float32 vector per frame, in the JAX package's field order,
    # so both packages pack bit-equal vectors: one pinned upload, and on
    # the card one copy into the compiled frame's static input.

    def _pack_frame_constants(self, c: dict) -> np.ndarray:
        """frame_constants_np's leaves as one float32 vector: view, proj,
        view_proj, inv_proj, eye_pos, cascade_view_projs,
        shadow_transforms, total_time, the opaque and shadow visibility,
        then the alpha visibility where the scene has an alpha layer."""
        parts = [np.asarray(c[k], np.float32).ravel() for k in (
            "view", "proj", "view_proj", "inv_proj", "eye_pos",
            "cascade_view_projs", "shadow_transforms")]
        parts.append(np.float32([c["total_time"]]).ravel())
        parts += [np.asarray(c[k], np.float32).ravel()
                  for k in ("opaque_visibility", "shadow_visibility")]
        if c.get("alpha_visibility") is not None:
            parts.append(np.asarray(c["alpha_visibility"], np.float32).ravel())
        return np.concatenate(parts)

    @staticmethod
    def _unpack_frame_constants(packed: torch.Tensor, n_op: int, n_sh: int,
                                n_al: int) -> fr.FrameConstants:
        """Inverse of _pack_frame_constants: views of `packed` at static
        offsets (no kernel, no copy)."""
        o = [0]

        def take(n, shape=None):
            v = packed[o[0]:o[0] + n]
            o[0] += n
            return v.reshape(shape) if shape else v

        return fr.FrameConstants(
            view=take(16, (4, 4)), proj=take(16, (4, 4)),
            view_proj=take(16, (4, 4)), inv_proj=take(16, (4, 4)),
            eye_pos=take(3), cascade_view_projs=take(64, (4, 4, 4)),
            shadow_transforms=take(64, (4, 4, 4)),
            total_time=take(1)[0],
            opaque_visibility=take(n_op),
            shadow_visibility=take(n_sh),
            alpha_visibility=take(n_al) if n_al else None)

    def render(self, total_time: float = 0.0) -> torch.Tensor:
        """Queue one frame -> a new (H, W, 4) float32 tensor on the
        device. The host never waits for the card here: the packed
        constants go up in one pinned asynchronous copy (and BoltAnim's
        pair indices in another), then frame_packed runs — on the card
        as one replay of its CUDA graph (captured at the first call,
        after one eager frame), and the image is a clone of the graph's
        output, so frames queue back to back until something reads one.
        A cfg replaced since the last bind is bound first. A traced
        Renderer records the four parts of this call (HOST_PARTS of
        app/profiler.py) as the frame's host spans; untraced, each part's
        span is a context that does nothing."""
        trace = self.trace
        span = _no_span if trace is None else trace.part
        if trace is not None:
            trace.begin_frame()
        with span("constants"):
            if self.cfg != self._bound_cfg:
                self.rebind_frame_fn()
            c = self._view_constants(total_time)
        with span("cull"):
            c.update(self._visibilities())
        with span("upload"):
            self._animate_materials(total_time)
            packed = fr.upload(self._pack_frame_constants(c), self.device)
        with span("launch"):
            img = self._frame_fn(self.device_scene, packed)
        if trace is not None:
            trace.end_frame()
        return img

    def render_np(self, total_time: float = 0.0) -> np.ndarray:
        img = self.render(total_time).cpu().numpy()
        return np.clip(img, 0.0, 1.0)


def _no_span(part: str):
    """An untraced render()'s span of one of its parts: nothing."""
    return _NO_SPAN


_NO_SPAN = contextlib.nullcontext()


def check_counts(cfg, main_pairs: int, shadow_pairs: int, shade_tiles: int,
                 ssao_tiles: int, main_max_tile: int = None,
                 shadow_max_tile: int = None):
    """Raise CapacityError where a frame's counts (capacity_requirements'
    keys) exceed cfg's capacities; a tile capacity of None (dense) holds
    any count, as does ssao_tile_capacity with SSAO off. With use_pallas
    False the largest per-tile counts, where given, must fit bin_cap and
    shadow_bin_cap (the pure-tensor raster truncates a longer run; the
    kernels take every pair of a run, as in the JAX package). The
    viewer's step returns the pair and tile counts only, as the JAX
    viewer's does."""
    if main_pairs > cfg.pair_capacity:
        raise CapacityError(
            f"main raster overflow: {main_pairs} pairs > pair_capacity "
            f"{cfg.pair_capacity}")
    if shadow_pairs > cfg.shadow_pair_capacity:
        raise CapacityError(
            f"shadow raster overflow: {shadow_pairs} pairs > "
            f"shadow_pair_capacity {cfg.shadow_pair_capacity}")
    if (not cfg.use_pallas and main_max_tile is not None
            and main_max_tile > cfg.bin_cap):
        raise CapacityError(
            f"tile overflow: {main_max_tile} triangles in one tile > "
            f"bin_cap {cfg.bin_cap}")
    if (not cfg.use_pallas and shadow_max_tile is not None
            and shadow_max_tile > cfg.shadow_bin_cap):
        raise CapacityError(
            f"shadow tile overflow: {shadow_max_tile} triangles in one tile "
            f"> shadow_bin_cap {cfg.shadow_bin_cap}")
    if cfg.shade_tile_capacity and shade_tiles > cfg.shade_tile_capacity:
        raise CapacityError(
            f"shade tile overflow: {shade_tiles} occupied tiles > "
            f"shade_tile_capacity {cfg.shade_tile_capacity}")
    if (cfg.ssao_enabled and cfg.ssao_tile_capacity
            and ssao_tiles > cfg.ssao_tile_capacity):
        raise CapacityError(
            f"ssao tile overflow: {ssao_tiles} occupied tiles > "
            f"ssao_tile_capacity {cfg.ssao_tile_capacity}")


def write_png(path: str, img: np.ndarray):
    """Minimal RGBA/gray PNG writer (no external deps)."""
    import struct
    import zlib

    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        img = img[..., None]
    elif img.shape[2] == 3:
        color_type = 2
    else:
        color_type = 6
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
