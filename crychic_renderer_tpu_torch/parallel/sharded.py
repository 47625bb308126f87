"""Band-sharded frame rendering over torch.distributed (torch counterpart
of ``crychic_renderer_tpu.parallel.sharded``).

The ranks of one process group split a frame into screen bands, one band
per rank:

- RASTERIZATION is sharded with INTERLEAVED tile-row ownership: rank d
  rasterizes the tile rows ty with ty % n_dev == d of both the main view
  and the cascade shadow atlas (``ops.raster.rasterize(row_stride=...)``,
  the K3 launches of ``csrc/raster.cu``), binned by owner-major keys and
  with the full screen's tile anchors, so every pixel equals the single
  card's raster bit for bit. Pair counts are skewed across contiguous
  bands (the horizon band holds most of the main view's pairs), and
  interleaving balances them to ~1/n_dev per rank. The full (depth, tid)
  visibility buffer and the shadow stack are all-gathered, and each rank
  resolves, runs SSAO on and shades only its contiguous pixel band.
- the main view's per-triangle projection, near clip and screen setup
  are TRIANGLE-sharded: each rank computes a 1/n_dev triangle range from
  the draw's static corner tables and one all_gather reassembles tables
  equal to the replicated computation; so is the atlas's per-cascade
  setup.
- SSAO: occlusion is band-local, its taps sample the all-gathered
  full-resolution depth, and the view rays and random field use global
  rows. The blur runs on a window of the all-gathered half-res maps with
  an exact halo of ``ssao_blur_count * radius + 1`` rows, so every band
  row sees the neighbours the full-map blur sees.
- the fast preset's half-res PCF factor is evaluated on the band's rows
  at global phase, all-gathered and upsampled from the full map.

Any (height, n_dev) works: the screen is padded to n_dev * band_h rows
(band_h = ceil(H / n_dev), aligned to the SSAO and fast-preset grids),
bands use the true height for NDC, and the pad rows are cropped.

A second level, ``render_frames_replicated`` over ``make_mesh2``, renders
independent frames in flight on replica groups, each band-sharded, with
no collective across replicas.

``_Comm`` in ``sim_index`` mode runs one band on one device with the
all_gathers replaced by an n_dev-fold copy of the local shard (same shapes
and write volume, no transfer): the JAX package's per-device timing
method (``experiments/sharded_band_timing.py``). The copies carry the
owner's own shard in place of the others', so the gathered triangle
tables hold the owner's 1/n_dev triangle chunk n_dev times: the band is
rendered from that made-up scene, not the real frame's band.

The atlas travels u16-packed, as in the JAX package: each rank
quantizes its own stripes to the maps' 16-bit grid (``ops/pcf``'s
rounding, two texels to a 32-bit word: the words of JAX's
``shadows.pack_depth_rows_u16``) before the all_gather, which halves the
frame's largest transfer, and the PCF (the one-tap compare and K6) takes
the gathered bits without quantizing again. Quantization is per texel and
commutes with the row reassembly, so no pixel changes. The maps travel as
f32 where raw depths are still read (the JAX rule): the alpha punch
min-merges into them and the shadow debug quad blits them.

The alpha-tested layer: each rank peels its band at global rows (plus
the halo row) into its slice of the visibility buffer; the shadow punch
windows are split by cascade across the ranks, all-gathered and
min-merged into the maps on every rank. The forward path's ShadowDebug
quad is drawn at global row phase.

Every gather writes into one buffer made for it: NCCL's
``all_gather_into_tensor``, which a CUDA graph can capture, or gloo's list
form into the buffer's rows. The band frame makes no host sync, so it can
be captured (``parallel/graphs.CompiledBandFrame``); inside
``split_gathers`` a gather is not made but handed to a piecewise capture,
which makes it between two graphs at replay (gloo runs on the host).

The pure-XLA path (``cfg.use_pallas`` False) shards as in the JAX
package: each rank bins and rasterizes its interleaved 32-row tile rows
of the main view and of each cascade in its own viewport with the
pure-tensor raster (``ops.rasterizer.binned_raster``), and the cascades'
stripes are all-gathered as f32 (the u16 packing is the kernel path's).

Draws without static corner tables shard their vertex stage: each rank
transforms a 1/n_dev vertex range (``_band_vertex_records``, and the
shadow draw's world transform in ``_band_shadow_tri_world``), one
all_gather reassembles the per-vertex table, and the corner gather to
triangles is split by triangle ranges (``_chunk_gather_rows``); every op
is per row, so the tables equal the replicated ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..ops import clipping, pcf, raster, shading, shadows, tally
from ..ops import rasterizer as rz
from ..ops import ssao as ssao_ops
from ..ops import ssao_kernel
from ..ops.consts import device_constant
from ..passes import frame as fr

# The split of the piecewise capture in progress (split_gathers), or None
_SPLIT = None


def band_height(cfg: RenderConfig, n_dev: int) -> int:
    """Rows per rank: ceil(H / n_dev), aligned up so every band starts on
    an SSAO-grid (and fast-preset half-grid) phase boundary."""
    align = 1
    if cfg.ssao_enabled:
        align = cfg.ssao_scale
    if cfg.shadows_enabled and cfg.fast_shadow_factor:
        align = align * 2 // math.gcd(align, 2)
    bh = -(-cfg.height // n_dev)
    return -(-bh // align) * align


def _main_band_cap(cfg: RenderConfig) -> int:
    """Per-rank main-view pair capacity; the full-frame capacity unless
    autosize_band_capacities tightened it."""
    return cfg.band_pair_capacity or cfg.pair_capacity


def _shadow_band_cap(cfg: RenderConfig) -> int:
    return cfg.shadow_band_pair_capacity or cfg.shadow_pair_capacity


def _pad_rows(img: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad dim 0 to ``rows`` by repeating the last row (pad content is
    cropped or never read; only the shape must line up)."""
    if img.shape[0] >= rows:
        return img
    pad = img[-1:].expand((rows - img.shape[0],) + img.shape[1:])
    return torch.cat([img, pad], dim=0)


@dataclasses.dataclass(frozen=True)
class BandMesh:
    """This rank's place in a band-sharded job: the process group whose
    ranks split one frame into bands (None: the default group), its size,
    and the replica (frame in flight) the group renders."""

    group: object
    size: int
    replica: int = 0


class _Comm:
    """The band pipeline's collective surface. The real path all_gathers
    over the band group; with ``sim_index`` set, one band runs alone and
    all_gather becomes an n_dev-fold copy of the local shard (the receive
    buffer's shape and write volume, no transfer, and the local shard's
    data in every slot)."""

    def __init__(self, group, n_dev: int, sim_index: int = None):
        self.group = group
        self.n_dev = n_dev
        self.sim_index = sim_index

    def index(self) -> int:
        if self.sim_index is None:
            return dist.get_rank(self.group)
        return self.sim_index

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) -> (n_dev, ...) stacked over the group's ranks, in one
        buffer made here. Inside split_gathers the gather is handed to
        the split instead of being made."""
        if self.sim_index is not None:
            return x.unsqueeze(0).repeat((self.n_dev,) + (1,) * x.dim())
        x = x.contiguous()
        out = torch.empty((self.n_dev,) + x.shape, dtype=x.dtype,
                          device=x.device)
        if _SPLIT is not None:
            _SPLIT(self.gather_into, out, x)
        else:
            self.gather_into(out, x)
        return out

    def gather_into(self, out: torch.Tensor, x: torch.Tensor):
        """Gather every rank's x into the rows of out, (n_dev, ...):
        NCCL's all_gather_into_tensor, or gloo's list form; counted in the
        tally (ops/tally.py) as "gathers" and "gathered_bytes"."""
        if dist.get_backend(self.group) == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
        tally.add({"gathers": 1,
                   "gathered_bytes": out.numel() * out.element_size()})


@contextlib.contextmanager
def split_gathers(split):
    """Inside the block every band gather calls split(gather, out, x) in
    place of gather(out, x), with out the buffer the frame reads next: a
    piecewise CUDA graph capture (parallel/graphs.py) ends its graph
    there, opens the next, and makes the gather between the two at
    replay."""
    global _SPLIT
    saved, _SPLIT = _SPLIT, split
    try:
        yield
    finally:
        _SPLIT = saved


def _row_chunk(d: int, x: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Rows [d*k, (d+1)*k) of ``x`` zero-padded to n*k rows (pad rows are
    marked invalid or dropped on reassembly)."""
    pad = n * k - x.shape[0]
    if pad > 0:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x[d * k:(d + 1) * k]


def _band_vertex_records(draw: fr.DeviceDraw, visibility, view_proj,
                         mat_transform, comm: _Comm, d: int):
    """Vertex-sharded fr.vertex_stage + fr.vertex_records for a draw
    without static tables: rank d transforms a 1/n_dev vertex range and
    one all_gather reassembles the (V, 16) record table, equal to the
    replicated one (every op is per row)."""
    n = comm.n_dev
    V = draw.positions.shape[0]
    kv = -(-V // n)
    chunk = dataclasses.replace(draw, **{
        f: _row_chunk(d, getattr(draw, f), kv, n)
        for f in ("positions", "normals", "tangents", "uvs",
                  "vertex_instance")})
    part = fr.vertex_records(chunk, *fr.vertex_stage(
        chunk, visibility, view_proj, mat_transform))
    return comm.all_gather(part).reshape(n * kv, 16)[:V]


def _chunk_gather_rows(comm: _Comm, d: int, table: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Triangle-sharded row gather: rank d gathers the rows
    idx[d*k .. (d+1)*k) of ``table`` and one all_gather reassembles the
    full table[idx], (N, ...)."""
    n = comm.n_dev
    N = idx.shape[0]
    k = -(-N // n)
    part = table[_row_chunk(d, idx, k, n).long()]
    return comm.all_gather(part).reshape((n * k,) + part.shape[1:])[:N]


def _band_main_view_tris(scene: fr.DeviceScene, consts: fr.FrameConstants,
                         cfg: RenderConfig, comm: _Comm, d: int):
    """Triangle-sharded main-view front end: the per-triangle records of a
    1/n_dev triangle range per rank (the clip projection of the static
    corner tables, or, without them, the corner gather from the
    vertex-sharded record table, _band_vertex_records), then the near
    clip and the screen setup on that range; all_gathers reassemble
    tables equal to fr.main_view_tris (every op is per-triangle)."""
    n = comm.n_dev
    draw = scene.opaque
    if n == 1:
        return fr.main_view_tris(scene, consts, cfg)
    T = draw.indices.shape[0] // 3
    k = -(-T // n)
    if draw.tri_rest is not None:
        poswh = _row_chunk(d, draw.tri_posw_h, k, n)
        poswh = torch.cat([poswh[..., :3], torch.ones_like(poswh[..., :1])],
                          dim=-1)
        clip = shading.rowmat(poswh, consts.view_proj)
        vis = consts.opaque_visibility[
            _row_chunk(d, draw.tri_instance, k, n).long()]
        a = torch.cat([clip * vis[:, None, None],
                       _row_chunk(d, draw.tri_rest, k, n)], dim=-1)
    else:
        vrec = _band_vertex_records(draw, consts.opaque_visibility,
                                    consts.view_proj, scene.mat_transform,
                                    comm, d)
        # pad rows gather vertex 0 and are marked invalid below
        a = vrec[_row_chunk(d, draw.indices.reshape(-1, 3), k, n).long()]
    valid0 = (d * k + torch.arange(k, device=a.device)) < T
    a2, valid = clipping.clip_near(a, valid0)  # (2k, ...): mains, extras
    t = rz.setup_tri_verts(a2[..., :4], valid, cfg.width, cfg.height)

    def reasm(x):
        # the replicated clip_near layout: T mains, then T extras
        g = comm.all_gather(x)  # (n, 2k, ...)
        return torch.cat([g[:, :k].reshape((n * k,) + g.shape[2:])[:T],
                          g[:, k:].reshape((n * k,) + g.shape[2:])[:T]])

    return rz.ScreenTris(*(reasm(f) for f in t)), reasm(a2)


def _band_shadow_tri_world(scene: fr.DeviceScene, visibility,
                           comm: _Comm, d: int) -> torch.Tensor:
    """fr.shadow_tri_world of the shadow draw. With static tables it is
    one multiply, replicated. Without them the world transform runs on a
    1/n_dev vertex range per rank (one all_gather reassembles the (V, 4)
    table) and the corner gather is triangle-sharded
    (_chunk_gather_rows): equal to the replicated table."""
    draw = scene.shadow
    if comm.n_dev == 1 or draw.tri_posw_h is not None:
        return fr.shadow_tri_world(draw, visibility)
    n = comm.n_dev
    V = draw.positions.shape[0]
    kv = -(-V // n)
    chunk = dataclasses.replace(draw, **{
        f: _row_chunk(d, getattr(draw, f), kv, n)
        for f in ("positions", "vertex_instance")})
    part = fr._culled_world_positions(chunk, visibility)
    pos_w = comm.all_gather(part).reshape(n * kv, 4)[:V]
    return _chunk_gather_rows(comm, d, pos_w, draw.indices.reshape(-1, 3))


def _band_shadow_atlas_tris(scene: fr.DeviceScene,
                            consts: fr.FrameConstants, cfg: RenderConfig,
                            comm: _Comm, d: int):
    """Triangle-sharded fr.shadow_atlas_tris: the per-cascade projection,
    screen setup, atlas column shift and depth bias run on the rank's
    1/n_dev chunk of the world-space table (_band_shadow_tri_world); one
    all_gather per field reassembles the cascade-major atlas layout."""
    S = cfg.shadow_map_size
    vps = consts.cascade_view_projs
    C = vps.shape[0]
    n = comm.n_dev
    if n == 1:
        return fr.shadow_atlas_tris(scene, consts.shadow_visibility, vps,
                                    cfg)
    tri_world = _band_shadow_tri_world(scene, consts.shadow_visibility,
                                       comm, d)
    T = tri_world.shape[0]
    k = -(-T // n)
    part = _row_chunk(d, tri_world, k, n)  # (k, 3, 4)
    chunks = []
    for c in range(C):
        t = rz.setup_tri_verts(shading.rowmat(part, vps[c]), None, S, S)
        shift = device_constant((float(c * S), 0.0), torch.float32,
                                t.xy.device)
        chunks.append(fr._shadow_bias(t._replace(xy=t.xy + shift)))

    def reasm(field):  # (n, C, k, ...) -> (C*T, ...)
        g = comm.all_gather(torch.stack([getattr(t, field)
                                         for t in chunks]))
        return torch.cat([g[:, c].reshape((n * k,) + g.shape[3:])[:T]
                          for c in range(C)])

    tris = rz.ScreenTris(*(reasm(f) for f in rz.ScreenTris._fields))
    col = torch.repeat_interleave(
        torch.arange(C, dtype=torch.float32, device=tri_world.device), T)
    return tris, (col * S, (col + 1) * S)


def pack_stripes(depth: torch.Tensor) -> torch.Tensor:
    """(rows, 2K) f32 atlas depths -> (rows, K) int32: the 16-bit UNORM
    depths of ops.pcf.quantize_bits, two texels to a word (texel 2i in the
    low half, 2i + 1 in the high), the bits of the JAX package's
    shadows.pack_depth_rows_u16."""
    return pcf.quantize_bits(depth).view(torch.int32)


def _band_shadow_maps(scene: fr.DeviceScene, consts: fr.FrameConstants,
                      cfg: RenderConfig, comm: _Comm, d: int,
                      stats: dict, packed: bool = False) -> torch.Tensor:
    """Shadow maps with INTERLEAVED tile-row ownership: rank d rasterizes
    the atlas tile rows ty with ty % n_dev == d (one K3 launch), and one
    all_gather + transpose reassembles the (C, S, S) stack everywhere.

    ``packed``: the rank quantizes and packs its own stripes before the
    gather (pack_stripes, half the bytes) and the maps come back as the
    (C, S, S) int16 bits that ops.pcf.quantize_map takes as they are;
    else f32 depths. Quantization is per texel, so it commutes with the
    reassembly and the PCF sees the same bits either way.

    With cfg.use_pallas False (the JAX package's XLA branch) each cascade
    renders in its own S x S viewport, as the single-card
    fr.render_shadow_maps does: rank d bins and rasterizes its
    interleaved XLA_TILE_H-row tiles of each cascade (binned_raster), and
    one all_gather of the (C, rows, S) f32 stripes + a transpose
    reassembles the stack. ``packed`` does not apply there."""
    S = cfg.shadow_map_size
    C = consts.cascade_view_projs.shape[0]
    n = comm.n_dev
    if not cfg.use_pallas:
        tri_world = _band_shadow_tri_world(scene, consts.shadow_visibility,
                                           comm, d)
        parts, flags = [], []
        for c in range(C):
            t = fr._shadow_bias(rz.setup_tri_verts(
                shading.rowmat(tri_world, consts.cascade_view_projs[c]),
                None, S, S))
            depth, _, over, bin_over = rz.binned_raster(
                t, S, S, _shadow_band_cap(cfg), cfg.shadow_bin_cap,
                with_ids=False, row_stride=(n, d))
            parts.append(depth)  # (rpd * XLA_TILE_H, S)
            flags.append(torch.stack([over, bin_over]))
        stats["shadow_overflowed"], stats["shadow_bin_overflowed"] = \
            torch.stack(flags).any(dim=0)
        TH = rz.XLA_TILE_H
        rpd = parts[0].shape[0] // TH
        g = comm.all_gather(torch.stack(parts))  # (n, C, rpd*TH, S)
        return g.reshape(n, C, rpd, TH, S).permute(1, 2, 0, 3, 4).reshape(
            C, n * rpd * TH, S)[:, :S]
    tris, xrange = _band_shadow_atlas_tris(scene, consts, cfg, comm, d)
    depth, _, stats["shadow_overflowed"] = raster.rasterize(
        tris, C * S, S, _shadow_band_cap(cfg), with_ids=False,
        xrange=xrange, row_stride=(n, d))
    # depth: (rpd * TILE_H, C*S) slot-major stripes; stripe s is tile row
    # s * n + d
    rpd = depth.shape[0] // raster.TILE_H
    w = C * S
    if packed:
        depth = pack_stripes(depth)
        w //= 2
    g = comm.all_gather(depth)
    full = g.reshape(n, rpd, raster.TILE_H, w).transpose(0, 1).reshape(
        n * rpd * raster.TILE_H, w)[:S]
    if packed:
        full = full.view(torch.int16)
    return torch.stack([full[:, c * S:(c + 1) * S] for c in range(C)])


def _band_alpha_shadow(scene: fr.DeviceScene, consts: fr.FrameConstants,
                       cfg: RenderConfig, shadow_maps, comm: _Comm,
                       d: int) -> torch.Tensor:
    """The alpha shadow punch split by cascade: rank d computes the punch
    windows of cascades d*k .. d*k+k-1 (k = ceil(C / n_dev), wrapping
    round), the small windows are all-gathered, and every rank min-merges
    all of them into its maps: the per-cascade math of the single-card
    alpha_merge_shadow."""
    C = shadow_maps.shape[0]
    n = comm.n_dev
    k = -(-C // n)
    tri_world, uv_tri, mat_tri = fr.alpha_shadow_geom(scene, consts)
    parts = [fr.alpha_punch_window(scene, cfg, tri_world, uv_tri, mat_tri,
                                   consts.cascade_view_projs[(d * k + j) % C])
             for j in range(k)]

    def gather(i):  # field i of every rank's windows -> (C, ...)
        x = torch.stack([p[i] for p in parts])  # (k, ...)
        return comm.all_gather(x).reshape((n * k,) + x.shape[1:])[:C]

    az, aid, oy, ox = (gather(i) for i in range(4))
    return torch.stack([fr.alpha_apply_punch(shadow_maps[c], az[c], aid[c],
                                             oy[c], ox[c])
                        for c in range(C)])


def _band_ssao(scene: fr.DeviceScene, consts: fr.FrameConstants,
               cfg: RenderConfig, normal_v, depth, comm: _Comm, d: int,
               band_h: int) -> torch.Tensor:
    """Band-exact SSAO: band-local occlusion on all-gathered tap depth,
    the blur on an exact-halo window of the all-gathered half-res maps,
    then the band's rows of the full-map upsample. The gathered maps are
    cut to the TRUE SSAO height first, so padded bands stay exact."""
    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    n = comm.n_dev
    bh = band_h // cfg.ssao_scale
    true_h = cfg.ssao_height
    H, W = cfg.height, cfg.width
    w = d_half.shape[1]
    d_half_all = comm.all_gather(d_half).reshape(n * bh, w)[:true_h]
    # the 14 occluder taps sample the full-resolution depth (Ssao.hlsl:164)
    # anywhere on screen, so the band depths are all-gathered too
    depth_all = comm.all_gather(depth).reshape(n * band_h, W)[:H]
    # padded bands read random-field rows past the true height: don't-care
    field = _pad_rows(scene.ssao_random_field, n * bh)
    # K9's dense mode on the card, the plain occlusion on the CPU
    occlusion = (ssao_kernel.occlusion if d_half.is_cuda
                 else ssao_ops.ssao_occlusion)
    access = occlusion(
        n_half, d_half, consts.proj, consts.inv_proj, scene.ssao_offsets,
        random_field=field[d * bh:(d + 1) * bh], tap_depth=depth_all,
        row_offset=d * bh, full_height=true_h)
    # ssao_blur_count passes of the radius-r vertical blur reach
    # count * r rows; with that halo + 1 (the upsample's support) every
    # band row's blur, and every row the upsample reads, sees exactly the
    # neighbours of the full-map blur. The window clamps to the map, so
    # the first and last bands keep the true edge semantics.
    radius = (scene.ssao_blur_weights.shape[0] - 1) // 2
    halo = cfg.ssao_blur_count * radius + 1
    access_full = comm.all_gather(access).reshape(n * bh, w)[:true_h]
    n_half_full = comm.all_gather(n_half).reshape(
        (n * bh,) + n_half.shape[1:])[:true_h]
    win = min(bh + 2 * halo, true_h)
    lo = min(max(d * bh - halo, 0), true_h - win)
    blurred = fr.ssao_blur(scene, consts, cfg, access_full[lo:lo + win],
                           n_half_full[lo:lo + win],
                           d_half_all[lo:lo + win])
    # rows outside the window matter only through the upsample's support,
    # which the halo keeps inside it
    access_full = torch.cat([access_full[:lo], blurred,
                             access_full[lo + win:]])
    up = _pad_rows(fr._upsample_bilinear(access_full, H, W), band_h * n)
    return up[d * band_h:(d + 1) * band_h]


def _band_fast_shadow_factor(consts: fr.FrameConstants, cfg: RenderConfig,
                             pos_w, valid, shadow_maps, comm: _Comm,
                             d: int, band_h: int) -> torch.Tensor:
    """Band-exact fast-preset PCF: the half-res factor on the band's
    global-phase rows (band_h is even), all-gathered, upsampled from the
    full map, and the band's rows sliced out."""
    sf_local = shadows.cascade_shadow_factor(
        shadow_maps, consts.shadow_transforms, pos_w[::2, ::2],
        consts.eye_pos, cfg.shadow_map_size,
        deferred_blend_quirk=cfg.deferred,
        soft_radius_texels=cfg.pcf_radius_texels, dead=~valid[::2, ::2])
    n = comm.n_dev
    sf_all = comm.all_gather(sf_local).reshape(n * (band_h // 2),
                                               sf_local.shape[1])
    sf_full = fr._upsample_bilinear(sf_all[:(cfg.height + 1) // 2],
                                    cfg.height, cfg.width)
    sf_full = _pad_rows(sf_full, band_h * n)
    return sf_full[d * band_h:(d + 1) * band_h]


def packs_atlas(scene: fr.DeviceScene, cfg: RenderConfig) -> bool:
    """The JAX package's rule for the u16-packed atlas gather: packed on
    the kernel path unless raw depths are still read, by the alpha
    punch's min-merge or the shadow debug quad's blit; the pure-tensor
    path's per-cascade maps travel as f32."""
    quad = cfg.debug_view == "shadow_cascade3" or (
        not cfg.deferred and cfg.debug_view is None)
    return cfg.use_pallas and not fr.alpha_enabled(scene, cfg) and not quad


def _band_render(scene: fr.DeviceScene, consts: fr.FrameConstants,
                 cfg: RenderConfig, comm: _Comm, band_h: int,
                 stats: dict = None, packed: bool = None) -> torch.Tensor:
    """One rank's band of the frame: rows [d*band_h, (d+1)*band_h) of an
    n_dev*band_h-row PADDED screen, (band_h, W, 4). NDC and viewport math
    use the TRUE cfg.height, so pad rows (>= cfg.height) hold don't-care
    values the caller crops. stats (optional dict) receives this rank's
    raster overflow flags as 0-d bool tensors. packed: whether the atlas
    travels u16-packed (None: packs_atlas)."""
    stats = {} if stats is None else stats
    # the bands stay dense, as in the JAX package: a band's occupancy is
    # not what the capacities were sized for, and the split already
    # divides the work n ways (_band_ssao calls the dense occlusion)
    cfg = dataclasses.replace(cfg, shade_tile_capacity=None,
                              ssao_tile_capacity=None)
    d = comm.index()
    n = comm.n_dev
    H, W = cfg.height, cfg.width
    H_pad = band_h * n
    dev = consts.view_proj.device

    if cfg.shadows_enabled:
        shadow_maps = _band_shadow_maps(
            scene, consts, cfg, comm, d, stats,
            packs_atlas(scene, cfg) if packed is None else packed)
    else:
        shadow_maps = torch.ones((cfg.num_cascades, 2, 2),
                                 dtype=torch.float32, device=dev)

    # main visibility buffer: this rank's interleaved tile rows (one K3
    # launch, or the pure-tensor raster on 32-row tiles), all-gathered
    # into the full (depth, tid) buffer; the rank then resolves and
    # shades its contiguous pixel band
    tris, tri_attr = _band_main_view_tris(scene, consts, cfg, comm, d)
    if cfg.use_pallas:
        TH = raster.TILE_H
        dpart, tpart, stats["main_overflowed"] = raster.rasterize(
            tris, W, H_pad, _main_band_cap(cfg), row_stride=(n, d))
    else:
        TH = rz.XLA_TILE_H
        dpart, tpart, stats["main_overflowed"], \
            stats["main_bin_overflowed"] = rz.binned_raster(
                tris, W, H_pad, _main_band_cap(cfg), cfg.bin_cap,
                row_stride=(n, d))
    rpd = dpart.shape[0] // TH

    def reassemble(part):
        g = comm.all_gather(part)  # (n, rpd*TH, W)
        full = g.reshape(n, rpd, TH, W).transpose(0, 1)
        full = full.reshape(n * rpd * TH, W)
        # one duplicate row keeps the last band's halo row in range
        return torch.cat([full, full[-1:]])

    y0 = d * band_h
    depth = reassemble(dpart)[y0:y0 + band_h + 1]
    tid = reassemble(tpart)[y0:y0 + band_h + 1]
    if fr.alpha_enabled(scene, cfg):
        # the alpha peel over the band's GLOBAL rows and the halo row: the
        # single-card merge's math, so the band stays equal to it
        depth, tid, tris, tri_attr = fr.alpha_merge_main(
            scene, consts, cfg, depth, tid, tris, tri_attr, row_offset=y0)
        if cfg.shadows_enabled:
            shadow_maps = _band_alpha_shadow(scene, consts, cfg,
                                             shadow_maps, comm, d)
    g = fr.resolve_gbuffer(scene, consts, cfg, tris, depth, tid, tri_attr,
                           row_offset=y0, out_rows=band_h)
    depth = depth[:band_h]

    if cfg.ssao_enabled:
        ambient_access = _band_ssao(scene, consts, cfg, g["normal_v"], depth,
                                    comm, d, band_h)
    else:
        ambient_access = torch.ones((band_h, W), dtype=torch.float32,
                                    device=dev)

    sf = None
    if cfg.shadows_enabled and cfg.fast_shadow_factor:
        sf = _band_fast_shadow_factor(consts, cfg, g["pos_w"], g["valid"],
                                      shadow_maps, comm, d, band_h)

    img = fr.lighting_pass(scene, consts, cfg, g, shadow_maps,
                           ambient_access, depth, row_offset=y0,
                           full_height=H, shadow_factor=sf)
    return fr.apply_debug_overlay(consts, cfg, img, shadow_maps, g["pos_w"],
                                  row_offset=y0, full_height=H)


def render_frame_sharded(scene: fr.DeviceScene, consts: fr.FrameConstants,
                         cfg: RenderConfig, mesh: BandMesh,
                         stats: dict = None,
                         packed_atlas: bool = None) -> torch.Tensor:
    """The full frame over the mesh's band group -> (H, W, 4) float32, the
    same on every rank of the group (the bands are all-gathered at the
    end). Every rank of the group calls it with the same scene, constants
    and config. stats (optional dict) receives this rank's raster
    overflow flags ("main_overflowed", "shadow_overflowed"), 0-d bool
    tensors read by nobody here. packed_atlas: whether the atlas travels
    u16-packed (None: the JAX rule, packs_atlas; the image is the same
    either way)."""
    band_h = band_height(cfg, mesh.size)
    comm = _Comm(mesh.group, mesh.size)
    img = _band_render(scene, consts, cfg, comm, band_h, stats,
                       packed_atlas)
    full = comm.all_gather(img)
    return full.reshape((mesh.size * band_h,) + img.shape[1:])[:cfg.height]


def band_requirements(scene: fr.DeviceScene, consts: fr.FrameConstants,
                      cfg: RenderConfig, n_dev: int) -> dict:
    """Exact worst-RANK (tile, triangle) pair counts of the interleaved
    band binning (tile rows ty % n_dev == d), on the path's tile height
    (the pure-tensor path's shadow count is the worst cascade's, each
    binned in its own viewport, as the JAX package counts it): what the
    band capacities must reach, else a rank drops geometry. Dense
    per-triangle math (a difference array over tile rows, no pair
    expansion); the counts are read back to the host as ints."""
    band_h = band_height(cfg, n_dev)
    H_pad = band_h * n_dev

    def worst_owner(tris, width, height, tile_h):
        _, ty0, bw, bh, _, nty = rz._tile_bbox(tris, width, height,
                                               tile_h, raster.TILE_W)
        # pairs per tile row = sum of the bbox widths of the triangles
        # overlapping the row: difference-array scatter + cumsum
        w = (bw * (bh > 0)).long()
        rows = torch.zeros(nty + 1, dtype=torch.long, device=w.device)
        rows.index_add_(0, ty0.long(), w)
        rows.index_add_(0, (ty0 + bh).long(), -w)
        per_row = torch.cumsum(rows[:nty], 0)
        rpd = -(-nty // n_dev)
        per_row = torch.cat([per_row, per_row.new_zeros(rpd * n_dev - nty)])
        # owner d's total = sum of the rows ty with ty % n_dev == d
        return int(per_row.reshape(rpd, n_dev).sum(0).max())

    th = raster.TILE_H if cfg.use_pallas else rz.XLA_TILE_H
    tris, _ = fr.main_view_tris(scene, consts, cfg)
    out = dict(band_h=band_h,
               main_band_pairs=worst_owner(tris, cfg.width, H_pad, th),
               main_band_capacity=_main_band_cap(cfg))
    if cfg.shadows_enabled:
        S = cfg.shadow_map_size
        vps = consts.cascade_view_projs
        if cfg.use_pallas:
            s_tris, _ = fr.shadow_atlas_tris(
                scene, consts.shadow_visibility, vps, cfg)
            worst = worst_owner(s_tris, vps.shape[0] * S, S, th)
        else:  # each cascade binned in its own viewport
            tri_world = fr.shadow_tri_world(scene.shadow,
                                            consts.shadow_visibility)
            worst = max(worst_owner(rz.setup_tri_verts(
                shading.rowmat(tri_world, vps[c]), None, S, S), S, S, th)
                for c in range(cfg.num_cascades))
        out["shadow_band_pairs"] = worst
        out["shadow_band_capacity"] = _shadow_band_cap(cfg)
    return out


def autosize_band_capacities(scene: fr.DeviceScene,
                             consts: fr.FrameConstants, cfg: RenderConfig,
                             n_dev: int, headroom: float = 1.5
                             ) -> RenderConfig:
    """Size the band capacities from the EXACT worst-rank pair counts of
    the given frame (band_requirements) with ``headroom``, rounded to
    TRI_BLOCK, at least 8k and at most the full-frame capacity. Like the
    single-card sizing this reflects the given camera; check_band_capacity
    guards later frames."""
    req = band_requirements(scene, consts, cfg, n_dev)

    def size(needed, full):
        cap = -(-int(needed * headroom) // raster.TRI_BLOCK) \
            * raster.TRI_BLOCK
        return min(max(cap, 1 << 13), full)

    kw = dict(band_pair_capacity=size(req["main_band_pairs"],
                                      cfg.pair_capacity))
    if cfg.shadows_enabled:
        kw["shadow_band_pair_capacity"] = size(req["shadow_band_pairs"],
                                               cfg.shadow_pair_capacity)
    return dataclasses.replace(cfg, **kw)


def check_band_capacity(scene: fr.DeviceScene, consts: fr.FrameConstants,
                        cfg: RenderConfig, n_dev: int) -> dict:
    """Raise if THIS frame would overflow the band capacities (the band
    binning drops the pairs past them), the sharded mirror of
    Renderer.check_overflow. Returns the band_requirements dict."""
    req = band_requirements(scene, consts, cfg, n_dev)
    if req["main_band_pairs"] > req["main_band_capacity"]:
        raise RuntimeError(
            f"sharded main raster overflow: worst rank needs "
            f"{req['main_band_pairs']} pairs > band capacity "
            f"{req['main_band_capacity']}; re-run autosize_band_capacities")
    if cfg.shadows_enabled and (req["shadow_band_pairs"]
                                > req["shadow_band_capacity"]):
        raise RuntimeError(
            f"sharded shadow raster overflow: worst rank needs "
            f"{req['shadow_band_pairs']} pairs > band capacity "
            f"{req['shadow_band_capacity']}; re-run "
            f"autosize_band_capacities")
    return req


def make_mesh() -> BandMesh:
    """The band mesh over all ranks of the job (the default group)."""
    return BandMesh(None, dist.get_world_size())


# ---------------------------------------------------------------------------
# Replica groups: independent frames in flight
# ---------------------------------------------------------------------------

def make_mesh2(n_rep: int, n_band: int) -> BandMesh:
    """n_rep replica groups of n_band consecutive ranks each (the whole
    job: n_rep * n_band ranks). Every rank calls it and gets its own
    group's mesh; the band collectives name only that group, so replicas
    never communicate."""
    world = dist.get_world_size()
    if n_rep * n_band != world:
        raise ValueError(f"{n_rep} x {n_band} ranks in a job of {world}")
    group, _ = dist.new_subgroups(group_size=n_band)
    return BandMesh(group, n_band, replica=dist.get_rank() // n_band)


def stack_frames(frames: list):
    """Stack per-frame containers (DeviceScene or FrameConstants) along a
    new leading replica dim: the input of render_frames_replicated.
    Non-tensor fields (counts, None) are taken from the first frame."""
    first = frames[0]

    def stack(vals):
        if dataclasses.is_dataclass(vals[0]):
            return stack_frames(vals)
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals)
        return vals[0]

    return dataclasses.replace(first, **{
        f.name: stack([getattr(o, f.name) for o in frames])
        for f in dataclasses.fields(first)})


def _replica(stacked, r: int):
    """Replica r's container out of stack_frames' output."""
    def pick(v):
        if dataclasses.is_dataclass(v):
            return _replica(v, r)
        return v[r] if isinstance(v, torch.Tensor) else v

    return dataclasses.replace(stacked, **{
        f.name: pick(getattr(stacked, f.name))
        for f in dataclasses.fields(stacked)})


def render_frames_replicated(scenes, consts, cfg: RenderConfig,
                             mesh: BandMesh, stats: dict = None,
                             packed_atlas: bool = None) -> torch.Tensor:
    """n_rep independent frames, each band-sharded over its replica group
    (make_mesh2): this rank's group renders frame ``mesh.replica`` of the
    stacked ``scenes``/``consts`` (stack_frames). Returns that frame,
    (H, W, 4), on every rank of the group."""
    return render_frame_sharded(_replica(scenes, mesh.replica),
                                _replica(consts, mesh.replica), cfg, mesh,
                                stats, packed_atlas)
