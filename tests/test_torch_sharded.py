"""The port's band-sharded frame (crychic_renderer_tpu_torch.parallel)
against the JAX package's band modes and frames, on the CPU.

Inputs: BASELINE config 4 at 1/8 size (240x135, 256^2 cascades), the
port's scene made from the JAX scene's leaves, as tests/test_torch_frame.py
does. Tolerances:

- Band binning (row_stride and ty_lo/num_rows, n in {2, 3, 4}, every
  owner): order, starts, counts and sorted_tile equal to JAX's.
- Band records equal to JAX's build_records(row_unperm=...) on the valid
  pairs; the plain band raster against rasterize_pallas(row_stride=...,
  interpret=True): every tid equal, depth within 1e-6 (PR 1's bound for
  the interpret-mode kernel, whose traced body contracts into FMAs;
  measured in test_torch_raster.py: 9.5e-7).
- The n plain bands reassembled equal the port's full-screen raster
  (torch.equal): the global tile anchors make band pixels bit-equal.
- ssao_occlusion, resolve_gbuffer, lighting_pass and apply_debug_overlay
  on one band (row_offset/full_height) against JAX's on the same band,
  eager: 1e-5.
- render_frame_sharded over gloo groups of 2 and 4 CPU ranks against the
  port's render_frame: max |diff| <= 1e-5 and at most 1e-3 of pixels
  above 0.02 (tests/test_multichip.py's bound); against the JAX
  package's render_frame on the interpret-mode kernel: at most 0.5% of
  pixels above 0.02 (the port's frame bound, test_torch_frame.py).
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.ops import raster_pallas as rp
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.ops import ssao as jssao
from crychic_renderer_tpu.parallel import sharded as jsh
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.config import RenderConfig
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.ops import ssao as ssao_ops
from crychic_renderer_tpu_torch.parallel import launch, sharded
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves, _small

DZ = 1e-6          # band raster depth vs the interpret-mode Pallas kernel
ATOL = 1e-5        # band passes vs JAX's, eager
SHARD_MAX = 1e-5   # sharded frame vs the port's render_frame, max |diff|
SHARD_FRAC = 1e-3  # ... share of pixels above 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, what, atol=ATOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def frame():
    """Both packages' renderers of the 1/8 frame on one scene, the JAX one
    forced onto the Pallas kernel in interpret mode, with the JAX main-view
    and atlas triangles."""
    scene, cfg, lights = JCONFIGS[4]()
    rj = JRenderer(scene, _small(cfg), lights=lights)
    rj.cfg = dataclasses.replace(rj.cfg, use_pallas=True,
                                 pallas_interpret=True)
    rj._autosize_capacity()
    rj.rebind_frame_fn()
    tscene, tcfg, tlights = CONFIGS[4]()
    rt = Renderer(tscene, _small(tcfg), lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    jc = rj.frame_constants(0.0)
    main, attr = jax.jit(lambda s, c: jfr.main_view_tris(s, c, rj.cfg))(
        rj.device_scene, jc)
    atlas, xr = jax.jit(lambda s, c: jfr.shadow_atlas_tris(
        s, c.shadow_visibility, c.cascade_view_projs, rj.cfg))(
            rj.device_scene, jc)
    return dict(rj=rj, rt=rt, jc=jc, tc=rt.frame_constants(0.0),
                main=main, attr=attr, atlas=atlas, xr=xr)


def _view(frame, view):
    """(JAX tris, W, H, capacity, JAX xrange, with_ids) of one launch."""
    cfg = frame["rt"].cfg
    S = cfg.shadow_map_size
    if view == "main":
        return frame["main"], cfg.width, cfg.height, cfg.pair_capacity, \
            None, True
    return frame["atlas"], 4 * S, S, cfg.shadow_pair_capacity, \
        frame["xr"], False


def _tris_t(tris):
    return rz.ScreenTris(*(_t(x) for x in tris))


def _xr_t(xrange):
    return None if xrange is None else tuple(_t(x) for x in xrange)


def _bands(mode, n, nty):
    """Per owner: (port band kwargs, JAX binning kwargs, JAX raster
    kwargs)."""
    out = []
    for d in range(n):
        if mode == "interleaved":
            kw = dict(row_stride=(n, d))
            out.append((kw, kw, kw))
        else:
            per = -(-nty // n)
            lo, rows = d * per, min(per, nty - d * per)
            out.append((dict(tile_row_offset=lo, num_tile_rows=rows),
                        dict(ty_lo=lo, num_rows=rows),
                        dict(tile_row_offset=lo, num_tile_rows=rows)))
    return out


# ---------------------------------------------------------------------------
# Band binning, records and raster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("mode", ["interleaved", "contiguous"])
@pytest.mark.parametrize("view", ["main", "atlas"])
def test_band_binning_matches_jax(frame, view, mode, n):
    tris, W, H, cap, _, _ = _view(frame, view)
    tt = _tris_t(tris)
    pairs = 0
    for kw_t, kw_j, _ in _bands(mode, n, -(-H // 8)):
        bj = jrz.bin_triangles(tris, W, H, cap, tile_h=8, tile_w=128, **kw_j)
        bt = rz.bin_triangles(tt, W, H, cap, tile_h=8, tile_w=128,
                              ty_lo=kw_j.get("ty_lo"),
                              num_rows=kw_j.get("num_rows"),
                              row_stride=kw_j.get("row_stride"))
        pairs += int(bt.num_valid)
        for f in bj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                          getattr(bt, f).numpy(),
                                          err_msg=f"{kw_t}: {f}")
    assert pairs > 0


@pytest.mark.parametrize("view,n,mode", [
    ("main", 4, "interleaved"), ("atlas", 3, "interleaved"),
    ("main", 3, "contiguous")])
def test_band_raster_matches_pallas(frame, view, n, mode):
    """Records and the plain band raster against the Pallas kernel's band
    modes (interpret mode). Main view at n=4 and the atlas at n=3 pad the
    key space past the screen (20 key rows for 17, 33 for 32)."""
    tris, W, H, cap, xrange, ids = _view(frame, view)
    ntx, nty = -(-W // 128), -(-H // 8)
    for kw_t, kw_j, kw_r in _bands(mode, n, nty):
        rec_t, _, _, over = raster.binned_records(
            _tris_t(tris), W, H, cap, xrange=_xr_t(xrange), **kw_t)
        assert not bool(over)
        bins = jrz.bin_triangles(tris, W, H, cap, tile_h=8, tile_w=128,
                                 **kw_j)
        unperm = None
        if mode == "interleaved":
            unperm = (n, -(-nty // n))
        rec_j = rp.build_records(tris, bins, ntx, bins.starts.shape[0], 8,
                                 xrange, row_unperm=unperm)
        rec_j = np.asarray(rec_j).reshape(16, -1).T
        k = int(bins.num_valid)
        np.testing.assert_array_equal(rec_t.numpy()[:k], rec_j[:k])

        d, t, _ = raster.rasterize(_tris_t(tris), W, H, cap, with_ids=ids,
                                   xrange=_xr_t(xrange), **kw_t)
        d_ref, t_ref = rp.rasterize_pallas(
            tris, W, H, cap, interpret=True, with_ids=ids, xrange=xrange,
            tiles_per_prog=32 if xrange is not None else rp.TILES_PER_PROG,
            **kw_r)
        d_ref = np.asarray(d_ref)
        assert d.shape == d_ref.shape, (kw_t, d.shape, d_ref.shape)
        if ids:
            np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
        else:
            np.testing.assert_array_equal(d.numpy() < 1.0, d_ref < 1.0)
        assert np.abs(d.numpy() - d_ref).max() <= DZ, kw_t


def _reassemble(parts, mode, n, rows):
    """Owner stripes (interleaved) or contiguous bands -> full screen."""
    if mode == "contiguous":
        return torch.cat(parts)[:rows]
    rpd = parts[0].shape[0] // 8
    g = torch.stack(parts).reshape(n, rpd, 8, -1).transpose(0, 1)
    return g.reshape(n * rpd * 8, -1)[:rows]


@pytest.fixture(scope="module")
def full_raster(frame):
    """The port's full-screen raster of each view."""
    out = {}
    for view in ("main", "atlas"):
        tris, W, H, cap, xrange, ids = _view(frame, view)
        out[view] = raster.rasterize(_tris_t(tris), W, H, cap, with_ids=ids,
                                     xrange=_xr_t(xrange))[:2]
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("mode", ["interleaved", "contiguous"])
@pytest.mark.parametrize("view", ["main", "atlas"])
def test_plain_bands_reassemble_to_full(frame, full_raster, view, mode, n):
    tris, W, H, cap, xrange, ids = _view(frame, view)
    tt, xr = _tris_t(tris), _xr_t(xrange)
    d_full, t_full = full_raster[view]
    parts = [raster.rasterize(tt, W, H, cap, with_ids=ids, xrange=xr,
                              **kw_t)[:2]
             for kw_t, _, _ in _bands(mode, n, -(-H // 8))]
    assert torch.equal(_reassemble([p[0] for p in parts], mode, n, H),
                       d_full)
    if ids:
        assert torch.equal(_reassemble([p[1] for p in parts], mode, n, H),
                           t_full)


def test_band_grid_of_the_1080p_frame():
    """The launches phase 9 of chip_smoke.py holds against K1/K2: the main
    view at n=4 (nty 135, rpd 34: owner 3's last key row is row 135, past
    the screen) and the atlas at n=3 (nty 256, rpd 86, two padded rows)."""
    assert raster.band_grid(1920, 1080, row_stride=(4, 3)) == (3 * 34 * 15,
                                                                34 * 8)
    assert raster.band_grid(8192, 2048, row_stride=(3, 2)) == (2 * 86 * 64,
                                                                86 * 8)
    assert raster.band_grid(8192, 2048, tile_row_offset=5,
                            num_tile_rows=7) == (5 * 64, 56)
    assert raster.band_grid(8192, 2048) == (None, 2048)


@pytest.mark.parametrize("tile_offset,rows", [
    (-15, 8), (7, 8), (15, 12), (30, 16), (0.0, 8)])
def test_band_wrapper_rejects_malformed_grid(tile_offset, rows):
    """raster_tiles (here through its CPU path; the CUDA path runs the
    same check before launching) refuses a band grid that is not whole
    tile rows of the key space: 3 key rows of 15 tiles (W=1920)."""
    rec = torch.zeros((128, 16))
    keys = torch.zeros(45, dtype=torch.int32)
    with pytest.raises(ValueError, match="band of"):
        raster.raster_tiles(rec, keys, keys, 1920, rows,
                            tile_offset=tile_offset)


# ---------------------------------------------------------------------------
# The passes on one band
# ---------------------------------------------------------------------------

Y0, BAND_H = 68, 34  # band 2 of 4 at 1/8 size (n=4: 4 x 34 rows)


@pytest.fixture(scope="module")
def gbuf(frame):
    """The inputs each band pass is evaluated on: the frame's JAX
    main-view triangles, with the port's full-screen raster, shadow maps
    and G-buffer of them (only inputs: both packages get the same
    arrays), and the band's G-buffer from the JAX package, resolved
    eagerly at global rows with the halo row below it trimmed."""
    rj, rt, tc = frame["rj"], frame["rt"], frame["tc"]
    # the dense resolve and PCF (no tile compaction), as the port's
    cfg = dataclasses.replace(rj.cfg, shade_tile_capacity=None,
                              ssao_tile_capacity=None, use_pallas=False)
    tris, attr = frame["main"], frame["attr"]
    depth, tid, _ = raster.rasterize(_tris_t(tris), cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(rt.device_scene, tc, rt.cfg, _tris_t(tris), depth,
                           tid, _t(attr))
    maps = fr.render_shadow_atlas(rt.device_scene, tc.shadow_visibility,
                                  tc.cascade_view_projs, rt.cfg)
    depth, tid = depth.numpy(), tid.numpy()
    rows = slice(Y0, Y0 + BAND_H + 1)
    g_band = jfr.resolve_gbuffer(rj.device_scene, frame["jc"], cfg, tris,
                                 depth[rows], tid[rows], attr, row_offset=Y0,
                                 full_height=cfg.height, out_rows=BAND_H)
    return dict(cfg=cfg, tris=tris, attr=attr, depth=depth, tid=tid,
                maps=maps.numpy(), g={k: v.numpy() for k, v in g.items()},
                g_band=g_band)


def test_band_resolve_matches_jax(frame, gbuf):
    """Band rows + the halo row below, resolved at global rows, the halo
    trimmed; and equal to the port's full-screen resolve on those rows."""
    rt = frame["rt"]
    rows = slice(Y0, Y0 + BAND_H + 1)
    args = (rt.device_scene, frame["tc"], rt.cfg, _tris_t(gbuf["tris"]))
    got = fr.resolve_gbuffer(*args, _t(gbuf["depth"][rows]),
                             _t(gbuf["tid"][rows]), _t(gbuf["attr"]),
                             row_offset=Y0, out_rows=BAND_H)
    full = fr.resolve_gbuffer(*args, _t(gbuf["depth"]), _t(gbuf["tid"]),
                              _t(gbuf["attr"]))
    for k in ("pos_w", "normal_w", "normal_v", "albedo", "roughness"):
        assert got[k].shape[0] == BAND_H
        _close(gbuf["g_band"][k], got[k], k)
        _close(full[k][Y0:Y0 + BAND_H], got[k], f"{k} vs full", atol=0)


def test_band_ssao_occlusion_matches_jax(frame, gbuf):
    """Occlusion of the band's half-res rows with global view rays, the
    band's random-field rows and the full-screen tap depth."""
    rj, rt = frame["rj"], frame["rt"]
    cfg, c = gbuf["cfg"], frame["jc"]
    depth = np.asarray(gbuf["depth"])
    n_half, d_half = jfr.ssao_inputs_half(cfg, gbuf["g"]["normal_v"],
                                          gbuf["depth"])
    y, h = Y0 // 2, BAND_H // 2
    field = rj.device_scene.ssao_random_field
    ref = jssao.ssao_occlusion(
        n_half[y:y + h], d_half[y:y + h], c.proj, c.inv_proj,
        rj.device_scene.ssao_offsets, random_field=field[y:y + h],
        tap_depth=gbuf["depth"], row_offset=y, full_height=cfg.ssao_height)
    tc, ts = frame["tc"], rt.device_scene
    got = ssao_ops.ssao_occlusion(
        _t(n_half[y:y + h]), _t(d_half[y:y + h]), tc.proj, tc.inv_proj,
        ts.ssao_offsets, random_field=ts.ssao_random_field[y:y + h],
        tap_depth=_t(depth), row_offset=y, full_height=cfg.ssao_height)
    assert float(np.asarray(ref).min()) < 0.9  # something is occluded
    _close(ref, got, "band access")


@pytest.mark.parametrize("given_factor", [False, True])
def test_band_lighting_matches_jax(frame, gbuf, given_factor):
    """The band's lighting at global rows (the sky ray's NDC y), with the
    PCF evaluated in the pass or handed in as shadow_factor."""
    rj, rt = frame["rj"], frame["rt"]
    cfg, c = gbuf["cfg"], frame["jc"]
    rows = slice(Y0, Y0 + BAND_H)
    g = gbuf["g_band"]
    rng = np.random.default_rng(7)
    access = rng.uniform(0.3, 1.0, (BAND_H, cfg.width)).astype(np.float32)
    sf = (rng.uniform(0.0, 1.0, (BAND_H, cfg.width)).astype(np.float32)
          if given_factor else None)
    ref = jfr.lighting_pass(rj.device_scene, c, cfg, g, gbuf["maps"],
                            access, gbuf["depth"][rows], row_offset=Y0,
                            full_height=cfg.height, shadow_factor=sf)
    got = fr.lighting_pass(rt.device_scene, frame["tc"], rt.cfg,
                           {k: _t(v) for k, v in g.items()},
                           _t(gbuf["maps"]), _t(access),
                           _t(gbuf["depth"][rows]), row_offset=Y0,
                           full_height=cfg.height,
                           shadow_factor=None if sf is None else _t(sf))
    assert bool((~_t(g["valid"])).any())  # sky rows are in the band
    _close(ref, got, "band lighting")


@pytest.mark.parametrize("view", ["shadow_cascade3", "cascades"])
def test_band_debug_overlay_matches_jax(frame, gbuf, view):
    """The debug layers on the band of rows 68-101, which the shadow quad
    (rows 68-134 of 135) starts in, at global row phase."""
    rj, rt = frame["rj"], frame["rt"]
    cfg = dataclasses.replace(gbuf["cfg"], debug_view=view)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (BAND_H, cfg.width, 4)).astype(np.float32)
    pos = rng.uniform(-60, 60, (BAND_H, cfg.width, 3)).astype(np.float32)
    ref = jfr.apply_debug_overlay(frame["jc"], cfg, img, gbuf["maps"], pos,
                                  row_offset=Y0, full_height=cfg.height)
    got = fr.apply_debug_overlay(
        frame["tc"], dataclasses.replace(rt.cfg, debug_view=view), _t(img),
        _t(gbuf["maps"]), _t(pos), row_offset=Y0, full_height=cfg.height)
    _close(ref, got, view)


# ---------------------------------------------------------------------------
# Band capacities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_band_requirements_match_jax(frame, n):
    rj, rt = frame["rj"], frame["rt"]
    ref = jsh.band_requirements(rj.device_scene, frame["jc"], rj.cfg, n)
    got = sharded.band_requirements(rt.device_scene, frame["tc"], rt.cfg, n)
    for k in ("band_h", "main_band_pairs", "shadow_band_pairs"):
        assert got[k] == int(ref[k]), k
    assert 0 < got["main_band_pairs"] and 0 < got["shadow_band_pairs"]


def test_check_band_capacity_guard(frame):
    """check_band_capacity passes at the autosized capacities and raises
    when a rank's pairs exceed a band capacity (tests/test_multichip.py's
    guard test)."""
    rt = frame["rt"]
    s, c = rt.device_scene, frame["tc"]
    cfg2 = sharded.autosize_band_capacities(s, c, rt.cfg, 4)
    req = sharded.check_band_capacity(s, c, cfg2, 4)
    assert req["main_band_pairs"] <= cfg2.band_pair_capacity \
        < rt.cfg.pair_capacity
    assert req["shadow_band_pairs"] <= cfg2.shadow_band_pair_capacity
    tiny = dataclasses.replace(cfg2, band_pair_capacity=32)
    with pytest.raises(RuntimeError, match="main raster overflow"):
        sharded.check_band_capacity(s, c, tiny, 4)
    tiny_s = dataclasses.replace(cfg2, shadow_band_pair_capacity=32)
    with pytest.raises(RuntimeError, match="shadow raster overflow"):
        sharded.check_band_capacity(s, c, tiny_s, 4)


# ---------------------------------------------------------------------------
# The sharded frame over gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(frame):
    """One gloo job of 4 CPU ranks: the frame over all 4 ranks, the fast
    preset over all 4, and two frames in flight on 2 x 2 replica groups
    (ranks 0-1 the frame, at the band capacities autosized for 2 ranks;
    ranks 2-3 the same with the camera moved), beside the port's
    single-device frames of the same inputs and the JAX package's."""
    rt = frame["rt"]
    scene, c0 = rt.device_scene, frame["tc"]
    cam = copy.deepcopy(rt.camera)
    rt.camera.walk(2.0)
    rt.camera.rotate_y(0.1)
    c1 = rt.frame_constants(0.5)
    rt.camera = cam
    tscene, tcfg, tlights = CONFIGS[4]()
    fast = Renderer(tscene, _small(tcfg).fast_preset(), lights=tlights,
                    device="cpu")
    cfg2 = sharded.autosize_band_capacities(scene, c0, rt.cfg, 2)
    assert cfg2.band_pair_capacity < rt.cfg.pair_capacity
    runs = launch.render_sharded(
        [scene, fast.device_scene], [c0, c1, fast.frame_constants(0.0)],
        [(rt.cfg, 0, (0,)), (fast.cfg, 1, (2,)), (cfg2, 0, (0, 1))],
        4, "gloo", "cpu")
    single = {
        "frame": fr.render_frame(scene, c0, rt.cfg).numpy(),
        "moved": fr.render_frame(scene, c1, rt.cfg).numpy(),
        "fast": fr.render_frame(fast.device_scene,
                                fast.frame_constants(0.0),
                                fast.cfg).numpy()}
    return dict(runs=runs, single=single, jax=frame["rj"].render_np(0.0))


def _vs_single(img, ref, what):
    assert img.shape == ref.shape and np.isfinite(img).all(), what
    diff = np.abs(img - ref).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert diff.max() <= SHARD_MAX and frac <= SHARD_FRAC, (
        f"{what}: max {diff.max():.3g}, {frac:.4%} of pixels > 0.02")


def _sharded(spawned, n):
    """(frame of the group of n ranks from rank 0, its other ranks)."""
    run = 0 if n == 4 else 2  # n == 2: replica 0's group, ranks 0-1
    return [spawned["runs"][rank][run] for rank in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_port(spawned, n):
    """Every rank of the group returns the same full frame, equal to
    render_frame's within the bound, with no overflow and no CUDA launch
    (CPU ranks run the kernels' plain versions)."""
    outs = _sharded(spawned, n)
    img = outs[0]["img"]
    for rank, out in enumerate(outs):
        assert np.array_equal(out["img"], img), rank
        assert not out["overflowed"] and not any(out["launches"].values())
    _vs_single(img, spawned["single"]["frame"], f"n={n}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_jax(spawned, n):
    img = _sharded(spawned, n)[0]["img"]
    diff = np.abs(np.clip(img, 0.0, 1.0) - spawned["jax"]).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, f"n={n}: {frac:.4%} of pixels > 0.02"


def test_sharded_fast_preset_matches_port(spawned):
    """The fast preset at n=4: quarter-res SSAO bands of 34 rows and the
    half-res PCF factor gathered across bands."""
    _vs_single(spawned["runs"][0][1]["img"], spawned["single"]["fast"],
               "fast preset")


def test_replicated_frames_match_port(spawned):
    """2 x 2: ranks 0-1 render the first camera, ranks 2-3 the moved one,
    each pair band-sharded over its own group."""
    single = spawned["single"]
    assert not np.allclose(single["frame"], single["moved"])
    for rank, want in ((0, "frame"), (1, "frame"), (2, "moved"),
                       (3, "moved")):
        _vs_single(spawned["runs"][rank][2]["img"], single[want],
                   f"rank {rank}")


def test_sim_index_band_render(frame):
    """The per-device timing mode: each band alone, all_gathers replaced
    by n-fold copies of the local shard, gives a band of the right shape
    with no process group."""
    rt = frame["rt"]
    comm = sharded._Comm(None, 3, sim_index=1)
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.index() == 1
    assert torch.equal(comm.all_gather(x), torch.stack([x, x, x]))
    band_h = sharded.band_height(rt.cfg, 4)
    for d in (0, 3):
        img = sharded._band_render(rt.device_scene, frame["tc"], rt.cfg,
                                   sharded._Comm(None, 4, sim_index=d),
                                   band_h)
        assert img.shape == (band_h, rt.cfg.width, 4)
        assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("field,value", [
    ("deferred", False), ("use_pbr", False), ("alpha_test_enabled", True)])
def test_sharded_unported_setting_raises(field, value):
    cfg = dataclasses.replace(RenderConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        sharded.render_frame_sharded(None, None, cfg,
                                     sharded.BandMesh(None, 2))


def test_spawn_ranks_reports_a_failing_rank():
    """A rank that raises ends the job: the launcher raises with that
    rank's traceback (make_mesh2 refuses 3 x 1 groups in a job of 2) and
    leaves no process behind."""
    with pytest.raises(RuntimeError, match="3 x 1 ranks in a job of 2"):
        launch.spawn_ranks(sharded.make_mesh2, 2, "gloo", "cpu",
                           args=(3, 1), timeout=120)
