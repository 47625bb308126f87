"""The band-sharded frame's passes (parallel/sharded.py with the band
arguments of passes/frame.py) against the JAX package's, on the CPU, and
the band capacities.

Inputs as in test_torch_sharded.py: BASELINE config 4 at 1/8 size, the
port's scene made from the JAX scene's leaves. Tolerances:

- ssao_occlusion, resolve_gbuffer, lighting_pass and apply_debug_overlay
  on one band (row_offset/full_height) against JAX's on the same band,
  eager: 1e-5.
- band_requirements equal to JAX's; check_band_capacity passes at the
  autosized capacities and raises below them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu.ops import ssao as jssao
from crychic_renderer_tpu.parallel import sharded as jsh
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import ssao as ssao_ops
from crychic_renderer_tpu_torch.parallel import sharded
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_sharded import _close, _t, _tris_t, frame_inputs
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def frame():
    return frame_inputs()


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
