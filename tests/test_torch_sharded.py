"""The port's band-sharded frame (crychic_renderer_tpu_torch.parallel)
against the JAX package's band modes, on the CPU: band binning, records
and raster. The band passes are in test_torch_sharded_passes.py, the
sharded frames over gloo ranks in test_torch_sharded_frame.py and
test_torch_sharded_forward.py.

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
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.ops import raster_pallas as rp
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()

DZ = 1e-6          # band raster depth vs the interpret-mode Pallas kernel
ATOL = 1e-5        # band passes vs JAX's, eager


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, what, atol=ATOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def renderers():
    """Both packages' renderers of the 1/8 frame on one scene, the JAX one
    forced onto the Pallas kernel in interpret mode."""
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
    return rj, rt


def frame_inputs():
    """renderers(), both frames' constants and the JAX main-view and atlas
    triangles."""
    rj, rt = renderers()
    jc = rj.frame_constants(0.0)
    main, attr = jax.jit(lambda s, c: jfr.main_view_tris(s, c, rj.cfg))(
        rj.device_scene, jc)
    atlas, xr = jax.jit(lambda s, c: jfr.shadow_atlas_tris(
        s, c.shadow_visibility, c.cascade_view_projs, rj.cfg))(
            rj.device_scene, jc)
    return dict(rj=rj, rt=rt, jc=jc, tc=rt.frame_constants(0.0),
                main=main, attr=attr, atlas=atlas, xr=xr)


@pytest.fixture(scope="module")
def frame():
    return frame_inputs()


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
