"""The port's binning, pair records and raster (ops.rasterizer, ops.raster)
against the JAX package's, on the same triangles.

The JAX side runs eagerly here, op by op, so XLA fuses nothing across ops
and rounds each one as eager torch does. Tolerances, measured on this
suite's inputs:

- Binning (order, starts, counts, sorted_tile, num_valid, overflowed) and
  the pair records: exact.
- The raster (rasterize_plain against the Pallas kernel in interpret
  mode): tid differs on <= 0.1% of pixels and depth by <= 1e-6 where the
  tids agree. Measured: no tid differs anywhere; max |dz| 9.5e-7 (random),
  4.8e-7 (ragged), 0 (half_empty, config 4 main view), 6e-8 (config 4
  atlas). The depth residue is XLA's FMA contraction inside the traced
  kernel body, ((A*px) + (B*py)) + C evaluated as fused multiply-adds,
  where torch rounds every op.

On the card the kernel equals rasterize_plain bit for bit: see
tests/test_torch_cuda.py.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.ops import raster_pallas as rp
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from tests.test_torch_cuda import sliver_tris
from torch_threads import cap_torch_threads

cap_torch_threads()

TID_FRAC = 1e-3   # tids may differ on at most 0.1% of pixels
DZ = 1e-6         # max |depth difference| where the tids agree


def _to_torch(tris) -> rz.ScreenTris:
    return rz.ScreenTris(*(torch.from_numpy(np.array(x)) for x in tris))


def _random_tris(W, H, T=60, seed=0):
    """test_raster_pallas.py's scene: random clip-space triangles."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(T, 1, 4)).astype(np.float32)
    verts = (centers + rng.uniform(-0.25, 0.25, size=(T, 3, 4))).astype(
        np.float32).reshape(T * 3, 4)
    verts[:, 2] = rng.uniform(0.01, 0.99, T * 3)
    verts[:, 3] = 1.0
    idx = np.arange(T * 3, dtype=np.int32)
    return jrz.setup_triangles(jax.numpy.asarray(verts),
                               jax.numpy.asarray(idx), W, H)


def _half_screen_tris(W, H):
    """test_raster_pallas.py's empty/full tile case: one big triangle on
    the left, no geometry on the right."""
    verts = np.array([[-1, 1, 0.5, 1], [0, 1, 0.5, 1], [-1, -1, 0.5, 1]],
                     np.float32)
    return jrz.setup_triangles(jax.numpy.asarray(verts),
                               jax.numpy.asarray(np.arange(3, dtype=np.int32)),
                               W, H)


def _jax_records(tris, W, H, cap, xrange=None):
    """The JAX package's kernel records (P, 16) and its bins."""
    ntx = -(-W // rp.TILE_W)
    nty = -(-H // rp.TILE_H)
    bins = jrz.bin_triangles(tris, W, H, cap, tile_h=rp.TILE_H,
                             tile_w=rp.TILE_W)
    rec = rp.build_records(tris, bins, ntx, ntx * nty, rp.TILE_H, xrange)
    return bins, np.asarray(rec).reshape(16, -1).T


def _compare(d_ref, t_ref, d, t, what):
    d_ref, d = np.asarray(d_ref), np.asarray(d)
    if t_ref is None:
        # depth-only (atlas): compare depth where both are covered or both
        # clear; coverage flips count like tid mismatches
        cov_ref, cov = d_ref < 1.0, d < 1.0
        flips = cov_ref != cov
        same = ~flips
    else:
        t_ref, t = np.asarray(t_ref), np.asarray(t)
        flips = t_ref != t
        same = ~flips
    frac = flips.mean()
    dz = np.abs(d_ref - d)[same].max() if same.any() else 0.0
    assert frac <= TID_FRAC, f"{what}: {frac:.4%} of pixels flip ({flips.sum()})"
    assert dz <= DZ, f"{what}: max |dz| {dz:.3g} > {DZ:g}"
    return frac, dz


SCENES = {
    "random": (lambda: _random_tris(256, 64), 256, 64, 4096),
    "ragged": (lambda: _random_tris(200, 50, T=80, seed=3), 200, 50, 4096),
    "half_empty": (lambda: _half_screen_tris(256, 32), 256, 32, 256),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_binning_matches_jax(name):
    make, W, H, cap = SCENES[name]
    tris = make()
    bj = jrz.bin_triangles(tris, W, H, cap, tile_h=8, tile_w=128)
    bt = rz.bin_triangles(_to_torch(tris), W, H, cap, tile_h=8, tile_w=128)
    for f in bj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                      getattr(bt, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_raster_matches_pallas(name):
    """The port's rasterize (records + rasterize_plain on the CPU) against
    the Pallas kernel in interpret mode, ragged and empty tiles included."""
    make, W, H, cap = SCENES[name]
    tris = make()
    d_ref, t_ref = rp.rasterize_pallas(tris, W, H, cap, interpret=True)
    d, t, over = raster.rasterize(_to_torch(tris), W, H, cap)
    assert not bool(over)
    _compare(d_ref, t_ref, d, t, name)
    if name == "half_empty":
        t = t.numpy()
        assert (t[:, 192:] == -1).all() and (d.numpy()[:, 192:] == 1.0).all()


def test_raster_overflow_is_reported():
    tris = _to_torch(_random_tris(256, 64, T=400))
    bins = rz.bin_triangles(tris, 256, 64, 4096, tile_h=8)
    assert 128 < int(bins.num_valid) < 4096
    _, _, over = raster.rasterize(tris, 256, 64, 128)
    assert bool(over)


# ---------------------------------------------------------------------------
# Config 4 at 1/8 size: the frame's own main-view and atlas inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def config4_small():
    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.passes import frame as jfr

    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=cfg.width // 8,
                              height=cfg.height // 8, shadow_map_size=256,
                              pair_capacity=1 << 16,
                              shadow_pair_capacity=1 << 17)
    r = Renderer(scene, cfg, lights=lights, auto_capacity=False)
    consts = r.frame_constants(0.0)
    main, _ = jax.jit(functools.partial(jfr.main_view_tris, cfg=cfg))(
        r.device_scene, consts)
    atlas, xr = jax.jit(lambda s, c: jfr.shadow_atlas_tris(
        s, c.shadow_visibility, c.cascade_view_projs, cfg))(
            r.device_scene, consts)
    return cfg, main, atlas, xr


def test_config4_binning_matches_jax(config4_small):
    cfg, main, atlas, _ = config4_small
    S = cfg.shadow_map_size
    for tris, W, H, cap in ((main, cfg.width, cfg.height, cfg.pair_capacity),
                            (atlas, 4 * S, S, cfg.shadow_pair_capacity)):
        bj = jrz.bin_triangles(tris, W, H, cap, tile_h=8, tile_w=128)
        bt = rz.bin_triangles(_to_torch(tris), W, H, cap, tile_h=8,
                              tile_w=128)
        assert not bool(bt.overflowed)
        for f in bj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                          getattr(bt, f).numpy(), err_msg=f)


def _config4_view(config4_small, view):
    """(JAX tris, W, H, capacity, JAX xrange, with_ids) of one launch."""
    cfg, main, atlas, xr = config4_small
    S = cfg.shadow_map_size
    if view == "main":
        return main, cfg.width, cfg.height, cfg.pair_capacity, None, True
    return atlas, 4 * S, S, cfg.shadow_pair_capacity, xr, False


def _xrange_t(xrange):
    return None if xrange is None else tuple(
        torch.from_numpy(np.array(x)) for x in xrange)


@pytest.mark.parametrize("view", ["main", "atlas"])
def test_config4_records_match_jax(config4_small, view):
    tris, W, H, cap, xrange, _ = _config4_view(config4_small, view)
    bins, rec_j = _jax_records(tris, W, H, cap, xrange)
    rec_t, _, _, _ = raster.binned_records(_to_torch(tris), W, H, cap,
                                           xrange=_xrange_t(xrange))
    n = int(bins.num_valid)
    np.testing.assert_array_equal(rec_t.numpy()[:n], rec_j[:n])


def _reject_case(request, case):
    """(records of the valid pairs, with_xrange) of one reject case."""
    if case.startswith("slivers"):
        tris, W, H, cap, xr = sliver_tris("cpu")
        guard = case == "slivers_guard"
        rec, _, counts, over = raster.binned_records(
            tris, W, H, cap, xrange=xr if guard else None)
    else:
        view = case.split("_")[1]
        tris, W, H, cap, xrange, _ = _config4_view(
            request.getfixturevalue("config4_small"), view)
        guard = xrange is not None
        rec, _, counts, over = raster.binned_records(
            _to_torch(tris), W, H, cap, xrange=_xrange_t(xrange))
    assert not bool(over)
    return rec[:int(counts.sum())], guard


# measured reject shares of (record, warp): config4_main 0.8268 (live
# 0.0889), config4_atlas 0.8792 (0.0608), slivers 0.7710 (0.1798),
# slivers_guard 0.9545 (0.0349)
@pytest.mark.parametrize("case", ["config4_main", "config4_atlas", "slivers",
                                  "slivers_guard"])
def test_warp_reject_is_conservative(request, case):
    """The raster kernel's warp-level reject, mirrored by
    raster.warp_rejects (same margin, same corner choice), never skips a
    (record, warp) whose rectangle holds a pixel that rasterize_plain's
    arithmetic covers: on the 1/8-size config-4 main-view and atlas
    records, and on ~2,000 seeded slivers, near-degenerate, corner-lattice
    and off-tile triangles (tests/test_torch_cuda.py sliver_tris), with
    and without their column guard. Prints the share it skips."""
    rec, guard = _reject_case(request, case)
    rejected = raster.warp_rejects(rec, guard)
    live = raster.warp_covers(rec, guard)
    wrong = rejected & live
    assert not bool(wrong.any()), (
        f"{case}: {int(wrong.sum())} rejected (record, warp) pairs cover a "
        f"pixel")
    share = float(rejected.float().mean())
    print(f"{case}: {rec.shape[0]} records, reject share {share:.4f}, "
          f"live share {float(live.float().mean()):.4f}")
    assert share > 0.5


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
def test_warp_reject_nonfinite_records(value):
    """A NaN or infinite plane coefficient never gets a record rejected
    (the kernel evaluates it as before); in the column guard the compare
    is exact, so xlo = +inf or xhi = -inf (no centre inside) is rejected
    and NaN is not. The record otherwise covers the whole tile (edges 1,
    z 0.5); with edge 0's C at -1 it covers nothing and is rejected."""
    base = torch.zeros((1, raster.REC_ROWS))
    base[0, 6:9] = 1.0
    base[0, 11] = 0.5
    base[0, 13], base[0, 14] = -3e7, 3e7
    recs, want = [base], [False]
    dead = base.clone()
    dead[0, 6] = -1.0
    recs.append(dead)
    want.append(True)
    for k in [*range(12), 13, 14]:
        r = base.clone()
        r[0, k] = value
        recs.append(r)
        want.append((k == 13 and value == float("inf"))
                    or (k == 14 and value == float("-inf")))
    rec = torch.cat(recs)
    rejected = raster.warp_rejects(rec, True)
    assert rejected.tolist() == [[w] * raster.WARPS for w in want]
    assert not bool((rejected & raster.warp_covers(rec, True)).any())


@pytest.mark.parametrize("view", ["main", "atlas"])
def test_config4_plain_raster_matches_pallas(config4_small, view):
    tris, W, H, cap, xrange, ids = _config4_view(config4_small, view)
    if ids:
        d_ref, t_ref = rp.rasterize_pallas(tris, W, H, cap, interpret=True)
    else:
        d_ref, t_ref = rp.rasterize_pallas(tris, W, H, cap, tile_h=8,
                                           with_ids=False, interpret=True,
                                           xrange=xrange, tiles_per_prog=32)
    d, t, over = raster.rasterize(_to_torch(tris), W, H, cap, with_ids=ids,
                                  xrange=_xrange_t(xrange))
    assert not bool(over)
    _compare(d_ref, t_ref, d, t, f"config 4 {view}")
