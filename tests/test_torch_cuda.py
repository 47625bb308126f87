"""The CUDA kernels against their plain versions, on the card.

- The raster kernel (csrc/raster.cu): no tolerance, depth and tid must be
  equal (torch.equal), for the full screen (K1, K2), for every owner's
  band launch (K3), whose bands reassembled equal the full screen's, and
  for the field-major launch (K4) on the transposed records.
- The soft PCF kernel (csrc/pcf.cu): 1e-5. Both sum the same <= 64 tent
  weights from the same parameters; the kernel keeps the plain version's
  order and rounds each operation on its own, so it is expected to be
  equal, and the bound leaves room for the order of the sums.

Imports torch and the port only (the card's machine has no jax). The
cases marked ``cuda`` skip without a CUDA device; run them on the card
with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.ops import pcf, raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz


def _random_tris(W, H, T, seed, device):
    """Random clip-space triangles (test_raster_pallas.py's recipe)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(T, 1, 4)).astype(np.float32)
    v = (centers + rng.uniform(-0.25, 0.25, size=(T, 3, 4))).astype(
        np.float32)
    v[..., 2] = rng.uniform(0.01, 0.99, (T, 3))
    v[..., 3] = 1.0
    return rz.setup_tri_verts(torch.from_numpy(v).to(device), None, W, H)


def _half_screen_tris(W, H, device):
    v = torch.tensor([[[-1, 1, 0.5, 1], [0, 1, 0.5, 1], [-1, -1, 0.5, 1]]],
                     dtype=torch.float32, device=device)
    return rz.setup_tri_verts(v, None, W, H)


CASES = {
    "random": lambda d: (_random_tris(256, 64, 60, 0, d), 256, 64, 4096),
    "ragged": lambda d: (_random_tris(200, 50, 80, 3, d), 200, 50, 4096),
    "dense": lambda d: (_random_tris(384, 72, 3000, 5, d), 384, 72, 1 << 17),
    "half_empty": lambda d: (_half_screen_tris(256, 32, d), 256, 32, 256),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _check(rec, starts, counts, W, H, ids, xrange, field=False):
    """One launch (field: K4 on the (16, P) transpose) against
    rasterize_plain, and its count."""
    before = dict(raster.LAUNCHES_BY_VARIANT)
    if field:
        d, t = raster.raster_tiles_field(rec.t().contiguous(), starts,
                                         counts, W, H, with_ids=ids,
                                         with_xrange=xrange)
    else:
        d, t = raster.raster_tiles(rec, starts, counts, W, H, with_ids=ids,
                                   with_xrange=xrange)
    torch.cuda.synchronize()
    key = ("field_" if field else "") + ("ids" if ids else "depth")
    assert raster.LAUNCHES_BY_VARIANT[key] == before[key] + 1
    d0, t0 = raster.rasterize_plain(rec, starts, counts, W, H, with_ids=ids,
                                    with_xrange=xrange)
    assert torch.equal(d, d0)
    assert (t is None and t0 is None) or torch.equal(t, t0)
    assert bool((d < 1.0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain(cuda, name):
    tris, W, H, cap = CASES[name](cuda)
    T = tris.xy.shape[0]
    for ids, xr in ((True, None),
                    (False, (torch.full((T,), 8.0, device=cuda),
                             torch.full((T,), 120.0, device=cuda)))):
        rec, starts, counts, over = raster.binned_records(tris, W, H, cap,
                                                          xrange=xr)
        assert not bool(over)
        _check(rec, starts, counts, W, H, ids, xr is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_field_major_kernel_equals_plain(cuda, name):
    """K4: the field-major kernel on the transposed records, with ids and
    depth-only with a column guard; ragged, empty and dense tiles."""
    tris, W, H, cap = CASES[name](cuda)
    T = tris.xy.shape[0]
    for ids, xr in ((True, None),
                    (False, (torch.full((T,), 8.0, device=cuda),
                             torch.full((T,), 120.0, device=cuda)))):
        rec, starts, counts, over = raster.binned_records(tris, W, H, cap,
                                                          xrange=xr)
        assert not bool(over)
        _check(rec, starts, counts, W, H, ids, xr is not None, field=True)


@pytest.mark.cuda
def test_kernel_equals_plain_config4_small(cuda):
    """Both of the frame's launches at 1/8 size, on the frame's inputs,
    with the records pair-major (K1, K2) and field-major (K4)."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=240, height=135, shadow_map_size=256)
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    c = r.frame_constants(0.0)
    tris, _ = fr.main_view_tris(r.device_scene, c, r.cfg)
    rec, st, cn, _ = raster.binned_records(tris, 240, 135,
                                           r.cfg.pair_capacity)
    _check(rec, st, cn, 240, 135, True, False)
    _check(rec, st, cn, 240, 135, True, False, field=True)
    atris, xr = fr.shadow_atlas_tris(r.device_scene, c.shadow_visibility,
                                     c.cascade_view_projs, r.cfg)
    rec, st, cn, _ = raster.binned_records(atris, 1024, 256,
                                           r.cfg.shadow_pair_capacity,
                                           xrange=xr)
    _check(rec, st, cn, 1024, 256, False, True)
    _check(rec, st, cn, 1024, 256, False, True, field=True)


def _config4_small_inputs(device):
    """(renderer, main-view tris, atlas tris, atlas xrange) of the 1/8
    config-4 frame on `device`."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=240, height=135, shadow_map_size=256)
    r = Renderer(scene, cfg, lights=lights, device=device)
    c = r.frame_constants(0.0)
    tris, _ = fr.main_view_tris(r.device_scene, c, r.cfg)
    atris, xr = fr.shadow_atlas_tris(r.device_scene, c.shadow_visibility,
                                     c.cascade_view_projs, r.cfg)
    return r, tris, atris, xr


@pytest.mark.cuda
@pytest.mark.parametrize("view,n", [("main", 4), ("atlas", 3)])
def test_band_kernel_equals_plain_config4_small(cuda, view, n):
    """K3 on each owner's interleaved tile rows equals rasterize_plain in
    the same band mode, and the n bands reassembled equal the full-screen
    launch (main view at n=4: 17 tile rows in 20 key rows; atlas at n=3:
    32 in 33)."""
    r, tris, atris, xr = _config4_small_inputs(cuda)
    if view == "main":
        args = (tris, 240, 136, r.cfg.pair_capacity)
        kw, ids = {}, True
    else:
        args = (atris, 1024, 256, r.cfg.shadow_pair_capacity)
        kw, ids = dict(xrange=xr), False
    W, H = args[1], args[2]
    full = raster.rasterize(*args, with_ids=ids, **kw)
    parts = []
    for d in range(n):
        rec, st, cn, over = raster.binned_records(*args, row_stride=(n, d),
                                                  **kw)
        assert not bool(over)
        off, rows = raster.band_grid(W, H, row_stride=(n, d))
        before = dict(raster.LAUNCHES_BY_VARIANT)
        dk, tk = raster.raster_tiles(rec, st, cn, W, rows, ids, not ids, off)
        torch.cuda.synchronize()
        key = "band_ids" if ids else "band_depth"
        assert raster.LAUNCHES_BY_VARIANT[key] == before[key] + 1
        dp, tp = raster.rasterize_plain(rec, st, cn, W, rows, ids, not ids,
                                        off)
        assert torch.equal(dk, dp) and (not ids or torch.equal(tk, tp))
        parts.append((dk, tk))
    rows = parts[0][0].shape[0]
    for i in range(2 if ids else 1):
        g = torch.stack([p[i] for p in parts]).reshape(n, rows // 8, 8, W)
        g = g.transpose(0, 1).reshape(n * rows, W)[:full[i].shape[0]]
        assert torch.equal(g, full[i])


@pytest.mark.cuda
def test_band_kernel_rejects_malformed_grid(cuda):
    """A band grid past the key space, off a tile row, or of partial tile
    rows is refused before anything launches."""
    rec = torch.zeros((128, 16), device=cuda)
    keys = torch.zeros(45, dtype=torch.int32, device=cuda)
    before = raster.LAUNCHES
    for off, rows in ((30, 16), (7, 8), (-15, 8), (15, 12)):
        with pytest.raises(ValueError, match="band of"):
            raster.raster_tiles(rec, keys, keys, 1920, rows,
                                tile_offset=off)
    assert raster.LAUNCHES == before
    d, _ = raster.raster_tiles(rec, keys, keys, 1920, 8, with_ids=False,
                               tile_offset=30)
    torch.cuda.synchronize()
    assert raster.LAUNCHES == before + 1 and bool((d == 1.0).all())


@pytest.mark.cuda
def test_sharded_frame_on_card(cuda):
    """Two gloo ranks sharing the card render the 1/8 frame: one K3 launch
    of each kind per rank, and the frame equal to render_frame's within
    tests/test_multichip.py's bound."""
    from crychic_renderer_tpu_torch.parallel import launch
    from crychic_renderer_tpu_torch.passes import frame as fr

    raster.LIBRARY.load()  # built here once; the ranks load it
    r, _, _, _ = _config4_small_inputs(cuda)
    c = r.frame_constants(0.0)
    ranks = launch.render_sharded([r.device_scene], [c], [(r.cfg, 0, (0,))],
                                  2, "gloo", cuda)
    ref = fr.render_frame(r.device_scene, c, r.cfg).cpu().numpy()
    for (out,) in ranks:
        assert out["launches"] == dict(ids=0, depth=0, band_ids=1,
                                       band_depth=1, field_ids=0,
                                       field_depth=0, pcf=0)
        diff = np.abs(out["img"] - ref).max(axis=-1)
        assert (diff > 0.02).mean() <= 1e-3


def test_wrapper_rejects_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never rasterized some other way."""
    rec = torch.empty((128, 16), device="meta")
    st = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        raster.raster_tiles(rec, st, st, 256, 8)


def _pcf_inputs(device, n=50000, S=256, seed=0):
    """Random receivers over the map and past its edges (u, v in [-0.05,
    1.05], w != 1), depths near the map's, against patchy maps."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(S), torch.arange(S), indexing="ij")
    maps = torch.stack([0.5 + 0.3 * torch.sin(xx / (7.0 + c))
                        * torch.cos(yy / (5.0 + c)) for c in range(4)])
    u = torch.rand(n, generator=g) * 1.1 - 0.05
    v = torch.rand(n, generator=g) * 1.1 - 0.05
    casc = torch.randint(0, 4, (n,), generator=g)
    ix = torch.clamp((u * S).long(), 0, S - 1)
    iy = torch.clamp((v * S).long(), 0, S - 1)
    z = maps[casc, iy, ix] + (torch.rand(n, generator=g) - 0.5) * 0.1
    w = 0.5 + torch.rand(n, generator=g) * 1.5
    pos = torch.stack([u * w, v * w, z * w, w], -1)
    qmap = pcf.quantize_map(maps.float().to(device))
    return qmap, pcf.receiver_params(pos.to(device), casc.to(device), S)


@pytest.mark.cuda
def test_pcf_kernel_equals_plain(cuda):
    qmap, params = _pcf_inputs(cuda)
    before = pcf.LAUNCHES
    got = pcf.soft_pcf(qmap, params, 2.5)
    torch.cuda.synchronize()
    assert pcf.LAUNCHES == before + 1
    ref = pcf.soft_pcf_plain(qmap, params, 2.5)
    assert float((got - ref).abs().max()) <= 1e-5
    assert 0.1 < float(((ref > 0) & (ref < 1)).float().mean())


@pytest.mark.cuda
def test_cuda_inputs_never_reach_the_plain_versions(cuda, monkeypatch):
    """With both plain versions made to fail, the wrappers and a whole
    soft-disk frame on the card still run: CUDA tensors go to the kernels
    only."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(pcf, "soft_pcf_plain", refuse)
    monkeypatch.setattr(raster, "rasterize_plain", refuse)
    qmap, params = _pcf_inputs(cuda, n=1000)
    pcf.soft_pcf(qmap, params, 2.5)
    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=240, height=135, shadow_map_size=256,
                              pcf_radius_texels=2.5)
    before = pcf.LAUNCHES
    img = Renderer(scene, cfg, lights=lights).render(0.0)
    torch.cuda.synchronize()
    assert img.is_cuda and bool(torch.isfinite(img).all())
    assert pcf.LAUNCHES == before + 1
