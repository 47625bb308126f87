"""The CUDA kernels against their plain versions, on the card.

- The raster kernel (csrc/raster.cu): no tolerance, depth and tid must be
  equal (torch.equal), for the full screen (K1, K2), for every owner's
  band launch (K3), whose bands reassembled equal the full screen's, and
  for the field-major launch (K4) on the transposed records; on the
  sliver set of its warp-level reject (sliver_tris, shared with
  tests/test_torch_raster.py) and on atlas records under column guards
  that cut through the warps' rectangles.
- The soft PCF kernel (csrc/pcf.cu): 1e-5. Both sum the same <= 64 tent
  weights from the same parameters; the kernel keeps the plain version's
  order and rounds each operation on its own, so it is expected to be
  equal, and the bound leaves room for the order of the sums. Also on
  receivers near every edge and corner of the map (windows on the last
  block read the window-ready buffer's padding) at S = 136, 256, 520 and
  2048, on NaN, infinite and huge parameters, on a buffer of many
  cascades past the card's texture height (the scalar path), and an
  address off the texture alignment raises.
- Frames on the card against the port's CPU path at 240x135 (at most
  0.5% of pixels above 0.02): the forward Blinn-Phong frame with shadows,
  the fence scene's alpha layer, the soft disk on 520^2 maps, and config
  5 built from the SMALL synthetic asset set with its loaded cube, at two
  BoltAnim frames.
- The tile-compacted frame on the card (config 4 at 512x192 pitched up,
  64 of 96 tiles per pass): equal to the dense frame on the card within
  1e-5, and to the CPU path within the 0.5% bound.
- Renderer.render queues a frame without a host sync: a config-4 frame
  at 480x270 under torch.cuda.set_sync_debug_mode("error") equals
  (torch.equal) the same frame rendered with the mode off.
- The compiled frame (a CUDA graph that Renderer.render replays), config
  4 at 480x270: the replay equals render_frame on the same constants
  (torch.equal, or within 1e-5 and no pixel above 0.02 where two eager
  frames differ too), with the zero radius and the soft disk; a frame
  held across the next render() is unchanged; the launch counts of the
  first render (eager frame and replay) and of each replay; close() gives
  back the graph's pool; a host read patched into render_frame makes the
  capture raise, twice (a process of its own); K6's texture object in the
  graph outlives a reset of the eager path's texture cache.
- The pure-XLA raster path (use_pallas=False) and a scene without
  static tables, config 4 at 480x270 through Renderer.render on the card:
  the XLA-path frame against the kernel frame on the card and against
  the XLA path on the CPU (at most 0.5% of pixels above 0.02 each), with
  no K1/K2 launch; the frame without static tables equal to the frame
  with them (torch.equal, or within 1e-5 and no pixel above 0.02).
- The compiled band frame (parallel/graphs.CompiledBandFrame), config 4
  at 480x270: on 2 gloo ranks sharing the card (piecewise graphs, the
  gathers + 1) with the zero radius and the soft disk, and on 1 NCCL
  rank (the whole frame, its collectives inside, one graph), each rank's
  replay torch.equal to its eager band frame; a host read patched into
  the band frame makes the capture raise, twice (a process of its own).

Imports torch and the port only (the card's machine has no jax). The
cases marked ``cuda`` skip without a CUDA device; run them on the card
with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.ops import pcf, raster, tally
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from torch_threads import cap_torch_threads

cap_torch_threads()


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


def sliver_tris(device, n=2048, seed=11):
    """~2,000 seeded screen-space triangles that test the raster kernel's
    warp-level reject at its edges, on a 512x64 screen (4 x 8 tiles): long
    slivers down to 1/256 px wide, near-degenerate and sub-pixel ones,
    ones with vertices on pixel centres at the warps' rectangle corners
    (edges through corner centres), ones hugging tile corners (bbox in
    tiles they do not cover) and a few huge ones; z in [-0.3, 1.3] at the
    vertices; and a column guard per triangle, some of it on warp
    boundaries. Returns (tris, W, H, pair capacity, xrange)."""
    W, H = 512, 64
    rng = np.random.default_rng(seed)
    k = n // 4
    # slivers: a long axis and a width of 1/256 .. 1 px
    c = rng.uniform([-20, -20], [W + 20, H + 20], (k, 2))
    ang = rng.uniform(0, 2 * np.pi, k)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    nrm = np.stack([-d[:, 1], d[:, 0]], -1)
    L = rng.uniform(20, 300, k)[:, None]
    wd = (2.0 ** rng.uniform(-8, 0, k))[:, None]
    t = rng.uniform(-0.4, 0.4, k)[:, None]
    sliver = np.stack([c - 0.5 * L * d, c + 0.5 * L * d,
                       c + t * L * d + wd * nrm], 1)
    # near-degenerate: almost collinear, or under 1.5 px
    p0 = rng.uniform([0, 0], [W, H], (k, 2))
    v = rng.uniform(-40, 40, (k, 2))
    eps = rng.uniform(1 / 256, 0.05, (k, 1)) * np.sign(rng.uniform(-1, 1,
                                                                    (k, 1)))
    tiny = rng.uniform(-1.5, 1.5, (k, 2, 2))
    small = rng.uniform(0, 1, k) < 0.5
    degen = np.stack([p0, p0 + v, p0 + 0.5 * v + eps * v[:, ::-1] * [1, -1]],
                     1)
    degen[small, 1] = p0[small] + tiny[small, 0]
    degen[small, 2] = p0[small] + tiny[small, 1]
    # pixel centres at the warps' rectangle corners (x = 16w + 0.5 or
    # 16w + 15.5, y = 8r + 0.5 or 8r + 7.5), moved by whole pixels
    cx = (16 * rng.integers(0, W // 16, (k, 3))
          + rng.choice([0.5, 15.5], (k, 3)) + rng.integers(-3, 4, (k, 3)))
    cy = (8 * rng.integers(0, H // 8, (k, 3)) + rng.choice([0.5, 7.5], (k, 3))
          + rng.integers(-3, 4, (k, 3)))
    lattice = np.stack([cx, cy], -1)
    # tile-corner huggers: a right triangle in one quadrant of a tile
    # corner whose hypotenuse passes the corner within ~1.5 px, so its
    # bbox reaches the neighbouring tiles; and 16 huge ones
    m = n - 3 * k
    corner = np.stack([128 * rng.integers(1, W // 128, m),
                       8 * rng.integers(1, H // 8, m)], -1).astype(np.float64)
    s = rng.choice([-1.0, 1.0], (m, 2))
    a = rng.uniform(2, 60, m)
    b = rng.uniform(1, 6, m)
    d1, d2 = rng.uniform(0, 1.5, (2, m))
    hug = corner[:, None] + s[:, None] * np.stack(
        [np.stack([a, -d1], -1), np.stack([-d2, b], -1),
         np.stack([a, b], -1)], 1)
    hug[:16] = rng.uniform(-1e4, 1e4, (16, 3, 2))
    xy = np.concatenate([sliver, degen, lattice, hug]).astype(np.float32)
    xy = rz.snap_xy(torch.from_numpy(xy)).numpy()
    area2 = ((xy[:, 1, 0] - xy[:, 0, 0]) * (xy[:, 2, 1] - xy[:, 0, 1])
             - (xy[:, 1, 1] - xy[:, 0, 1]) * (xy[:, 2, 0] - xy[:, 0, 0]))
    xy = np.where((area2 < 0)[:, None, None], xy[:, ::-1], xy)
    z = rng.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    tris = rz.ScreenTris(
        torch.from_numpy(np.ascontiguousarray(xy)).to(device),
        torch.from_numpy(z).to(device),
        torch.ones((n, 3), device=device), torch.from_numpy(area2 != 0)
        .to(device))
    xlo = (rng.integers(-10, W, n) + rng.choice([0.0, 0.25, 0.5], n))
    on_warp = rng.uniform(0, 1, n) < 0.3
    xlo = np.where(on_warp, 16 * rng.integers(0, W // 16, n) + 0.5, xlo)
    xhi = xlo + rng.integers(0, 200, n) + rng.choice([0.0, 0.5], n)
    xrange = tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                   for x in (xlo, xhi))
    return tris, W, H, 1 << 17, xrange


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
    before = tally.snapshot()
    if field:
        d, t = raster.raster_tiles_field(rec.t().contiguous(), starts,
                                         counts, W, H, with_ids=ids,
                                         with_xrange=xrange)
    else:
        d, t = raster.raster_tiles(rec, starts, counts, W, H, with_ids=ids,
                                   with_xrange=xrange)
    torch.cuda.synchronize()
    key = "raster." + ("field_" if field else "") + ("ids" if ids
                                                     else "depth")
    assert tally.since(before) == {key: 1}
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


@pytest.mark.cuda
def test_kernel_equals_plain_slivers(cuda):
    """The warp-level reject's sliver set (sliver_tris) with ids, depth
    only, and depth with its column guard, pair-major (K1/K2) and
    field-major (K4)."""
    tris, W, H, cap, xr = sliver_tris(cuda)
    for ids, guard in ((True, False), (False, False), (False, True)):
        rec, st, cn, over = raster.binned_records(
            tris, W, H, cap, xrange=xr if guard else None)
        assert not bool(over)
        for field in (False, True):
            _check(rec, st, cn, W, H, ids, guard, field=field)


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
def test_kernel_equals_plain_atlas_guards(cuda):
    """The 1/8 atlas's triangles under seeded column guards that start on
    and between the warps' 16-column boundaries, pair-major (K2) and
    field-major (K4)."""
    r, _, atris, _ = _config4_small_inputs(cuda)
    T = atris.xy.shape[0]
    rng = np.random.default_rng(5)
    xlo = 16 * rng.integers(0, 64, T) + rng.choice([0.0, 0.5, 7.25, 15.5], T)
    xhi = xlo + rng.integers(1, 300, T) + rng.choice([0.0, 0.5], T)
    xr = tuple(torch.from_numpy(x.astype(np.float32)).to(cuda)
               for x in (xlo, xhi))
    rec, st, cn, over = raster.binned_records(
        atris, 1024, 256, r.cfg.shadow_pair_capacity, xrange=xr)
    assert not bool(over)
    _check(rec, st, cn, 1024, 256, False, True)
    _check(rec, st, cn, 1024, 256, False, True, field=True)


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
        before = tally.snapshot()
        dk, tk = raster.raster_tiles(rec, st, cn, W, rows, ids, not ids, off)
        torch.cuda.synchronize()
        key = "raster.band_ids" if ids else "raster.band_depth"
        assert tally.since(before) == {key: 1}
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
    before = tally.snapshot()
    for off, rows in ((30, 16), (7, 8), (-15, 8), (15, 12)):
        with pytest.raises(ValueError, match="band of"):
            raster.raster_tiles(rec, keys, keys, 1920, rows,
                                tile_offset=off)
    assert tally.since(before) == {}
    d, _ = raster.raster_tiles(rec, keys, keys, 1920, 8, with_ids=False,
                               tile_offset=30)
    torch.cuda.synchronize()
    assert tally.since(before) == {"raster.band_depth": 1}
    assert bool((d == 1.0).all())


@pytest.mark.cuda
def test_sharded_frame_on_card(cuda):
    """Two gloo ranks sharing the card render the 1/8 frame, compiled (the
    default): two K3 launches of each kind per rank (the eager frame
    before the capture and the replay), and the frame equal to
    render_frame's within tests/test_multichip.py's bound."""
    from crychic_renderer_tpu_torch.parallel import launch
    from crychic_renderer_tpu_torch.passes import frame as fr

    raster.LIBRARY.load()  # built here once; the ranks load it
    r, _, _, _ = _config4_small_inputs(cuda)
    c = r.frame_constants(0.0)
    ranks = launch.render_sharded([r.device_scene], [c], [(r.cfg, 0, (0,))],
                                  2, "gloo", cuda)
    ref = fr.render_frame(r.device_scene, c, r.cfg).cpu().numpy()
    for (out,) in ranks:
        assert out["launches"] == dict(ids=0, depth=0, band_ids=2,
                                       band_depth=2, field_ids=0,
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
    before = tally.snapshot()
    got = pcf.soft_pcf(qmap, params, 2.5)
    torch.cuda.synchronize()
    assert tally.since(before) == {"pcf": 1}
    ref = pcf.soft_pcf_plain(qmap, params, 2.5)
    assert float((got - ref).abs().max()) <= 1e-5
    assert 0.1 < float(((ref > 0) & (ref < 1)).float().mean())


def _edge_params(device, S=256, n=20001, seed=3):
    """(qmap, params): n (odd) receivers whose window corner cx, cy lies
    within 8 texels of the map's low edge, within 8 of its high edge, or
    inside, independently in x and y, so every edge and corner is hit, in
    all 4 cascades; depths near the map's."""
    rng = np.random.default_rng(seed)

    def coord():
        return np.choose(rng.integers(0, 3, n),
                         [rng.uniform(-8.5, 8.5, n),
                          rng.uniform(S - 9.5, S + 7.5, n),
                          rng.uniform(8.0, S - 9.0, n)])

    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    maps = np.stack([0.5 + 0.3 * np.sin(xx / (7.0 + c))
                     * np.cos(yy / (5.0 + c)) for c in range(4)])
    cx, cy = coord(), coord()
    casc = rng.integers(0, 4, n)
    ix = np.clip(np.floor(cx + 0.5).astype(int), 0, S - 1)
    iy = np.clip(np.floor(cy + 0.5).astype(int), 0, S - 1)
    dq = (maps[casc, iy, ix] + rng.uniform(-0.05, 0.05, n)) * 65535.0 - 0.5
    theta = rng.uniform(0, 2 * np.pi, n)
    params = np.stack([cx, cy, dq, np.cos(theta), np.sin(theta), casc])
    qmap = pcf.quantize_map(torch.from_numpy(maps).float().to(device))
    return qmap, torch.from_numpy(params.astype(np.float32)).to(device)


@pytest.mark.cuda
def test_pcf_kernel_map_edges(cuda):
    """K6 on receivers near every edge and corner of the map, windows
    inside it and on its last 8-texel block (read from the buffer's
    padding), all gathered through the texture: equal to plain."""
    qmap, params = _edge_params(cuda)
    nb = pcf.map_size(qmap) // 8
    q = torch.clamp((torch.floor(params[:2]) - 3).long() >> 3, 0, nb - 1)
    last = float((q == nb - 1).any(dim=0).float().mean())
    assert 0.2 < last < 0.8, last
    got = pcf.soft_pcf(qmap, params, 2.5)
    torch.cuda.synchronize()
    ref = pcf.soft_pcf_plain(qmap, params, 2.5)
    assert float((got - ref).abs().max()) <= 1e-5
    assert 0.05 < float(((ref > 0) & (ref < 1)).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf"), 1e30, -1e30])
def test_pcf_kernel_nonfinite_params(cuda, value):
    """Each of the six parameters set to NaN, +-inf or +-1e30 on its own
    slice of receivers: finite factors within 1e-5 of plain."""
    qmap, params = _pcf_inputs(cuda, n=6000)
    params = params.clone()
    for k in range(pcf.PARAMS):
        params[k, 1000 * k:1000 * (k + 1)] = value
    got = pcf.soft_pcf(qmap, params, 2.5)
    torch.cuda.synchronize()
    ref = pcf.soft_pcf_plain(qmap, params, 2.5)
    assert bool(torch.isfinite(ref).all()) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5


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
    before = tally.snapshot()
    img = Renderer(scene, cfg, lights=lights).render(0.0)
    torch.cuda.synchronize()
    assert img.is_cuda and bool(torch.isfinite(img).all())
    # the first render: the eager frame before the capture, then a replay
    assert tally.since(before)["pcf"] == 2


@pytest.mark.cuda
def test_pcf_kernel_untexturable_maps(cuda):
    """Maps the card could not texture before the window-ready buffer: S
    = 520 (1,040-byte rows, off the H100's 32-byte texture pitch
    alignment) now has a texture object (544-texel pitch) and agrees with
    plain; a buffer at an address off the texture alignment raises, and
    nothing is launched."""
    for qmap, params in (_pcf_inputs(cuda, S=520), _edge_params(cuda, S=520)):
        tex, has_tex = pcf.make_texture(qmap)
        assert has_tex == 1
        pcf.destroy_texture(tex)
        before = tally.snapshot()
        got = pcf.soft_pcf(qmap, params, 2.5)
        torch.cuda.synchronize()
        assert tally.since(before) == {"pcf": 1}
        ref = pcf.soft_pcf_plain(qmap, params, 2.5)
        assert float((got - ref).abs().max()) <= 1e-5
    qmap, params = _pcf_inputs(cuda)
    buf = torch.empty(qmap.numel() + 1, dtype=qmap.dtype, device=cuda)
    shifted = buf[1:].view(qmap.shape)
    shifted.copy_(qmap)
    assert shifted.data_ptr() % 512 != 0 and shifted.is_contiguous()
    before = tally.snapshot()
    with pytest.raises(RuntimeError, match="misaligned"):
        pcf.soft_pcf(shifted, params, 2.5)
    assert tally.since(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("S", [136, 520, 2048])
def test_pcf_kernel_window_ready_sizes(cuda, S):
    """K6 at S = 136, 520 and 2048 on receivers near every edge and
    corner: the buffer is within the texture limits, so every receiver is
    gathered; within 1e-5 of plain."""
    qmap, params = _edge_params(cuda, S=S)
    lim = pcf.texture_limits(cuda)
    assert qmap.shape[0] * qmap.shape[1] <= lim["max_height"]
    assert (2 * qmap.shape[2]) % lim["pitch_align"] == 0
    got = pcf.soft_pcf(qmap, params, 2.5)
    torch.cuda.synchronize()
    ref = pcf.soft_pcf_plain(qmap, params, 2.5)
    assert float((got - ref).abs().max()) <= 1e-5
    assert 0.05 < float(((ref > 0) & (ref < 1)).float().mean())


@pytest.mark.cuda
def test_pcf_kernel_past_texture_limits(cuda):
    """A buffer of one cascade more than the card's pitch-linear texture
    height holds at S = 136 (65,000 rows on an H100 hold 451 cascades of
    144 rows) gets no texture object and takes the scalar path, within
    1e-5 of plain, eagerly and through an owned buffer; 451 cascades are
    textured."""
    S = 136
    lim = pcf.texture_limits(cuda)
    fit = lim["max_height"] // (S + pcf.WINDOW_PAD)
    rng = np.random.default_rng(11)
    for n, textured in ((fit + 1, 0), (fit, 1)):
        maps = torch.from_numpy(rng.uniform(0.3, 0.7, (n, S, S))
                                .astype(np.float32)).to(cuda)
        m = 20001
        theta = rng.uniform(0, 2 * np.pi, m)
        params = torch.from_numpy(np.stack([
            rng.uniform(-8.5, S + 7.5, m), rng.uniform(-8.5, S + 7.5, m),
            rng.uniform(0.3, 0.7, m) * 65535.0 - 0.5, np.cos(theta),
            np.sin(theta), rng.integers(0, n, m)]).astype(np.float32)).to(
                cuda)
        owned = pcf.OwnedMaps()
        with pcf.owned_maps(owned):
            qmap = pcf.quantize_map(maps)
            got_owned = pcf.soft_pcf(qmap, params, 2.5)
        assert owned.texture(qmap)[1] == textured
        got = pcf.soft_pcf(qmap, params, 2.5)
        torch.cuda.synchronize()
        owned.release()
        ref = pcf.soft_pcf_plain(qmap, params, 2.5)
        assert float((got - ref).abs().max()) <= 1e-5
        assert torch.equal(got, got_owned)
        assert 0.1 < float(((ref > 0) & (ref < 1)).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["forward", "fence", "soft_520"])
def test_frame_on_card_matches_cpu(cuda, case):
    """240x135 frames on the card against the port's CPU path (at most
    0.5% of pixels above 0.02): config 4 forward with Blinn-Phong and
    shadows (K1, K2 and the quad), the fence scene with the synthetic
    wire grid (the alpha peel and punch), and config 4 with the soft disk
    on 520^2 maps (K6 on their 544-texel-pitch window-ready buffer)."""
    from crychic_renderer_tpu_torch.app import renderer as tren
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    if case == "fence":
        scene, cfg, lights = sb.fence_scene(alpha_test=True)
        cfg = dataclasses.replace(cfg, width=240, height=135)
    else:
        scene, cfg, lights = sb.config4_shadow_pipeline()
        over = (dict(deferred=False, use_pbr=False) if case == "forward"
                else dict(shadow_map_size=520, pcf_radius_texels=2.5))
        cfg = dataclasses.replace(cfg, width=240, height=135,
                                  **{"shadow_map_size": 256, **over})
    with tren.synthetic_wire_fence():
        imgs = [tren.Renderer(scene, cfg, lights=lights,
                              device=d).render_np(0.0)
                for d in (cuda, "cpu")]
    assert np.isfinite(imgs[0]).all()
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert (diff > 0.02).mean() <= 0.005, (case, (diff > 0.02).mean())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["xla", "no_statics"])
def test_xla_and_no_statics_frames_on_card(cuda, case):
    """Config 4 at 480x270 through Renderer.render on the card. "xla":
    use_pallas=False launches no raster kernel and stays within 0.5% of
    pixels above 0.02 of the kernel frame on the card and of the same
    path on the CPU. "no_statics": the scene's draws without their
    static tables give the frame with them."""
    from crychic_renderer_tpu_torch.app import renderer as tren
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg, lights = sb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, width=480, height=270,
                              shadow_map_size=512)
    kernel = tren.Renderer(scene, cfg, lights=lights, device=cuda)
    want = kernel.render(0.0)
    if case == "xla":
        xcfg = dataclasses.replace(cfg, use_pallas=False)
        r = tren.Renderer(scene, xcfg, lights=lights, device=cuda)
        before = tally.snapshot()
        got = r.render(0.0)
        torch.cuda.synchronize()
        assert not any(k.startswith("raster.") for k in tally.since(before))
        cpu = tren.Renderer(scene, xcfg, lights=lights,
                            device="cpu").render_np(0.0)
        for ref in (want, torch.from_numpy(cpu).to(cuda)):
            diff = (got.clamp(0.0, 1.0) - ref.clamp(0.0, 1.0)).abs()
            assert float((diff.amax(-1) > 0.02).float().mean()) <= 0.005
    else:
        r = tren.Renderer(scene, cfg, lights=lights, device=cuda)
        r.device_scene = fr.strip_draw_statics(r.device_scene)
        got = r.render(0.0)
        if not torch.equal(got, want):
            diff = (got - want).abs().amax(dim=-1)
            assert float(diff.max()) <= 1e-5 and not bool((diff > 0.02).any())
    r.check_overflow()
    assert bool(got.isfinite().all())


@pytest.mark.cuda
def test_config5_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """Config 5 from files (the SMALL synthetic asset set: DXT5/DXT1/RGBA8
    textures, BMP frames, a DXT1 cube, the car and a 2,000-triangle
    skull) at 240x135 on the card against the port's CPU path, at t = 0
    and 0.1 (two BoltAnim frames): at most 0.5% of pixels above 0.02."""
    from crychic_renderer_tpu_torch.app import renderer as tren
    from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    paths = sa.write_asset_set(str(tmp_path), sa.SMALL, seed=0)
    monkeypatch.setattr(sb, "REF_MODELS", paths["models"])
    scene, cfg, lights = sb.CONFIGS[5]()
    cfg = dataclasses.replace(cfg, width=240, height=135,
                              shadow_map_size=256)
    rs = [tren.Renderer(scene, cfg, lights=lights, device=d,
                        asset_dir=paths["textures"],
                        sky_cubemap_path=paths["sky_cube"])
          for d in (cuda, "cpu")]
    for t in (0.0, 0.1):
        imgs = [r.render_np(t) for r in rs]
        assert np.isfinite(imgs[0]).all()
        diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
        assert (diff > 0.02).mean() <= 0.005, (t, (diff > 0.02).mean())
    rs[0].check_overflow()


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 2.5], ids=["zero", "soft"])
def test_compacted_frame_on_card(cuda, radius):
    """tests/test_torch_compaction.py's pitched frame on the card: the
    capacities below the tile grids, the compacted frame within 1e-5 of
    the dense one (both on the card) and within the frame bound of the
    CPU path's compacted frame, no overflow."""
    from crychic_renderer_tpu_torch.app import renderer as tren
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg, lights = sb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, width=512, height=192,
                              shadow_map_size=256, pcf_radius_texels=radius)
    imgs = []
    for d in (cuda, "cpu"):
        r = tren.Renderer(scene, cfg, lights=lights, device=d)
        r.camera.look_at((0.0, 4.0, -20.0), (0.0, 7.0, 0.0),
                         (0.0, 1.0, 0.0))
        r._autosize_capacity()
        assert r.cfg.shade_tile_capacity < 96
        assert r.cfg.ssao_tile_capacity < 96
        imgs.append(r.render(0.0))
        r.check_overflow()
        if d == cuda:
            dense = fr.render_frame(r.device_scene, r.frame_constants(0.0),
                                    dataclasses.replace(
                                        r.cfg, shade_tile_capacity=None,
                                        ssao_tile_capacity=None))
            assert float((imgs[0] - dense).abs().max()) <= 1e-5
    got, want = (np.clip(i.cpu().numpy(), 0.0, 1.0) for i in imgs)
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff > 0.02).mean() <= 0.005, (diff > 0.02).mean()


@pytest.mark.cuda
def test_render_queues_without_a_host_sync(cuda):
    """A config-4 frame at 480x270, rendered under
    torch.cuda.set_sync_debug_mode("error") after a warm-up frame, raises
    nothing and equals (torch.equal) the same frame rendered with the
    debug mode off."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    scene, cfg, lights = sb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, width=480, height=270)
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    want = r.render(0.1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = r.render(0.1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    r.check_overflow()
    assert torch.equal(got, want)


def _compiled(cuda, radius=None, width=480, height=270):
    """A config-4 Renderer on the card at width x height (with the soft
    disk for radius 2.5) whose first frame, at t = 0, captured its
    graph."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    scene, cfg, lights = sb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, width=width, height=height,
                              pcf_radius_texels=radius)
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    r.render(0.0)
    assert r.compiled_frame.graph is not None
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 2.5], ids=["zero", "soft"])
def test_replay_equals_eager_frame(cuda, radius):
    """The replayed frame (K1, K2 and, with the soft disk, K6 inside the
    graph) equals render_frame on the same constants: torch.equal, or,
    where two eager frames differ too, within 1e-5 with no pixel above
    0.02."""
    from crychic_renderer_tpu_torch.passes import frame as fr

    r = _compiled(cuda, radius)
    img = r.render(0.1)
    consts = r.frame_constants(0.1)
    eager = [fr.render_frame(r.device_scene, consts, r.cfg)
             for _ in range(2)]
    r.check_overflow()
    if not torch.equal(img, eager[0]):
        assert not torch.equal(eager[0], eager[1])
        diff = (img - eager[0]).abs().amax(dim=-1)
        assert float(diff.max()) <= 1e-5 and not bool((diff > 0.02).any())


@pytest.mark.cuda
def test_held_frame_survives_the_next_render(cuda):
    """render() returns a new tensor: a frame held across the next
    render() (another pose, so another image) is unchanged."""
    r = _compiled(cuda)
    held = r.render(0.0)
    want = held.clone()
    r.camera.look_at((0.0, 4.0, -20.0), (0.0, 7.0, 0.0), (0.0, 1.0, 0.0))
    other = r.render(0.0)
    torch.cuda.synchronize()
    assert torch.equal(held, want) and not torch.equal(held, other)


@pytest.mark.cuda
def test_replay_launch_tally(cuda):
    """The first render launches each kernel twice (the eager frame
    before the capture and the replay); every later render once, counted
    through the replay tally; close() frees the graph's pool."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb

    scene, cfg, lights = sb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, width=480, height=270,
                              pcf_radius_texels=2.5)
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    per_frame = {"raster.ids": 1, "raster.depth": 1, "pcf": 1,
                 "resolve": 1, "ssao.occlusion": 1,
                 "ssao.blur": r.cfg.ssao_blur_count, "light": 1}
    before = tally.snapshot()
    r.render(0.0)
    torch.cuda.synchronize()
    assert tally.since(before) == {k: 2 * n for k, n in per_frame.items()}
    assert r.compiled_frame.launches == per_frame
    before = tally.snapshot()
    for i in range(3):
        r.render(i / 60.0)
    torch.cuda.synchronize()
    assert tally.since(before) == {k: 3 * n for k, n in per_frame.items()}
    r.check_overflow()
    pool = r.compiled_frame.pool_bytes
    assert pool > 0
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    r.close()
    torch.cuda.empty_cache()
    assert held - torch.cuda.memory_reserved() >= pool


@pytest.mark.cuda
def test_host_read_inside_the_frame_makes_capture_raise(cuda):
    """A host read patched into render_frame (the eager frame allows it)
    makes the capture raise, and the next render raises again: nothing
    falls back to the eager frame. In a process of its own, since a
    failed capture leaves its stream state behind."""
    import os
    import subprocess
    import sys

    script = """
import dataclasses, torch
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.passes import frame as fr
real = fr.render_frame
def reading(scene, consts, cfg, stats=None):
    float(consts.view_proj[0, 0])  # a host read: waits for the stream
    return real(scene, consts, cfg, stats)
fr.render_frame = reading
scene, cfg, lights = sb.config4_shadow_pipeline()
r = Renderer(scene, dataclasses.replace(cfg, width=240, height=135),
             lights=lights, device="cuda")
for attempt in range(2):
    try:
        r.render(0.0)
    except RuntimeError as e:
        print("raised:", str(e).splitlines()[0])
    else:
        raise SystemExit("the capture did not raise")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", script], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    assert p.stdout.count("raised:") == 2, p.stdout


@pytest.mark.cuda
def test_k6_texture_outlives_a_cache_reset(cuda):
    """The compiled frame's K6 reads its own texture object: filling the
    eager path's 64-map cache (which destroys every cached object) leaves
    the replayed soft-disk frame as it was."""
    r = _compiled(cuda, 2.5)
    want = r.render(0.1)
    torch.cuda.synchronize()
    fills = pcf.cache_fills()
    rng = np.random.default_rng(5)
    params = torch.from_numpy(np.stack([
        rng.uniform(0, 64, 64), rng.uniform(0, 64, 64),
        rng.uniform(0, 65535, 64), np.ones(64), np.zeros(64),
        np.zeros(64)]).astype(np.float32)).to(cuda)
    maps = [pcf.quantize_map(torch.zeros((1, 64, 64), device=cuda))
            for _ in range(70)]
    for m in maps:
        pcf.soft_pcf(m, params, 2.5)
    torch.cuda.synchronize()
    assert pcf.cache_fills() > fills
    got = r.render(0.1)
    assert torch.equal(got, want)
    r.check_overflow()


def _band_runs(cuda, n, backend, runs):
    """launch.render_sharded of config 4 at 480x270 on n ranks, band
    capacities sized for n; `runs` maps a run to its (cfg changes,
    opts). 1 warm-up + 2 timed frames per run."""
    from crychic_renderer_tpu_torch.app.renderer import Renderer
    from crychic_renderer_tpu_torch.models import scenes_baseline as sb
    from crychic_renderer_tpu_torch.parallel import launch, sharded

    pcf.LIBRARY.load()  # built here once; the ranks load them
    raster.LIBRARY.load()
    scene, cfg, lights = sb.config4_shadow_pipeline()
    r = Renderer(scene, dataclasses.replace(cfg, width=480, height=270),
                 lights=lights, device=cuda)
    c = r.frame_constants(0.0)
    band = sharded.autosize_band_capacities(r.device_scene, c, r.cfg, n)
    return launch.render_sharded(
        [r.device_scene], [c],
        [(dataclasses.replace(band, **kw), 0, (0,), opts)
         for kw, opts in runs], n, backend,
        "cuda:0" if backend == "nccl" else cuda, warmup=1, timed=2,
        timeout=600)


@pytest.mark.cuda
def test_compiled_band_frame_gloo_replay_equals_eager(cuda):
    """2 gloo ranks sharing the card: the compiled band frame, captured in
    pieces (the gathers + 1 graphs), is torch.equal to the eager band
    frame on every rank, with the zero radius and the soft disk; per
    replay one K3 launch of each kind, one K7, K9's occlusion once and
    its blur three times, one K10 (and one K6 with the soft disk), and the
    eager frame before the capture adds one of each."""
    soft = dict(pcf_radius_texels=2.5)
    runs = [({}, {}), ({}, dict(compiled=False)), (soft, {}),
            (soft, dict(compiled=False))]
    for rank_runs in _band_runs(cuda, 2, "gloo", runs):
        for k in (0, 2):
            graph, eager = rank_runs[k], rank_runs[k + 1]
            assert np.array_equal(graph["img"], eager["img"])
            assert graph["graph"]["graphs"] == eager["gathers"] + 1
            per = {"raster.band_ids": 1, "raster.band_depth": 1,
                   "resolve": 1, "ssao.occlusion": 1, "ssao.blur": 3,
                   "light": 1}
            if k:
                per["pcf"] = 1
            assert graph["graph"]["launches"] == per
            n = graph["frames"] + 1
            assert graph["launches"]["band_ids"] == n
            assert graph["launches"]["pcf"] == (n if k else 0)
            assert not graph["overflowed"] and graph["cache_fills"] == 0


@pytest.mark.cuda
def test_compiled_band_frame_nccl_one_graph(cuda):
    """1 NCCL rank: the whole band frame, its all_gather_into_tensor
    collectives included, is one CUDA graph, torch.equal to the eager
    band frame, with the gathers counted per replay."""
    (graph, eager), = _band_runs(cuda, 1, "nccl",
                                 [({}, {}), ({}, dict(compiled=False))])
    assert graph["graph"]["graphs"] == 1
    assert np.array_equal(graph["img"], eager["img"])
    assert graph["gathers"] == eager["gathers"] > 0
    assert graph["gathered_bytes"] == eager["gathered_bytes"]


@pytest.mark.cuda
def test_host_read_in_band_frame_makes_capture_raise(cuda):
    """A host read patched into the band frame (the eager frame allows it)
    makes the compiled band frame's capture raise, and the next call
    raises again: nothing falls back to the eager frame. One gloo rank in
    a process of its own, since a failed capture leaves its stream state
    behind."""
    import os
    import subprocess
    import sys

    script = """
import dataclasses, os, tempfile, torch
import torch.distributed as dist
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.parallel import graphs, sharded
from crychic_renderer_tpu_torch.passes import frame as fr
real = fr.lighting_pass
def reading(scene, consts, *args, **kwargs):
    float(consts.view_proj[0, 0])  # a host read: waits for the stream
    return real(scene, consts, *args, **kwargs)
fr.lighting_pass = reading
store = os.path.join(tempfile.mkdtemp(), "store")
dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                        world_size=1)
scene, cfg, lights = sb.config4_shadow_pipeline()
r = Renderer(scene, dataclasses.replace(cfg, width=240, height=135),
             lights=lights, device="cuda")
c = r.frame_constants(0.0)
frame = graphs.CompiledBandFrame(sharded.render_frame_sharded,
                                 sharded.make_mesh(), "cuda")
for attempt in range(2):
    try:
        frame(r.device_scene, c, r.cfg)
    except RuntimeError as e:
        print("raised:", str(e).splitlines()[0])
    else:
        raise SystemExit("the capture did not raise")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", script], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr[-3000:]
    assert p.stdout.count("raised:") == 2, p.stdout
