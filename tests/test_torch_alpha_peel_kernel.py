"""The alpha layer's depth-peel kernel K8 (csrc/alpha_peel.cu,
ops/alpha_peel.py) against its plain version (passes/frame._alpha_peel,
through depth_peel_plain).

On the CPU (counted in the tier-1 run): _alpha_peel with one and with
three triangles a chunk equals its default chunking bit for bit on
triangles with depth ties, which pins the sequential earliest-triangle
rule K8's loop follows; depth_peel_plain's pixel centres are the ones
the stages used before; the alpha stages take the plain path for CPU
tensors and never reach the wrapper, which refuses CPU tensors; the
table K8 reads holds the set-up's values.

On the card (``cuda``; no tolerance, torch.equal on depth, ids and the
per-peel unresolved counts): the benchmark's fence cell
(c4fence-static-q3's scene, assets and reference pose) at 1920x1080,
its main view and its four 640^2 punch windows, on both pool layouts
(dual-mip rows and single-mip rows); a band with row_offset; a punch
window clamped at the map's far edge; seeded random triangles with depth
ties across what were chunk boundaries, zero-area and invalid slots,
fragments outside [0, 1] and a material outside the table, on both pool
layouts; and the compiled fence frame, whose replay launches K8
2 x alpha_peels times per view or window and equals the frame rendered
with the plain peel.

Imports torch, the port and the benchmark's scene builders only (the
card's machine has no jax). Run the card cases with ``python -m pytest
tests/test_torch_alpha_peel_kernel.py -m cuda --noconftest``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app.renderer import (Renderer,
                                                     synthetic_wire_fence)
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.ops import (alpha_peel, raster, sampling,
                                            tally)
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

CELL = "c4fence-static-q3"
CELL_SEED = 2 ** 31 + 21


def _random_scene(dual: bool, device) -> types.SimpleNamespace:
    """The fields of a DeviceScene the peel reads: a two-pair pool (the
    synthetic wire grid with holes, then a white pair) in either layout
    and a two-row material table."""
    white = [np.full((1, 1, 4), 255, np.uint8)]
    normal = [np.full((1, 1, 4), 128, np.uint8)]
    host = sampling.PairPool.build(
        [(sb.wire_fence_chain(3), normal), (white, normal)], 2, dual=dual)
    data = torch.from_numpy(host.data.view(np.int32).copy()).to(device)
    mat_pair = torch.tensor([0, 1], dtype=torch.int32, device=device)
    albedo = torch.tensor([[1, 1, 1, 1], [0.9, 0.8, 0.7, 0.6]],
                          dtype=torch.float32, device=device)
    return types.SimpleNamespace(
        pair_data=data, n_big_pairs=2, mat_pair=mat_pair, mat_albedo=albedo,
        pair_pool=sampling.PairPool(data, 2, dual=dual))


def _random_case(seed: int, T: int, W: int, H: int, device):
    """(tris, uv_tri, mat_tri) of T front-facing screen triangles over
    (and past) a W x H grid: ties (equal depth planes) spread over the
    table, zero-area and invalid slots, depths outside [0, 1], and
    materials 0 (the wire grid), 1 and 2 (outside the table)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-4, -4], [W + 4, H + 4], (T, 1, 2))
    xy = c + rng.normal(0, 0.25 * min(W, H), (T, 3, 2))
    a = xy[:, 1] - xy[:, 0]
    b = xy[:, 2] - xy[:, 0]
    back = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0] < 0
    xy[back] = xy[back][:, ::-1]
    z = rng.uniform(0.05, 0.95, (T, 1)) + rng.normal(0, 0.02, (T, 3))
    z[3] = [-0.2, 0.3, 0.5]  # crosses z = 0
    z[4] = [0.8, 1.3, 0.9]  # crosses z = 1
    # the two groups' first triangles in front, inside the grid, white
    xy[[1, 6]] = np.array([[[0.2, 0.2], [0.5, 0.25], [0.3, 0.6]],
                           [[0.55, 0.5], [0.9, 0.55], [0.7, 0.9]]]) * (W, H)
    z[[1, 6]] = [[0.02, 0.03, 0.025], [0.04, 0.05, 0.045]]
    for src, dsts in ((1, (2, 9, 17, 30)), (6, (7, 25))):
        z[list(dsts)] = z[src]  # the same depth plane: ties
        xy[list(dsts)] = xy[src]
    xy[5] = xy[5, :1]  # zero area
    xy = np.round(xy * 256) / 256
    valid = rng.random(T) > 0.1
    valid[[1, 2, 6, 7, 9]] = True
    tris = rz.ScreenTris(
        xy=torch.tensor(xy, dtype=torch.float32, device=device),
        z=torch.tensor(z, dtype=torch.float32, device=device),
        inv_w=torch.tensor(rng.uniform(0.2, 2.0, (T, 3)),
                           dtype=torch.float32, device=device),
        valid=torch.tensor(valid, device=device))
    # a third of a texture repeat per triangle: the wire grid's holes
    # survive the mip the peel samples
    uv = rng.uniform(-1, 2, (T, 1, 2)) + rng.uniform(0, 0.3, (T, 3, 2))
    mat = rng.choice(3, T, p=(0.6, 0.3, 0.1))
    mat[[1, 6]] = 1
    return (tris, torch.tensor(uv, dtype=torch.float32, device=device),
            torch.tensor(mat, dtype=torch.int32, device=device))


def _assert_peels_equal(got, want):
    (z, idx, n), (z0, idx0, n0) = got, want
    assert z.dtype == z0.dtype and idx.dtype == idx0.dtype
    assert torch.equal(idx, idx0), (
        f"{int((idx != idx0).sum())} of {idx.numel()} ids differ")
    assert torch.equal(z, z0), (
        f"{int((z != z0).sum())} of {z.numel()} depths differ")
    assert (n is None) == (n0 is None)
    assert n is None or torch.equal(n, n0), (n, n0)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_chunk", [1, 3])
def test_chunks_of_few_triangles_equal_the_default(per_chunk, monkeypatch):
    """_alpha_peel with `per_chunk` triangles a chunk equals the default
    chunking (every triangle in one chunk at this size) in depth, ids and
    unresolved counts: ties across chunk boundaries go to the earliest
    triangle, the rule K8's sequential loop keeps."""
    H, W, T = 64, 96, 40
    scene = _random_scene(True, "cpu")
    tris, uv, mat = _random_case(7, T, W, H, "cpu")
    assert fr.PEEL_CHUNK_ELEMS // (H * W) >= T
    want = fr.depth_peel_plain(scene, tris, uv, mat, H, W, 0, 0, 3, 0.1,
                               counted=True)
    monkeypatch.setattr(fr, "PEEL_CHUNK_ELEMS", per_chunk * H * W)
    got = fr.depth_peel_plain(scene, tris, uv, mat, H, W, 0, 0, 3, 0.1,
                              counted=True)
    _assert_peels_equal(got, want)
    idx = want[1]
    # the tie groups' earliest triangles win, their copies never do
    for copy in (2, 9, 17, 30, 7, 25):
        assert not bool((idx == copy).any()), copy
    assert bool((idx == 1).any()) and bool((idx == 6).any())
    # clips and later peels are exercised
    assert int(want[2][0]) > 0 and bool((idx >= 0).any())


@pytest.fixture(scope="module")
def small_fence():
    """fence_scene at 96x64 on the CPU with the synthetic wire grid, 3
    peels and a 64^2 punch window on 128^2 maps."""
    scene, cfg, lights = sb.fence_scene(alpha_test=True)
    cfg = dataclasses.replace(cfg, width=96, height=64, shadow_map_size=128,
                              alpha_shadow_window=64, alpha_peels=3)
    with synthetic_wire_fence():
        return Renderer(scene, cfg, lights=lights, device="cpu")


def test_stages_take_the_plain_path_on_the_cpu(small_fence, monkeypatch):
    """On CPU tensors both alpha stages peel with the plain version (the
    wrapper is never called), at the pixel centres the stages used
    before: arange + 0.5 in the main view, (origin + ramp) + 0.5 in a
    punch window."""
    r = small_fence
    s, cfg = r.device_scene, r.cfg
    consts = r.frame_constants(0.0)

    def refuse(*args, **kw):
        raise AssertionError("the CPU reached the K8 wrapper")

    monkeypatch.setattr(alpha_peel, "peel", refuse)
    before = tally.snapshot()
    tris, attr = fr.main_view_tris(s, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    occ = {}
    fr.alpha_merge_main(s, consts, cfg, depth, tid, tris, attr,
                        occupancy=occ)
    maps = fr.render_shadow_maps(s, consts, cfg)
    fr.alpha_merge_shadow(s, consts, cfg, maps)
    assert "alpha_peel" not in tally.since(before)

    a_tris, a_attr = fr.alpha_view_tris(s, consts, cfg)
    H, W = depth.shape
    y0 = 5
    unresolved = []
    want = fr._alpha_peel(
        a_tris, a_attr[:, :, 13:15], a_attr[:, 0, 15], s,
        (torch.arange(W, dtype=torch.float32) + 0.5)[None, :],
        (float(y0) + torch.arange(H - y0, dtype=torch.float32)
         + 0.5)[:, None], cfg.alpha_peels, cfg.alpha_clip, unresolved)
    got = fr.depth_peel(s, a_tris, a_attr[:, :, 13:15], a_attr[:, 0, 15],
                        H - y0, W, y0, 0, cfg.alpha_peels, cfg.alpha_clip,
                        counted=True)
    _assert_peels_equal(got, want + (torch.stack(unresolved),))
    assert bool((got[1] >= 0).any())
    assert occ["alpha_unresolved"].shape == (cfg.alpha_peels,)

    tw, uv, mat = fr.alpha_shadow_geom(s, consts)
    t = fr._alpha_light_tris(cfg, tw, consts.cascade_view_projs[0])
    az, aid, oy, ox = fr._punch_window(s, cfg, t, uv, mat)
    Wn = fr.alpha_window(cfg)
    ramp = torch.arange(Wn, dtype=torch.float32)
    want = fr._alpha_peel(t, uv, mat, s,
                          (ox.to(torch.float32) + ramp + 0.5)[None, :],
                          (oy.to(torch.float32) + ramp + 0.5)[:, None],
                          cfg.alpha_peels, cfg.alpha_clip)
    _assert_peels_equal((az, aid, None), want + (None,))
    assert bool((aid >= 0).any())


def test_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; the CPU takes the plain version."""
    scene = _random_scene(True, "cpu")
    tris, uv, mat = _random_case(8, 40, 32, 16, "cpu")
    table = alpha_peel.peel_table(fr._peel_setup(tris, uv, mat), tris.valid)
    with pytest.raises(ValueError, match="_alpha_peel"):
        alpha_peel.peel(table, 16, 32, 0, 0, scene.pair_data, 2,
                        scene.mat_albedo, scene.mat_pair, 2, 0.1)


def test_k8_table():
    """The table K8 reads: the set-up's coefficients, depth plane, flags
    and record in that order, 32 floats (128 bytes) a row."""
    tris, uv, mat = _random_case(9, 40, 32, 16, "cpu")
    setup = A, B, C, tl, zA, zB, zC, rec = fr._peel_setup(tris, uv, mat)
    table = alpha_peel.peel_table(setup, tris.valid)
    assert table.shape == (40, alpha_peel.TABLE_FLOATS)
    assert table.is_contiguous() and table.dtype == torch.float32
    for lo, want in ((0, A), (3, B), (6, C), (12, tl.float())):
        assert torch.equal(table[:, lo:lo + 3], want)
    for col, want in ((9, zA), (10, zB), (11, zC), (15, tris.valid.float())):
        assert torch.equal(table[:, col], want)
    assert torch.equal(table[:, alpha_peel.COEFS:], rec)
    assert rec.shape == (40, 16) and torch.equal(rec[:, 15], mat.float())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cell(cuda, tmp_path_factory):
    """The fence cell's configuration, full asset set and reference
    pose: (Renderer on the dual-mip pool, the same on single-mip rows)."""
    from benchmark.harness import sides, spec
    from benchmark.harness import traffic as traffic_mod
    from benchmark.scenes import synthetic_assets as sa

    bench = spec.benchmark()
    workload = spec.workload(bench, CELL)
    config = spec.config(bench, workload["config"])
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.FULL, seed=CELL_SEED)
    port = sides.program()
    tr = traffic_mod.from_spec(spec.traffic(workload["traffic"]), CELL_SEED)
    out = []
    for dual in (True, False):
        scene, cfg, lights = sides.build(port, config, paths["models"])
        cfg = dataclasses.replace(cfg, dual_mip_rows=dual)
        cam = traffic_mod.camera(port.Camera, tr, tr.pose(0),
                                 cfg.width / cfg.height)
        r = Renderer(scene, cfg, camera=cam, lights=lights,
                     asset_dir=paths["textures"],
                     sky_cubemap_path=paths["sky_cube"], device=cuda)
        r.ensure_capacity(0.0)
        out.append(r)
    assert out[0].cfg.alpha_peels == 3 and out[0].cfg.width == 1920
    return out


def _both(fn):
    """(fn() with K8, fn() with the plain peel), on the card."""
    got = fn()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fr, "depth_peel", fr.depth_peel_plain)
        want = fn()
    return got, want


def _main_inputs(r, t=0.0):
    consts = r.frame_constants(t)
    tris, attr = fr.main_view_tris(r.device_scene, consts, r.cfg)
    depth, tid, _ = raster.rasterize(tris, r.cfg.width, r.cfg.height,
                                     r.cfg.pair_capacity)
    return consts, tris, attr, depth, tid


def _assert_merge_equal(got, want):
    (out, occ), (out0, occ0) = got, want
    for a, b, name in zip(out, out0, ("depth", "tid", "tris", "attr")):
        if isinstance(a, rz.ScreenTris):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), (
                f"{name}: {int((a != b).sum())} of {a.numel()} differ")
    assert torch.equal(occ["alpha_unresolved"], occ0["alpha_unresolved"]), \
        (occ["alpha_unresolved"], occ0["alpha_unresolved"])


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["dual", "single"])
def test_fence_main_view(cell, pool):
    """alpha_merge_main at 1920x1080: the merged depth and ids, the
    appended tables and the per-peel unresolved counts."""
    r = cell[0 if pool == "dual" else 1]
    assert r.device_scene.pair_data.shape[1] == (16 if pool == "dual"
                                                 else 8)
    consts, tris, attr, depth, tid = _main_inputs(r)

    def run():
        occ = {}
        out = fr.alpha_merge_main(r.device_scene, consts, r.cfg, depth, tid,
                                  tris, attr, occupancy=occ)
        return out, occ

    got, want = _both(run)
    _assert_merge_equal(got, want)
    n = got[1]["alpha_unresolved"]
    assert int(n[0]) > 0 and int((got[0][1] >= tris.xy.shape[0]).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["dual", "single"])
def test_fence_punch_windows(cell, pool):
    """The four cascades' 640^2 punch windows, and the punched maps."""
    r = cell[0 if pool == "dual" else 1]
    s, cfg = r.device_scene, r.cfg
    consts = r.frame_constants(0.0)
    assert fr.alpha_window(cfg) == 640 and cfg.num_cascades == 4
    tw, uv, mat = fr.alpha_shadow_geom(s, consts)
    for c in range(cfg.num_cascades):
        got, want = _both(lambda: fr.alpha_punch_window(
            s, cfg, tw, uv, mat, consts.cascade_view_projs[c]))
        _assert_peels_equal(got[:2] + (None,), want[:2] + (None,))
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        assert bool((got[1] >= 0).any()), c
    maps = fr.render_shadow_maps(s, consts, cfg)
    got, want = _both(lambda: fr.alpha_merge_shadow(s, consts, cfg, maps))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_band_with_row_offset(cell):
    """A band of rows 400..669 peeled at global rows (row_offset 400)."""
    r = cell[0]
    consts, tris, attr, depth, tid = _main_inputs(r)
    y0, rows = 400, 270

    def run():
        occ = {}
        out = fr.alpha_merge_main(r.device_scene, consts, r.cfg,
                                  depth[y0:y0 + rows], tid[y0:y0 + rows],
                                  tris, attr, row_offset=y0, occupancy=occ)
        return out, occ

    got, want = _both(run)
    _assert_merge_equal(got, want)
    # the band is the full frame's rows
    full = fr.alpha_merge_main(r.device_scene, consts, r.cfg, depth, tid,
                               tris, attr)
    assert torch.equal(got[0][0], full[0][y0:y0 + rows])
    assert torch.equal(got[0][1], full[1][y0:y0 + rows])


@pytest.mark.cuda
def test_window_clamped_at_the_far_edge(cell):
    """Cascade 0's alpha triangles moved so their box starts half a
    window short of the map's far corner: the window's origin clamps to
    S - Wn on both axes and the layer runs past the map."""
    r = cell[0]
    s, cfg = r.device_scene, r.cfg
    consts = r.frame_constants(0.0)
    S, Wn = cfg.shadow_map_size, fr.alpha_window(cfg)
    tw, uv, mat = fr.alpha_shadow_geom(s, consts)
    t = fr._alpha_light_tris(cfg, tw, consts.cascade_view_projs[0])
    lo = fr._alpha_light_corner(t)
    shift = torch.floor(float(S - Wn // 2) - lo)
    t = t._replace(xy=t.xy + shift)
    got, want = _both(lambda: fr._punch_window(s, cfg, t, uv, mat))
    assert int(got[2]) == int(got[3]) == S - Wn
    _assert_peels_equal(got[:2] + (None,), want[:2] + (None,))
    assert bool((got[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["dual", "single"])
@pytest.mark.parametrize("peels", [1, 3])
def test_random_triangles(cuda, pool, peels):
    """Seeded random triangles on a 300x200 grid at origin (7, 13), the
    column origin a device tensor, with the cases the plain version's
    chunks met at their boundaries."""
    scene = _random_scene(pool == "dual", cuda)
    H, W = 200, 300
    tris, uv, mat = _random_case(11, 48, W, H, cuda)
    ox = torch.tensor(13, dtype=torch.int64, device=cuda)
    tris = tris._replace(xy=tris.xy + torch.tensor([13.0, 7.0],
                                                   device=cuda))

    def run():
        return fr.depth_peel(scene, tris, uv, mat, H, W, 7, ox, peels, 0.1,
                             counted=True)

    got, want = _both(run)
    _assert_peels_equal(got, want)
    idx = got[1]
    assert bool((idx >= 0).any()) and int(got[2][0]) > 0
    for copy in (2, 9, 17, 30, 7, 25):
        assert not bool((idx == copy).any()), copy


@pytest.mark.cuda
def test_compiled_frame_goes_through_k8(cell):
    """The fence frame's replay launches K8 2 x alpha_peels times for the
    main view and for each cascade's window, and equals the frame
    rendered eagerly with the plain peel."""
    r = cell[0]
    r.render(0.0)
    before = tally.snapshot()
    img = r.render(0.0)
    torch.cuda.synchronize()
    want_launches = 2 * r.cfg.alpha_peels * (1 + r.cfg.num_cascades)
    assert r.compiled_frame.launches["alpha_peel"] == want_launches
    assert tally.since(before)["alpha_peel"] == want_launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fr, "depth_peel", fr.depth_peel_plain)
        want = fr.render_frame(r.device_scene, r.frame_constants(0.0), r.cfg)
    assert torch.equal(img, want)
    r.close()
