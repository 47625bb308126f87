"""The G-buffer resolve kernel K7 (csrc/resolve.cu, ops/resolve.py)
against its plain version (passes/frame.resolve_gbuffer_plain).

On the CPU (counted in the tier-1 run): resolve_gbuffer takes the plain
version for CPU tensors, and its compacted, dense and band G-buffers
equal _resolve_core's dense one; the padded record table K7 reads holds
_build_resolve_records' values; the sampler mode follows the config; the
wrapper refuses CPU tensors.

On the card (``cuda``; no tolerance, torch.equal on every plane): config
4 at 1920x1080 at the reference pose; config 5 from the full synthetic
asset set at the reference pose and two headings of the benchmark's
turn-q3 path; every sampler mode (trilinear, the probe schedule with 2
and 4 probes, the reference-quality probes) on both pool layouts
(dual-mip rows and single-mip rows); an undersized shade-tile capacity
(the tiles past it take the clear values and the overflow flag is set);
the dense resolve and a band with row_offset and out_rows; and the
compiled frame, whose replay launches K7 once and equals the frame
rendered with the plain resolve.

Imports torch and the port only (the card's machine has no jax). Run the
card cases with ``python -m pytest tests/test_torch_resolve_kernel.py -m
cuda --noconftest``.
"""
import dataclasses
import math

import pytest
import torch

from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.models.camera import Camera
from crychic_renderer_tpu_torch.ops import raster, resolve, tally
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

PLANES = tuple(fr._G_CLEAR) + ("valid",)
# benchmark/traffic/turn-q3.json: the position and the turn per frame
TURN_POSITION = (0.0, 2.0, -15.0)
TURN_DEG = 2.8125
TURN_FRAMES = (37, 101)


def _mismatches(got: dict, want: dict) -> list:
    """One line per plane that is not torch.equal: the elements that
    differ and the largest difference."""
    out = []
    for name in PLANES:
        a, b = got[name], want[name]
        if a.shape != b.shape:
            out.append(f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        elif not torch.equal(a, b):
            diff = (a.float() - b.float()).abs()
            out.append(f"{name}: {int((a != b).sum())} of {a.numel()} differ,"
                       f" max |diff| {float(diff.max()):.3g}")
    return out


def _inputs(r: Renderer, t: float = 0.0):
    """The main view's constants, triangles, attributes and raster."""
    consts = r.frame_constants(t)
    tris, attr = fr.main_view_tris(r.device_scene, consts, r.cfg)
    depth, tid, _ = raster.rasterize(tris, r.cfg.width, r.cfg.height,
                                     r.cfg.pair_capacity)
    return consts, tris, attr, depth, tid


def _both(r, cfg, inputs, **kw):
    """(K7's, the plain version's) (G-buffer, stats, occupancy) on the same
    inputs (the first is the CPU's plain version on CPU tensors)."""
    consts, tris, attr, depth, tid = inputs
    runs = []
    for fn in (fr.resolve_gbuffer, fr.resolve_gbuffer_plain):
        stats, occ = {}, {}
        g = fn(r.device_scene, consts, cfg, tris, depth, tid, attr,
               stats=stats, occupancy=occ, **kw)
        runs.append((g, stats, occ))
    return runs


def _assert_same(runs):
    (g, stats, occ), (g0, stats0, occ0) = runs
    bad = _mismatches(g, g0)
    assert not bad, "; ".join(bad)
    assert stats.keys() == stats0.keys() and occ.keys() == occ0.keys()
    for k in stats:
        assert torch.equal(stats[k], stats0[k]), k
    for k in occ:
        assert torch.equal(occ[k], occ0[k]), k


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small4():
    """Config 4 at 256x144 on the CPU, capacities sized at its pose."""
    scene, cfg, lights = sb.CONFIGS[4]()
    r = Renderer(scene, dataclasses.replace(cfg, width=256, height=144,
                                            shadow_map_size=128),
                 lights=lights, device="cpu")
    return r, _inputs(r)


def _core_dense(r, inputs):
    """_resolve_core's dense G-buffer at every pixel."""
    consts, tris, attr, depth, tid = inputs
    H, W = tid.shape
    px = (torch.arange(W, dtype=torch.float32) + 0.5)[None, :].expand(H, W)
    py = (torch.arange(H, dtype=torch.float32) + 0.5)[:, None].expand(H, W)
    return fr._resolve_core(r.device_scene, consts, r.cfg,
                            fr._build_resolve_records(tris, attr), tid, px,
                            py)


@pytest.mark.parametrize("case", ["compacted", "dense", "band"])
def test_cpu_takes_the_plain_version(small4, case):
    """On CPU tensors resolve_gbuffer is the plain version, and its
    G-buffer equals _resolve_core's dense one plane for plane."""
    r, inputs = small4
    assert r.cfg.shade_tile_capacity
    want = _core_dense(r, inputs)
    consts, tris, attr, depth, tid = inputs
    cfg = (r.cfg if case == "compacted" else
           dataclasses.replace(r.cfg, shade_tile_capacity=None))
    if case == "band":
        y0, rows = 48, 40
        g = fr.resolve_gbuffer(r.device_scene, consts, cfg, tris,
                               depth[y0:y0 + rows + 1],
                               tid[y0:y0 + rows + 1], attr, row_offset=y0,
                               out_rows=rows)
        want = {k: v[y0:y0 + rows] for k, v in want.items()}
    else:
        (g, stats, occ), _ = _both(r, cfg, inputs)
        if case == "compacted":
            assert not bool(stats["shade_tiles_overflowed"])
            assert 0 < int(occ["shade_tiles"]) <= cfg.shade_tile_capacity
    bad = _mismatches(g, want)
    assert not bad, "; ".join(bad)
    assert bool(want["valid"].any()) and not bool(want["valid"].all())


def test_k7_record_table(small4):
    """The padded table K7 reads: _build_resolve_records' 43 values in
    each row, then zeros, in 16-byte rows."""
    r, (consts, tris, attr, depth, tid) = small4
    rec = fr._build_resolve_records(tris, attr)
    padded = fr._build_resolve_records(tris, attr, resolve.RECORD_FLOATS)
    assert rec.shape == (tris.xy.shape[0], 43)
    assert padded.shape == (rec.shape[0], resolve.RECORD_FLOATS)
    assert padded.is_contiguous() and padded.stride(0) * 4 % 16 == 0
    assert torch.equal(padded[:, :43], rec)
    assert not bool(padded[:, 43:].any())


@pytest.mark.parametrize("anisotropy,probes,mode", [
    (8, 2, resolve.ANISO), (8, 4, resolve.ANISO), (16, 1, resolve.ANISO),
    (8, 0, resolve.ANISO_REF), (1, 2, resolve.TRILINEAR),
    (1, 0, resolve.TRILINEAR)])
def test_sampler_mode(anisotropy, probes, mode):
    """_resolve_core's branch: trilinear at anisotropy 1, the probe
    schedule above it, the reference-quality probes at 0 probes."""
    assert resolve.sampler_mode(anisotropy, probes) == mode


def test_kernel_refuses_cpu_tensors(small4):
    """The wrapper launches or raises; the CPU takes the plain version."""
    r, (consts, tris, attr, depth, tid) = small4
    s = r.device_scene
    rec = fr._build_resolve_records(tris, attr, resolve.RECORD_FLOATS)
    with pytest.raises(ValueError, match="resolve_gbuffer_plain"):
        resolve.resolve(rec, tid, tid.shape[0], 0, None, 0, s.pair_data,
                        s.n_big_pairs, s.mat_albedo, s.mat_roughness,
                        s.mat_metalness, s.mat_pair, consts.view, 8, 2)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c4(cuda):
    scene, cfg, lights = sb.CONFIGS[4]()
    return Renderer(scene, cfg, lights=lights, device=cuda)


@pytest.fixture(scope="module")
def assets(cuda, tmp_path_factory):
    """The full synthetic asset set; config 5's scene reads its models."""
    from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa

    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.FULL, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "REF_MODELS", paths["models"])
        yield dict(asset_dir=paths["textures"],
                   sky_cubemap_path=paths["sky_cube"])


def _config5(cuda, assets, **cfg_kw):
    scene, cfg, lights = sb.CONFIGS[5]()
    return Renderer(scene, dataclasses.replace(cfg, **cfg_kw),
                    lights=lights, device=cuda, **assets)


@pytest.fixture(scope="module")
def c5(cuda, assets):
    return _config5(cuda, assets)


@pytest.fixture(scope="module")
def c5_single(cuda, assets):
    """Config 5 on the single-mip pool (8-lane rows)."""
    return _config5(cuda, assets, dual_mip_rows=False)


@pytest.mark.cuda
def test_config4_reference_pose(c4):
    r = c4
    assert r.cfg.shade_tile_capacity
    _assert_same(_both(r, r.cfg, _inputs(r)))


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (None,) + TURN_FRAMES)
def test_config5_poses(c5, frame):
    """The reference pose and two headings of turn-q3, capacities grown
    where the heading needs it."""
    r = c5
    if frame is not None:
        cam = Camera()
        cam.set_lens(0.25 * math.pi, r.cfg.width / r.cfg.height, 1.0, 100.0)
        cam.set_position(*TURN_POSITION)
        cam.rotate_y(math.radians(frame * TURN_DEG))
        r.camera = cam
        r.ensure_capacity(frame / 60.0)
    t = 0.0 if frame is None else frame / 60.0
    _assert_same(_both(r, r.cfg, _inputs(r, t)))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["dual", "single"])
@pytest.mark.parametrize("anisotropy,probes", [(1, 2), (8, 2), (8, 4),
                                               (8, 0)])
def test_sampler_modes(c5, c5_single, pool, anisotropy, probes):
    """Every sampler mode on both pool layouts, config 5's textures at
    the reference pose."""
    r = _reference_pose(c5 if pool == "dual" else c5_single)
    assert r.device_scene.pair_data.shape[1] == (16 if pool == "dual"
                                                 else 8)
    cfg = dataclasses.replace(r.cfg, anisotropy=anisotropy,
                              aniso_probes=probes)
    _assert_same(_both(r, cfg, _inputs(r)))


def _reference_pose(r):
    """r with the Renderer's default camera (the reference pose)."""
    r.camera = r._default_camera()
    return r


@pytest.mark.cuda
def test_undersized_capacity(c5):
    """Half the tiles the frame needs: the tiles past the capacity take
    the clear values in both, and both flag the overflow."""
    r = _reference_pose(c5)
    inputs = consts, tris, attr, depth, tid = _inputs(r)
    occ = {}
    fr.resolve_gbuffer(r.device_scene, consts, r.cfg, tris, depth, tid, attr,
                       occupancy=occ)
    cfg = dataclasses.replace(r.cfg,
                              shade_tile_capacity=int(occ["shade_tiles"]) // 2)
    runs = _both(r, cfg, inputs)
    _assert_same(runs)
    g, stats, _ = runs[0]
    assert bool(stats["shade_tiles_overflowed"])
    dropped = g["valid"] & (g["normal_v"][..., 2] == 1.0) & (
        g["pos_w"] == 0).all(dim=-1)
    assert bool(dropped.any())


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
def test_dense_and_band(c5, band):
    """The dense resolve (every tile kept), and a band of rows 270..539
    with its halo row, at row_offset 270 with out_rows 270."""
    r = _reference_pose(c5)
    consts, tris, attr, depth, tid = _inputs(r)
    cfg = dataclasses.replace(r.cfg, shade_tile_capacity=None)
    kw = {}
    if band:
        y0, rows = 270, 270
        depth, tid = depth[y0:y0 + rows + 1], tid[y0:y0 + rows + 1]
        kw = dict(row_offset=y0, out_rows=rows)
    runs = _both(r, cfg, (consts, tris, attr, depth, tid), **kw)
    _assert_same(runs)
    assert runs[0][0]["pos_w"].shape[0] == (270 if band else cfg.height)


@pytest.mark.cuda
def test_compiled_frame_goes_through_k7(cuda, monkeypatch):
    """Config 4 at 1080p: the replay launches K7 once and equals the
    frame rendered eagerly with the plain resolve (and the plain light
    stage: K10 reads only K7's buffer, and equals the plain stage)."""
    scene, cfg, lights = sb.CONFIGS[4]()
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    r.render(0.0)
    before = tally.snapshot()
    img = r.render(0.0)
    torch.cuda.synchronize()
    assert r.compiled_frame.launches["resolve"] == 1
    assert tally.since(before)["resolve"] == 1
    monkeypatch.setattr(fr, "resolve_gbuffer", fr.resolve_gbuffer_plain)
    monkeypatch.setattr(fr, "direct_light", fr.direct_light_plain)
    want = fr.render_frame(r.device_scene, r.frame_constants(0.0), r.cfg)
    assert torch.equal(img, want)
    r.close()
