"""The SSAO kernel K9 (csrc/ssao.cu, ops/ssao_kernel.py) against its plain
version (passes/frame.ssao_pass_plain, ssao_blur_plain).

On the CPU (counted in the tier-1 run): ssao_pass and ssao_blur take the
plain version for CPU tensors, and the compacted access map is within
1e-5 of the dense one (the JAX package's bound for its compaction); the
plain blur's edge rules (access map and normals clamped to the edge, a
depth tap past the edge reading the far plane) equal a pixel-by-pixel
reading of SsaoBlur.hlsl; the wrappers refuse CPU tensors and malformed
inputs, and hand each C entry one argument per declared type.

On the card (``cuda``; no tolerance, torch.equal): config 4 and config 5
at 1920x1080 at the reference pose and two headings of the benchmark's
turn-q3 path; an undersized SSAO tile capacity (the tiles past it read
1.0 and the overflow flag is set); the dense occlusion, and a band of
rows at a row offset; the blur alone on a random access map over the
whole screen and over a window whose sides are no multiple of the
block's; and the compiled frame, whose replay launches the occlusion
once and the blur three times and equals the frame rendered with the
plain stage.

Imports torch and the port only (the card's machine has no jax). Run the
card cases with ``python -m pytest tests/test_torch_ssao_kernel.py -m
cuda --noconftest``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.models.camera import Camera
from crychic_renderer_tpu_torch.ops import raster, ssao_kernel, tally
from crychic_renderer_tpu_torch.ops import ssao as ssao_ops
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

# benchmark/traffic/turn-q3.json: the position and the turn per frame
TURN_POSITION = (0.0, 2.0, -15.0)
TURN_DEG = 2.8125
TURN_FRAMES = (37, 101)


def _inputs(r: Renderer, t: float = 0.0):
    """(consts, the G-buffer's view-space normals, the main depth, the
    coverage) of r's frame at time t."""
    consts = r.frame_constants(t)
    cfg = r.cfg
    tris, attr = fr.main_view_tris(r.device_scene, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(r.device_scene, consts, cfg, tris, depth, tid,
                           attr)
    return consts, g["normal_v"], depth, tid >= 0


def _both(r, cfg, inputs):
    """(ssao_pass's, ssao_pass_plain's) (access, stats, occupancy) on the
    same inputs."""
    consts, normal_v, depth, valid = inputs
    runs = []
    for fn in (fr.ssao_pass, fr.ssao_pass_plain):
        stats, occ = {}, {}
        access = fn(r.device_scene, consts, cfg, normal_v, depth,
                    valid=valid, stats=stats, occupancy=occ)
        runs.append((access, stats, occ))
    return runs


def _assert_equal(a, b, what="access"):
    assert a.shape == b.shape, (what, tuple(a.shape), tuple(b.shape))
    if not torch.equal(a, b):
        diff = (a - b).abs()
        pytest.fail(f"{what}: {int((a != b).sum())} of {a.numel()} differ, "
                    f"max |diff| {float(diff.max()):.3g}")


def _assert_same(runs):
    (a, stats, occ), (a0, stats0, occ0) = runs
    _assert_equal(a, a0)
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
    """Config 4 at 256x144 on the CPU, capacities sized at its pose, and
    its SSAO inputs."""
    scene, cfg, lights = sb.CONFIGS[4]()
    r = Renderer(scene, dataclasses.replace(cfg, width=256, height=144,
                                            shadow_map_size=128),
                 lights=lights, device="cpu")
    return r, _inputs(r)


def test_cpu_takes_the_plain_version(small4):
    """On CPU tensors ssao_pass is the plain version; its compacted map is
    within 1e-5 of the dense one, without overflow."""
    r, inputs = small4
    assert r.cfg.ssao_tile_capacity
    runs = _both(r, r.cfg, inputs)
    _assert_same(runs)
    compacted, stats, occ = runs[0]
    assert not bool(stats["ssao_tiles_overflowed"])
    assert 0 < int(occ["ssao_tiles"]) <= r.cfg.ssao_tile_capacity
    dense_cfg = dataclasses.replace(r.cfg, ssao_tile_capacity=None)
    dense, stats, occ = _both(r, dense_cfg, inputs)[0]
    assert stats == {} and occ == {}
    assert compacted.shape == (r.cfg.ssao_height, r.cfg.ssao_width)
    assert float((compacted - dense).abs().max()) <= 1e-5


def _blur_maps(h, w, A, B, seed):
    """A random access map; normals with some turned away (the normal
    stop rejects them); NDC depth whose view depth is 10 plus noise below
    the depth stop, one step above it, and the far plane (NDC 1, the
    border's view depth) over the top right corner, where taps past the
    edge pass and read the clamped access map and normals."""
    g = np.random.default_rng(seed)
    access = g.random((h, w), dtype=np.float32)
    n = g.normal(size=(h, w, 3)).astype(np.float32) * 0.2
    n[..., 2] += 1.0
    n[g.random((h, w)) < 0.15] *= -1.0
    z = 10.0 + 0.15 * g.random((h, w))
    z[:, w // 3:] += 1.0
    d = (A + B / z).astype(np.float32)
    d[:h // 2, 2 * w // 3:] = 1.0
    return access, n, d


def _blur_by_pixel(access, n, d_view, w, border):
    """One iteration of SsaoBlur.hlsl's two passes, pixel by pixel in
    float64: the access map and the normals clamp to the edge, a depth
    tap past it reads border."""
    def one_pass(a, axis):
        h, wd = a.shape
        out = np.empty(a.shape)
        for y in range(h):
            for x in range(wd):
                acc, total = w[5] * a[y, x], w[5]
                for i in range(-5, 6):
                    if i == 0:
                        continue
                    yy, xx = (y, x + i) if axis == 1 else (y + i, x)
                    off = not (0 <= yy < h and 0 <= xx < wd)
                    cy, cx = min(max(yy, 0), h - 1), min(max(xx, 0), wd - 1)
                    dn = border if off else d_view[cy, cx]
                    ok = (np.dot(n[cy, cx], n[y, x]) >= 0.8
                          and abs(dn - d_view[y, x]) <= 0.2)
                    acc += w[i + 5] * ok * a[cy, cx]
                    total += w[i + 5] * ok
                out[y, x] = acc / total
        return out

    return one_pass(one_pass(access.astype(np.float64), 1), 0)


@pytest.mark.parametrize("shape", [(9, 14), (17, 6)])
def test_blur_edge_rules(small4, shape):
    """ssao_blur on the CPU (the plain version, one iteration) equals the
    pixel-by-pixel blur on a small map, at every edge."""
    r, (consts, _, _, _) = small4
    A, B = float(consts.proj[2, 2]), float(consts.proj[3, 2])
    access, n, d = _blur_maps(*shape, A, B, seed=sum(shape))
    d_view = B / (d.astype(np.float64) - A)
    w = r.device_scene.ssao_blur_weights
    want = _blur_by_pixel(access, n.astype(np.float64), d_view,
                          w.double().numpy(), B / (1.0 - A))
    cfg = dataclasses.replace(r.cfg, ssao_blur_count=1)
    args = (r.device_scene, consts, cfg, torch.from_numpy(access),
            torch.from_numpy(n), torch.from_numpy(d))
    got = fr.ssao_blur(*args)
    assert torch.equal(got, fr.ssao_blur_plain(*args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    # the stops did reject taps: an unweighted mean would differ
    assert not np.allclose(want, _blur_by_pixel(
        access, np.ones_like(n, np.float64), np.zeros_like(d_view),
        w.double().numpy(), 0.0), atol=1e-3)


def _kernel_args(r, inputs):
    """Well-formed (occlusion kwargs, blur kwargs) from CPU inputs."""
    consts, normal_v, depth, valid = inputs
    s, cfg = r.device_scene, r.cfg
    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    _, inv, _, _ = fr._compact(fr._ssao_occupied(cfg, *d_half.shape, valid),
                               cfg.ssao_tile_capacity)
    occ = dict(normal_v=n_half, depth_ndc=d_half, proj=consts.proj,
               inv_proj=consts.inv_proj, offsets=s.ssao_offsets,
               random_field=s.ssao_random_field, tap_depth=depth, inv=inv,
               capacity=cfg.ssao_tile_capacity)
    blur = dict(access=torch.rand(d_half.shape), normal_v=n_half,
                depth_ndc=d_half, weights=s.ssao_blur_weights,
                proj=consts.proj)
    return occ, blur


def test_wrappers_refuse_cpu_tensors(small4):
    """The wrappers launch or raise; the CPU takes the plain version."""
    occ, blur = _kernel_args(*small4)
    with pytest.raises(ValueError, match="ssao_pass_plain"):
        ssao_kernel.occlusion(**occ)
    with pytest.raises(ValueError, match="ssao_pass_plain"):
        ssao_kernel.blur(**blur)


@pytest.fixture
def launches(monkeypatch):
    """The wrappers with their device check passing CPU tensors and the
    library's launch recording (entry, args, key) instead of launching."""
    calls = []
    monkeypatch.setattr(ssao_kernel, "_device", lambda t: t.device)
    monkeypatch.setattr(
        ssao_kernel.LIBRARY, "launch",
        lambda entry, dev, *args, key: calls.append((entry, args, key)))
    return calls


def test_wrappers_match_the_entries(small4, launches):
    """A well-formed call hands its C entry one argument per declared
    type (the stream last) and counts under its own key; the occlusion's
    strides are the normals' view of the G-buffer, in floats."""
    occ, blur = _kernel_args(*small4)
    out = ssao_kernel.occlusion(**occ)
    assert out.shape == occ["depth_ndc"].shape
    assert ssao_kernel.blur(**blur).shape == blur["access"].shape
    assert [(e, k) for e, _, k in launches] == [
        ("crychic_ssao_occlusion", "ssao.occlusion"),
        ("crychic_ssao_blur", "ssao.blur")]
    for entry, args, _ in launches:
        argtypes, _ = ssao_kernel.LIBRARY.signatures[entry]
        assert len(args) + 1 == len(argtypes), entry
    args = launches[0][1]
    assert args[3:6] == occ["normal_v"].stride()
    assert args[1] == occ["capacity"]


def _malformed(occ, blur, case):
    """(wrapper, kwargs) with one input made malformed."""
    o, b = dict(occ), dict(blur)
    if case == "depth_f64":
        o["depth_ndc"] = o["depth_ndc"].double()
    elif case == "normals_shape":
        o["normal_v"] = o["normal_v"][:-1]
    elif case == "field_strided":
        o["random_field"] = o["random_field"].transpose(0, 1).contiguous(
            ).transpose(0, 1)
    elif case == "offsets_13":
        o["offsets"] = o["offsets"][:13]
    elif case == "inv_length":
        o["inv"] = o["inv"][:-1]
    elif case == "inv_int32":
        o["inv"] = o["inv"].int()
    elif case == "proj_3x4":
        o["proj"] = o["proj"][:3]
    elif case == "row_offset":
        o["row_offset"] = -1
    elif case == "tap_1d":
        o["tap_depth"] = o["tap_depth"][0]
    elif case == "weights_9":
        b["weights"] = b["weights"][1:-1]
    elif case == "access_3d":
        b["access"] = b["access"][..., None]
    elif case == "blur_depth_shape":
        b["depth_ndc"] = b["depth_ndc"][:, 1:]
    else:
        raise KeyError(case)
    if case in ("weights_9", "access_3d", "blur_depth_shape"):
        return ssao_kernel.blur, b
    return ssao_kernel.occlusion, o


@pytest.mark.parametrize("case", [
    "depth_f64", "normals_shape", "field_strided", "offsets_13",
    "inv_length", "inv_int32", "proj_3x4", "row_offset", "tap_1d",
    "weights_9", "access_3d", "blur_depth_shape"])
def test_wrappers_refuse_malformed_inputs(small4, launches, case):
    """A wrong dtype, shape, layout or row offset raises ValueError before
    any launch."""
    fn, kw = _malformed(*_kernel_args(*small4), case)
    with pytest.raises(ValueError):
        fn(**kw)
    assert launches == []


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


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


@pytest.fixture(scope="module")
def renderers(cuda, assets):
    """Config 4 and config 5 (the synthetic set) at 1920x1080 on the card."""
    out = {}
    for config, kw in ((4, {}), (5, assets)):
        scene, cfg, lights = sb.CONFIGS[config]()
        out[config] = Renderer(scene, cfg, lights=lights, device=cuda, **kw)
    yield out
    for r in out.values():
        r.close()


def _posed(r, frame):
    """r at the reference pose (frame None) or at turn-q3's heading of
    `frame`, capacities grown where the heading needs it; the frame's
    time."""
    if frame is None:
        r.camera = r._default_camera()
        return 0.0
    cam = Camera()
    cam.set_lens(0.25 * math.pi, r.cfg.width / r.cfg.height, 1.0, 100.0)
    cam.set_position(*TURN_POSITION)
    cam.rotate_y(math.radians(frame * TURN_DEG))
    r.camera = cam
    r.ensure_capacity(frame / 60.0)
    return frame / 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("frame", (None,) + TURN_FRAMES)
@pytest.mark.parametrize("config", [4, 5])
def test_poses(renderers, config, frame):
    """The compacted stage at the reference pose and two headings of
    turn-q3: the map, the overflow flag and the tile count equal."""
    r = renderers[config]
    t = _posed(r, frame)
    assert r.cfg.ssao_tile_capacity
    before = tally.snapshot()
    runs = _both(r, r.cfg, _inputs(r, t))
    torch.cuda.synchronize()
    moved = tally.since(before)
    assert (moved["ssao.occlusion"], moved["ssao.blur"]) == (1, 3)
    _assert_same(runs)
    assert not bool(runs[0][1]["ssao_tiles_overflowed"])


@pytest.mark.cuda
def test_undersized_capacity(renderers):
    """Half the tiles the frame needs: the tiles past the capacity read 1.0
    in both, and both flag the overflow."""
    r = renderers[5]
    _posed(r, None)
    inputs = _inputs(r)
    full = _both(r, r.cfg, inputs)[0]
    cfg = dataclasses.replace(
        r.cfg, ssao_tile_capacity=int(full[2]["ssao_tiles"]) // 2)
    runs = _both(r, cfg, inputs)
    _assert_same(runs)
    assert bool(runs[0][1]["ssao_tiles_overflowed"])
    assert not torch.equal(runs[0][0], full[0])
    # the occlusion alone: every tile without a slot reads 1.0
    consts, normal_v, depth, valid = inputs
    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    cb = cfg.ssao_tile_capacity
    _, inv, _, _ = fr._compact(fr._ssao_occupied(cfg, *d_half.shape, valid),
                               cb)
    occ = ssao_kernel.occlusion(
        n_half, d_half, consts.proj, consts.inv_proj,
        r.device_scene.ssao_offsets,
        random_field=r.device_scene.ssao_random_field, tap_depth=depth,
        inv=inv, capacity=cb)
    tiles = fr._tiles(occ, fr.SSAO_TILE_H, fr.SSAO_TILE_W, 1.0)[0][..., 0]
    assert bool((tiles[inv >= cb] == 1.0).all())
    assert bool((tiles[inv < cb] < 1.0).any())


@pytest.mark.cuda
def test_dense_and_band(renderers):
    """The dense occlusion (every tile) and a band of rows 131..267 at
    row offset 131 of the 540-row map, against the plain occlusion; the
    band's rows equal the dense map's."""
    r = renderers[5]
    _posed(r, None)
    consts, normal_v, depth, valid = _inputs(r)
    s, cfg = r.device_scene, r.cfg
    dense_cfg = dataclasses.replace(cfg, ssao_tile_capacity=None)
    _assert_same(_both(r, dense_cfg, (consts, normal_v, depth, valid)))

    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    y0, rows = 131, 137
    band = dict(random_field=s.ssao_random_field[y0:y0 + rows],
                tap_depth=depth, row_offset=y0, full_height=cfg.ssao_height)
    args = (n_half[y0:y0 + rows], d_half[y0:y0 + rows], consts.proj,
            consts.inv_proj, s.ssao_offsets)
    got = ssao_kernel.occlusion(*args, **band)
    _assert_equal(got, ssao_ops.ssao_occlusion(*args, **band), "band")
    whole = ssao_kernel.occlusion(
        n_half, d_half, consts.proj, consts.inv_proj, s.ssao_offsets,
        random_field=s.ssao_random_field, tap_depth=depth)
    _assert_equal(got, whole[y0:y0 + rows], "band against the dense map")


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["screen", "odd"])
def test_blur_alone(renderers, window):
    """The blur iterations on a random access map with the frame's normals
    and depth, over the whole 960x540 map and over a 117x895 window: every
    iteration, and the three of ssao_blur, equal the plain passes."""
    r = renderers[5]
    _posed(r, None)
    consts, normal_v, depth, _ = _inputs(r)
    n_half, d_half = fr.ssao_inputs_half(r.cfg, normal_v, depth)
    if window == "odd":
        n_half, d_half = n_half[13:130, 5:900], d_half[13:130, 5:900]
    d_half = d_half.contiguous()
    g = torch.Generator().manual_seed(23)
    access = torch.rand(d_half.shape, generator=g).to(d_half.device)
    s = r.device_scene
    one = dataclasses.replace(r.cfg, ssao_blur_count=1)
    a = access
    for i in range(r.cfg.ssao_blur_count):
        got = ssao_kernel.blur(a, n_half, d_half, s.ssao_blur_weights,
                               consts.proj)
        want = fr.ssao_blur_plain(s, consts, one, a, n_half, d_half)
        _assert_equal(got, want, f"iteration {i}")
        a = want
    _assert_equal(fr.ssao_blur(s, consts, r.cfg, access, n_half, d_half),
                  fr.ssao_blur_plain(s, consts, r.cfg, access, n_half,
                                     d_half), "ssao_blur")


@pytest.mark.cuda
def test_compiled_frame_goes_through_k9(cuda, monkeypatch):
    """Config 4 at 1080p: the replay launches the occlusion once and the
    blur three times, and equals the frame rendered eagerly with the
    plain stage."""
    scene, cfg, lights = sb.CONFIGS[4]()
    r = Renderer(scene, cfg, lights=lights, device=cuda)
    r.render(0.0)
    before = tally.snapshot()
    img = r.render(0.0)
    torch.cuda.synchronize()
    launches = r.compiled_frame.launches
    assert launches["ssao.occlusion"] == 1
    assert launches["ssao.blur"] == cfg.ssao_blur_count == 3
    moved = tally.since(before)
    assert moved["ssao.occlusion"] == 1 and moved["ssao.blur"] == 3
    monkeypatch.setattr(fr, "ssao_pass", fr.ssao_pass_plain)
    want = fr.render_frame(r.device_scene, r.frame_constants(0.0), r.cfg)
    assert torch.equal(img, want)
    r.close()
