"""The config-4 render options of the port against the JAX package: the
soft PCF disk, the fast preset, trilinear and other anisotropy settings,
the single-mip pool, quarter-res SSAO, cubemap sampling and the debug
views.

The full frames of the soft disk and the fast preset are in
test_torch_options_frame.py. The soft disk's rotation hash amplifies
rounding: in the port itself, a one-ulp change of the world positions
moves 0.025% of the soft-disk lighting's pixels and 0% of the fast
preset's by more than 0.02 (test_soft_disk_noise_floor).

Every option is compared at the pass it changes, on one shared set
of JAX intermediates (main-view raster, shadow maps, G-buffer), with the
JAX pass run eagerly so that XLA rounds op by op as torch does. The
material maps here are white 1x1 assets, so the resolve tests replace the
pair pool on both sides with one built from random mip chains. Tolerance
1e-5 absolute unless a test says otherwise; the measured maxima are in
each test's docstring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.ops import sampling as jsamp
from crychic_renderer_tpu.ops import shadows as jshadows
from crychic_renderer_tpu.ops import ssao as jssao
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import pcf, sampling
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.ops import ssao as ssao_ops
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5
SOFT = 2.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ref, got, what, atol=ATOL):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


@pytest.fixture
def shared_hash(monkeypatch):
    """The JAX package's soft PCF with the port's rotation hash on the same
    (eager) values; see tests/test_torch_pcf.py."""
    def port_nrand(uv):
        return jnp.asarray(pcf.nrand(_t(np.asarray(uv))).numpy())

    monkeypatch.setattr(jshadows, "nrand", port_nrand)


# ---------------------------------------------------------------------------
# Passes, on shared JAX intermediates
# ---------------------------------------------------------------------------

def _random_chains(seed, n_big, n_small):
    rng = np.random.default_rng(seed)

    def img(h, w):
        return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)]

    return ([(img(256, 256), img(200, 256)) for _ in range(n_big)]
            + [(img(64, 64), img(64, 64)) for _ in range(n_small)])


@pytest.fixture(scope="module")
def base():
    """One main-view raster, shadow-map set and dense G-buffer of the
    1/8-size config-4 frame, from the JAX package (XLA raster), and both
    packages' scenes and constants."""
    scene, cfg, lights = JCONFIGS[4]()
    cfg = dataclasses.replace(_small(cfg), use_pallas=False,
                              shade_tile_capacity=None,
                              ssao_tile_capacity=None)
    rj = JRenderer(scene, cfg, lights=lights, auto_capacity=False)
    js, jc = rj.device_scene, rj.frame_constants(0.0)
    W, H = cfg.width, cfg.height

    def front(s, c):
        tris, attr = jfr.main_view_tris(s, c, cfg)
        bins = jrz.bin_triangles(tris, W, H, cfg.pair_capacity)
        depth, tid = jrz.rasterize_binned(tris, bins, W, H, cfg.bin_cap)
        return tris, attr, depth, tid, jfr.render_shadow_maps(s, c, cfg)

    tris, attr, depth, tid, maps = jax.jit(front)(js, jc)
    g = jfr.resolve_gbuffer(js, jc, cfg, tris, depth, tid, attr)
    ts = fr.DeviceScene.from_numpy(_leaves(js), "cpu")
    tc = fr.FrameConstants.from_numpy(
        {f.name: np.asarray(getattr(jc, f.name))
         for f in dataclasses.fields(jc) if getattr(jc, f.name) is not None},
        "cpu")
    return dict(cfg=cfg, js=js, jc=jc, ts=ts, tc=tc, tris=tris, attr=attr,
                depth=depth, tid=tid, maps=maps, g=g,
                ttris=rz.ScreenTris(*(_t(x) for x in tris)),
                tg={k: _t(v) for k, v in g.items()})


@pytest.fixture(scope="module")
def pools(base):
    """Random-content pair pools of the scene's pair count, single-mip and
    dual-mip, as (JAX data, port data) per layout."""
    js = base["js"]
    n_big = js.n_big_pairs
    rows = js.pair_data.shape[0]
    n_small = (rows - n_big * jsamp.TEX_STRIDE) // jsamp.TEX_STRIDE_SMALL
    chains = _random_chains(11, n_big, n_small)
    out = {}
    for dual in (True, False):
        host = sampling.PairPool.build(chains, n_big, dual=dual)
        out[dual] = (jnp.asarray(host.data),
                     torch.from_numpy(host.data.view(np.int32)))
    return out


RESOLVE_OPTIONS = {
    "default": {},
    "trilinear": dict(anisotropy=1),
    "aniso4": dict(anisotropy=4),
    "probes4": dict(aniso_probes=4),
    "aniso_ref": dict(aniso_probes=0),
    "single_mip": dict(dual_mip_rows=False),
    "single_mip_trilinear": dict(dual_mip_rows=False, anisotropy=1),
    "single_mip_probes4": dict(dual_mip_rows=False, aniso_probes=4),
}


@pytest.mark.parametrize("name", sorted(RESOLVE_OPTIONS))
def test_resolve_option_matches_jax(base, pools, name):
    """The G-buffer resolve with each texture-sampling setting (the
    resolve's sampler switch, JAX frame.py:583-598, and the single-mip
    pool). Measured max |diff| over albedo, bumped normal and the normal
    map's alpha: 7.3e-6 for the reference-quality evaluator (16 bilinear
    fetches summed), <= 8.3e-7 for the others; view normals equal."""
    over = RESOLVE_OPTIONS[name]
    cfg = dataclasses.replace(base["cfg"], **over)
    jdata, tdata = pools[cfg.dual_mip_rows]
    js = dataclasses.replace(base["js"], pair_data=jdata)
    ts = dataclasses.replace(base["ts"], pair_data=tdata)
    ref = jfr.resolve_gbuffer(js, base["jc"], cfg, base["tris"],
                              base["depth"], base["tid"], base["attr"])
    got = fr.resolve_gbuffer(ts, base["tc"], cfg, base["ttris"],
                             _t(base["depth"]), _t(base["tid"]),
                             _t(base["attr"]))
    assert float(np.asarray(ref["albedo"]).std()) > 0.05  # textured
    for k in ("albedo", "normal_w", "shininess_alpha", "normal_v"):
        _close(ref[k], got[k], f"{name}: {k}")


def test_ssao_quarter_res_matches_jax(base):
    """ssao_scale=4: the quarter-res inputs (normals point-sampled, depth
    box-filtered over 4x4), the occlusion with a random field of the
    quarter-res size, the 3 two-pass blurs and the upsample to the
    screen. On the JAX package's quarter-res inputs the access agrees to
    1e-5 (measured 1.8e-7; normals equal, depth means 2.4e-7). Through the whole pass the 16-depth means
    differ in their last bit (summation order), which the view-depth
    conversion near the far plane and the 6th power amplify: bound 5e-4,
    measured 1.25e-4."""
    cfg = dataclasses.replace(base["cfg"], ssao_scale=4)
    h, w = cfg.ssao_height, cfg.ssao_width
    field = jssao.build_random_field(jssao.build_random_vector_texture(),
                                     h, w)
    js = dataclasses.replace(base["js"], ssao_random_field=jnp.asarray(field))
    ts = dataclasses.replace(base["ts"], ssao_random_field=_t(field))
    jc, tc = base["jc"], base["tc"]
    normal_v, depth = base["g"]["normal_v"], base["depth"]
    n_j, d_j = jfr.ssao_inputs_half(cfg, normal_v, depth)
    n_t, d_t = fr.ssao_inputs_half(cfg, _t(normal_v), _t(depth))
    assert n_t.shape == (h, w, 3) and d_t.shape == (h, w) == (33, 60)
    _close(n_j, n_t, "quarter-res normals", atol=0)
    _close(d_j, d_t, "quarter-res depth", atol=1e-6)

    ref = jfr.ssao_blur(js, jc, cfg, jssao.ssao_occlusion(
        n_j, d_j, jc.proj, jc.inv_proj, js.ssao_offsets,
        random_field=js.ssao_random_field, tap_depth=depth), n_j, d_j)
    got = fr.ssao_blur(ts, tc, cfg, ssao_ops.ssao_occlusion(
        _t(n_j), _t(d_j), tc.proj, tc.inv_proj, ts.ssao_offsets,
        random_field=ts.ssao_random_field, tap_depth=_t(depth)),
        _t(n_j), _t(d_j))
    assert float(_np(got).min()) < 0.9
    _close(ref, got, "quarter-res access")
    H, W = depth.shape
    _close(jfr._upsample_bilinear(ref, H, W),
           fr._upsample_bilinear(got, H, W), "upsampled access")
    _close(jfr.ssao_pass(js, jc, cfg, normal_v, depth),
           fr.ssao_pass(ts, tc, cfg, _t(normal_v), _t(depth)),
           "quarter-res pass", atol=5e-4)


LIGHTING_OPTIONS = {
    "soft": dict(pcf_radius_texels=SOFT),
    "fast": dict(fast_shadow_factor=True),
    "soft_fast": dict(pcf_radius_texels=SOFT, fast_shadow_factor=True),
    "cubemap_sky": dict(procedural_sky=False),
}


@pytest.mark.parametrize("name", sorted(LIGHTING_OPTIONS))
def test_lighting_option_matches_jax(base, shared_hash, name):
    """The lighting pass with the soft disk, the half-res shadow factor
    (68x120 factors upsampled to 135x240) and the cubemap sky, on the JAX
    G-buffer and shadow maps, with the rotation hash shared. Measured max
    |diff| 7.8e-7 (1.4e-6 with the cubemap sky)."""
    cfg = dataclasses.replace(base["cfg"], **LIGHTING_OPTIONS[name])
    H, W = base["depth"].shape
    amb = np.ones((H, W), np.float32)
    ref = jfr.lighting_pass(base["js"], base["jc"], cfg, base["g"],
                            base["maps"], jnp.asarray(amb), base["depth"])
    got = fr.lighting_pass(base["ts"], base["tc"], cfg, base["tg"],
                           _t(base["maps"]), _t(amb), _t(base["depth"]))
    _close(ref, got, name)


NOISE_OPTIONS = {
    "zero_radius": {},
    "soft": dict(pcf_radius_texels=SOFT),
    "soft_fast": dict(pcf_radius_texels=SOFT, fast_shadow_factor=True),
}


@pytest.mark.parametrize("name", sorted(NOISE_OPTIONS))
def test_soft_disk_noise_floor(base, name):
    """The port's lighting pass with the world positions moved by one ulp
    (x (1 + 2^-23)). The soft disk's rotation hash amplifies that; the
    share of pixels that move by more than 0.02 is the noise floor under
    the frame bound, and stays inside it. The zero-radius path has no
    hash and stays put (bound 1e-4). Measured: soft 0.025% (8 of 32,400
    pixels, max 0.027), soft + fast 0% (max 0.013), zero radius 0% (max
    5.0e-6)."""
    cfg = dataclasses.replace(base["cfg"], **NOISE_OPTIONS[name])
    H, W = base["depth"].shape
    maps, amb, depth = _t(base["maps"]), torch.ones((H, W)), _t(base["depth"])

    def lit(g):
        return fr.lighting_pass(base["ts"], base["tc"], cfg, g, maps, amb,
                                depth).numpy()

    moved = dict(base["tg"], pos_w=base["tg"]["pos_w"] * (1 + 2 ** -23))
    assert not torch.equal(moved["pos_w"], base["tg"]["pos_w"])
    diff = np.abs(lit(base["tg"]) - lit(moved)).max(-1)
    assert (diff > 0.02).mean() <= PIX_BOUND
    if name == "zero_radius":
        assert diff.max() < 1e-4


def test_fast_factor_upsample_matches_jax_resize():
    """The half-res factor grid of an odd-height frame: 68x120 -> 135x240
    is not a 2x resize; F.interpolate and jax.image.resize agree on it."""
    img = np.random.default_rng(12).random((68, 120)).astype(np.float32)
    _close(jax.image.resize(jnp.asarray(img), (135, 240), method="bilinear"),
           fr._upsample_bilinear(_t(img), 135, 240), "upsample", atol=1e-6)


def test_cubemap_sampling_matches_jax():
    """sample_cubemap on random directions, faces' edges included, from
    the scene's packed procedural cubemap (int32 bits in the port)."""
    faces = jsamp.pack_cubemap(jsamp.procedural_sky_cubemap(32))
    rng = np.random.default_rng(13)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    d[:500, 1] = d[:500, 0]  # |x| == |y|: the major-axis tie rule
    ref = jsamp.sample_cubemap(jnp.asarray(faces), jnp.asarray(d))
    got = sampling.sample_cubemap(_t(faces.view(np.int32)), _t(d))
    _close(ref, got, "cubemap")


@pytest.mark.parametrize("view", ["cascades", "shadow_cascade3"])
def test_debug_view_matches_jax(base, view):
    """The debug overlays on a random lit image: the cascade colorization
    and the blit of cascade 3 into the bottom-right quadrant. Equal (pure
    selection)."""
    cfg = dataclasses.replace(base["cfg"], debug_view=view)
    img = np.random.default_rng(14).random(
        base["depth"].shape + (4,)).astype(np.float32)
    pos_w = base["g"]["pos_w"]
    ref = jfr.apply_debug_overlay(base["jc"], cfg, jnp.asarray(img),
                                  base["maps"], pos_w)
    got = fr.apply_debug_overlay(base["tc"], cfg, _t(img), _t(base["maps"]),
                                 _t(pos_w))
    assert not np.array_equal(_np(got), img)
    _close(ref, got, view, atol=0)


def test_renderer_runs_on_the_card_by_default():
    """Without a device argument the Renderer runs on CUDA; without a card
    it raises instead of falling back to the CPU."""
    scene, cfg, lights = CONFIGS[4]()
    cfg = _small(cfg)
    if torch.cuda.is_available():
        r = tren.Renderer(scene, cfg, lights=lights)
        assert r.device.type == "cuda"
        assert r.device_scene.pair_data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tren.Renderer(scene, cfg, lights=lights)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tren.build_device_scene(scene, lights=lights)
