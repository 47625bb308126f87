"""Each device module of the port against its JAX function, on the same
numpy inputs (made from seeds). The JAX side runs eagerly, op by op, so
XLA rounds each op as eager torch does; what is left are reduction orders
and library transcendentals (pow, sqrt, log2, sin).

Tolerance: 1e-5 absolute (1e-6 for the upsample). Measured max |error|:
clip_near, cascade_shadow_factor, bilateral_blur and the front end
(statics, clipped vertex records, screen setup) 0; pbr+tonemap 6e-8;
normal mapping and Fresnel 1.2e-7; aniso sampling 3.6e-7; lod 1.9e-6;
procedural sky 6e-8; ssao_occlusion 1.2e-7; bilinear upsample 1.2e-7.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.ops import clipping as jclip
from crychic_renderer_tpu.ops import sampling as jsamp
from crychic_renderer_tpu.ops import shading as jshade
from crychic_renderer_tpu.ops import shadows as jshadows
from crychic_renderer_tpu.ops import ssao as jssao
from crychic_renderer_tpu_torch.ops import clipping, sampling, shading
from crychic_renderer_tpu_torch.ops import shadows, ssao
from torch_threads import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, what, atol=ATOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def test_clip_near():
    rng = np.random.default_rng(1)
    T = 500
    attr = rng.normal(size=(T, 3, 16)).astype(np.float32)
    attr[..., 2] = rng.uniform(-1, 1, (T, 3))  # z straddles the near plane
    attr[..., 3] = rng.uniform(0.5, 2, (T, 3))
    valid = rng.random(T) > 0.1
    out_j, v_j = jclip.clip_near(jnp.asarray(attr), jnp.asarray(valid))
    out_t, v_t = clipping.clip_near(_t(attr), _t(valid))
    np.testing.assert_array_equal(np.asarray(v_j), v_t.numpy())
    _close(out_j, out_t, "clip_near")


def test_pbr_shading_and_tonemap():
    from crychic_renderer_tpu.models.materials import build_reference_lights

    rng = np.random.default_rng(2)
    shape = (40, 50)

    def unit(n):
        v = rng.normal(size=shape + (n,)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    normal, view = unit(3), unit(3)
    pos = rng.normal(size=shape + (3,)).astype(np.float32)
    albedo = rng.random(shape + (4,)).astype(np.float32)
    rough = rng.uniform(0.05, 1, shape + (1,)).astype(np.float32)
    metal = rng.random(shape + (1,)).astype(np.float32)
    sf = rng.random(shape + (1,)).astype(np.float32)
    lights = build_reference_lights()
    lights.num_dir = 3
    lt = types.SimpleNamespace(strength=_t(lights.strength),
                               direction=_t(lights.direction), num_dir=3)
    ref = jshade.tonemap_direct(jshade.pbr_shading(
        lights, jnp.asarray(normal), jnp.asarray(view), jnp.asarray(pos),
        jnp.asarray(albedo), jnp.asarray(rough), jnp.asarray(metal),
        jnp.asarray(sf)))
    got = shading.tonemap_direct(shading.pbr_shading(
        lt, _t(normal), _t(view), _t(pos), _t(albedo), _t(rough),
        _t(metal), _t(sf)))
    _close(ref, got, "pbr_shading + tonemap_direct")
    tan = unit(3)
    nsamp = rng.random(shape + (3,)).astype(np.float32)
    _close(jshade.normal_sample_to_world(jnp.asarray(nsamp),
                                         jnp.asarray(normal),
                                         jnp.asarray(tan)),
           shading.normal_sample_to_world(_t(nsamp), _t(normal), _t(tan)),
           "normal_sample_to_world")
    _close(jshade.schlick_fresnel(jnp.asarray(albedo[..., :3]),
                                  jnp.asarray(normal), jnp.asarray(view)),
           shading.schlick_fresnel(_t(albedo[..., :3]), _t(normal),
                                   _t(view)), "schlick_fresnel")


@pytest.fixture(scope="module")
def random_pools():
    """A dual-mip pair pool built from RANDOM uint8 mip chains (the assets
    here are white 1x1, which would make every sample 1.0): two big pairs
    at odd source sizes and one small (animation-class) pair."""
    rng = np.random.default_rng(3)

    def img(h, w):
        return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)]

    chains = [(img(96, 80), img(64, 64)), (img(512, 512), img(200, 300)),
              (img(64, 64), img(32, 48))]
    jpool = jsamp.PairPool.build(chains, 2, dual=True)
    tpool = sampling.PairPool.build(chains, 2, dual=True)
    np.testing.assert_array_equal(np.asarray(jpool.data), tpool.data)
    data = torch.from_numpy(tpool.data.view(np.int32))
    return jpool, sampling.PairPool(data, tpool.n_big, dual=True)


def test_sample_pair_aniso(random_pools):
    jpool, tpool = random_pools
    rng = np.random.default_rng(4)
    n = 4000
    pair = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    # footprints from magnified to strongly anisotropic minified
    scale = 10.0 ** rng.uniform(-4, -0.5, (n, 1))
    dx = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    dy = (rng.normal(size=(n, 2)) * scale
          * rng.uniform(0.05, 1, (n, 1))).astype(np.float32)
    ref = jsamp.sample_pair_aniso(jpool, jnp.asarray(pair), jnp.asarray(uv),
                                  jnp.asarray(dx), jnp.asarray(dy), 8,
                                  probes=2)
    got = sampling.sample_pair_aniso(tpool, _t(pair).long(), _t(uv), _t(dx),
                                     _t(dy), 8, probes=2)
    _close(ref[0], got[0], "aniso diffuse")
    _close(ref[1], got[1], "aniso normal")
    lod_j = jsamp.lod_from_derivatives(jnp.asarray(dx), jnp.asarray(dy))
    _close(lod_j, sampling.lod_from_derivatives(_t(dx), _t(dy)), "lod")


def test_procedural_sky_color():
    d = np.random.default_rng(5).normal(size=(300, 3)).astype(np.float32)
    _close(jsamp.procedural_sky_color(jnp.asarray(d)),
           sampling.procedural_sky_color(_t(d)), "procedural sky")


def test_cascade_shadow_factor():
    """Zero-radius PCF with cascade selection and the deferred blend.
    Power-of-two shadow transforms make every projection exact, and the
    receiver depths sit off the u16 compare boundary (as
    test_raster_pallas.py does), so both sides compare the same bits."""
    rng = np.random.default_rng(6)
    S = 64
    maps = rng.random((4, S, S)).astype(np.float32)
    maps[:, :20, :] = 1.0
    maps[:, 44:, :] = 0.0
    tr = np.zeros((4, 4, 4), np.float32)
    for c in range(4):
        tr[c] = np.diag([1 / 256, 1 / 256, 1 / 256, 1.0])
        tr[c, 3, :3] = (0.5 + c / 64, 0.5 - c / 64, 0.5)
    shape = (30, 40)
    x = rng.uniform(-115, 115, shape)
    y = rng.uniform(-115, 115, shape)
    d = rng.uniform(0.3, 0.7, shape)
    d = (np.floor(d * 65535.0) + 0.75) / 65535.0
    z = (d.astype(np.float32) - np.float32(0.5)) * np.float32(256)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    eye = np.zeros(3, np.float32)
    dead = rng.random(shape) < 0.1
    ref = jshadows.cascade_shadow_factor(
        jnp.asarray(maps), jnp.asarray(tr), jnp.asarray(pos),
        jnp.asarray(eye), S, deferred_blend_quirk=True,
        dead=jnp.asarray(dead))
    got = shadows.cascade_shadow_factor(_t(maps), _t(tr), _t(pos), _t(eye),
                                        S, deferred_blend_quirk=True,
                                        dead=_t(dead))
    assert 0.0 < float(got.mean()) < 1.0
    _close(ref, got, "cascade_shadow_factor")


@pytest.fixture(scope="module")
def ssao_inputs():
    from crychic_renderer_tpu.utils import mathutil as mu

    rng = np.random.default_rng(7)
    h, w = 24, 40
    proj = mu.perspective_fov_lh(0.25 * np.pi, w / h, 1.0, 100.0)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2])  # facing the camera
    depth_full = rng.uniform(0.95, 0.999, (2 * h, 2 * w)).astype(np.float32)
    depth_full[:, :10] = 1.0  # sky strip
    d_half = depth_full.reshape(h, 2, w, 2).mean((1, 3))
    field = jssao.build_random_field(jssao.build_random_vector_texture(),
                                     h, w)
    return dict(proj=proj, inv_proj=np.linalg.inv(proj).astype(np.float32),
                n=n, depth_full=depth_full, d_half=d_half, field=field,
                offsets=jssao.build_offset_vectors())


def test_ssao_occlusion(ssao_inputs):
    s = ssao_inputs
    ref = jssao.ssao_occlusion(
        jnp.asarray(s["n"]), jnp.asarray(s["d_half"]), jnp.asarray(s["proj"]),
        jnp.asarray(s["inv_proj"]), s["offsets"],
        random_field=jnp.asarray(s["field"]),
        tap_depth=jnp.asarray(s["depth_full"]))
    got = ssao.ssao_occlusion(
        _t(s["n"]), _t(s["d_half"]), _t(s["proj"]), _t(s["inv_proj"]),
        _t(s["offsets"]), random_field=_t(s["field"]),
        tap_depth=_t(s["depth_full"]))
    assert float(got.min()) < 0.9
    _close(ref, got, "ssao_occlusion")


@pytest.mark.parametrize("horizontal", [True, False])
def test_bilateral_blur(ssao_inputs, horizontal):
    s = ssao_inputs
    rng = np.random.default_rng(8)
    amb = rng.random(s["d_half"].shape).astype(np.float32)
    A, B = s["proj"][2, 2], s["proj"][3, 2]
    dv = jssao.ndc_depth_to_view(s["d_half"], A, B).astype(np.float32)
    border = np.float32(B / (1.0 - A))
    w = jssao.calc_gauss_weights(2.5)
    ref = jssao.bilateral_blur(jnp.asarray(amb), jnp.asarray(s["n"]),
                               jnp.asarray(dv), jnp.asarray(w), horizontal,
                               border_depth_view=border)
    got = ssao.bilateral_blur(_t(amb), _t(s["n"]), _t(dv), _t(w), horizontal,
                              border_depth_view=torch.tensor(border))
    _close(ref, got, "bilateral_blur")


def test_upsample_bilinear_matches_jax_resize():
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize at frame.py:928, borders included."""
    import jax

    from crychic_renderer_tpu_torch.passes.frame import _upsample_bilinear

    img = np.random.default_rng(9).random((27, 30)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (54, 60), method="bilinear")
    _close(ref, _upsample_bilinear(_t(img), 54, 60), "upsample", atol=1e-6)


def test_front_end_matches_jax():
    """Static corner tables, per-triangle vertex records, near clip and
    screen setup for the config-4 main view (1/8 size)."""
    from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.passes import frame as jfr
    from crychic_renderer_tpu_torch.passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=240, height=135,
                              shadow_map_size=256)
    jr = JRenderer(scene, cfg, lights=lights, auto_capacity=False)
    js = jr.device_scene
    consts = jr.frame_constants(0.0)
    draw = fr.DeviceDraw.from_host(scene.opaque, "cpu")
    mt = _t(scene.material_bank.mat_transform)
    td = fr.draw_with_statics(draw, mt)
    for name in ("tri_posw_h", "tri_instance", "tri_rest"):
        _close(getattr(js.opaque, name), getattr(td, name), name)
    tconsts = fr.FrameConstants.from_numpy(
        {f.name: np.asarray(getattr(consts, f.name))
         for f in dataclasses.fields(consts)
         if getattr(consts, f.name) is not None}, "cpu")
    tscene = dataclasses.replace(
        fr.DeviceScene.from_numpy({"opaque": {
            f.name: np.asarray(getattr(js.opaque, f.name))
            for f in dataclasses.fields(js.opaque)}, "n_big_pairs": 0},
            "cpu"),
        mat_transform=mt)
    tris_j, attr_j = jfr.main_view_tris(js, consts, cfg)
    tris_t, attr_t = fr.main_view_tris(tscene, tconsts, cfg)
    _close(attr_j, attr_t, "tri_attr (clipped)")
    np.testing.assert_array_equal(np.asarray(tris_j.valid),
                                  tris_t.valid.numpy())
    np.testing.assert_array_equal(np.asarray(tris_j.xy), tris_t.xy.numpy())
    _close(tris_j.z, tris_t.z, "screen z")
