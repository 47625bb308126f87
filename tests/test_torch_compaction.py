"""The port's tile-compacted shading (passes/frame.py: _resolve_compacted,
_ssao_occlusion_compacted, _pcf_factor_compacted, the tile counts of
capacity_requirements and the Renderer's tile capacities) on the CPU,
against the port's dense passes and the JAX package's compacted ones.

Config 4 at 512x192 with 256^2 cascades and the camera pitched up, as in
tests/test_capacity.py, so whole tile rows are sky: 24 of the 96 shade
tiles and 40 of the 96 SSAO tiles are needed, and both Renderers size
64-slot capacities. The JAX intermediates (XLA raster, shadow maps) are
shared; the JAX passes run eagerly, so XLA rounds op by op as torch does.
Tolerances: the compacted resolve and PCF factor are bit-equal to the
port's dense ones (the same math on the same values); SSAO within 1e-5
(the JAX package's bound for its compaction, tests/test_capacity.py);
against the JAX package 1e-5, the bound of the port's tests of the dense
functions (test_torch_ops.py, test_torch_options.py); whole frames at
most 0.5% of pixels above 0.02 (test_torch_frame.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.models.scenes_baseline import (
    fence_scene as jfence_scene)
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.ops import shadows as jshadows
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app.renderer import CapacityError, Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.models.scenes_baseline import fence_scene
from crychic_renderer_tpu_torch.ops import pcf, shadows
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.parallel import launch
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves
from torch_threads import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5
SOFT = 2.5
W, H = 512, 192
UP = (0.0, 1.0, 0.0)
PITCHED = ((0.0, 4.0, -20.0), (0.0, 7.0, 0.0), UP)  # top tile rows sky
DOWN = ((0.0, 6.0, -12.0), (0.0, 0.0, 0.0), UP)  # 92 of 96 shade tiles
CAPACITY = {"shade": "shade_tile_capacity", "ssao": "ssao_tile_capacity"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, what, atol=ATOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def _config4(pose=PITCHED):
    """Both packages' config-4 Renderers at W x H, posed and autosized at
    the pose, the port's scene made from the JAX scene's leaves."""
    scene, cfg, lights = JCONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=W, height=H, shadow_map_size=256)
    rj = JRenderer(scene, cfg, lights=lights)
    rj.camera.look_at(*pose)
    rj._autosize_capacity()
    rj.rebind_frame_fn()
    rt = _port_config4(pose)
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    return rj, rt


def _port_config4(pose=PITCHED):
    scene, cfg, lights = CONFIGS[4]()
    rt = Renderer(scene, dataclasses.replace(cfg, width=W, height=H,
                                             shadow_map_size=256),
                  lights=lights, device="cpu")
    rt.camera.look_at(*pose)
    rt._autosize_capacity()
    return rt


def _dense(cfg):
    return dataclasses.replace(cfg, shade_tile_capacity=None,
                               ssao_tile_capacity=None)


@pytest.fixture(scope="module")
def base():
    """The Renderers and one main-view raster, shadow-map set and
    G-buffer of the pitched frame from the JAX package, with both
    packages' scenes and constants."""
    rj, rt = _config4()
    cfg = rj.cfg
    js, jc = rj.device_scene, rj.frame_constants(0.0)

    def front(s, c):
        tris, attr = jfr.main_view_tris(s, c, cfg)
        bins = jrz.bin_triangles(tris, W, H, cfg.pair_capacity)
        depth, tid = jrz.rasterize_binned(tris, bins, W, H, cfg.bin_cap)
        return tris, attr, depth, tid, jfr.render_shadow_maps(s, c, cfg)

    tris, attr, depth, tid, maps = jax.jit(front)(js, jc)
    g = jfr.resolve_gbuffer(js, jc, _dense(cfg), tris, depth, tid, attr)
    return dict(rj=rj, rt=rt, js=js, jc=jc, tc=rt.frame_constants(0.0),
                tris=tris, attr=attr, depth=depth, tid=tid, maps=maps, g=g,
                ttris=rz.ScreenTris(*(_t(x) for x in tris)),
                tg={k: _t(v) for k, v in g.items()})


@pytest.fixture
def shared_hash(monkeypatch):
    """The JAX package's soft PCF with the port's rotation hash on the same
    (eager) values; see tests/test_torch_pcf.py."""
    def port_nrand(uv):
        return jnp.asarray(pcf.nrand(_t(np.asarray(uv))).numpy())

    monkeypatch.setattr(jshadows, "nrand", port_nrand)


# ---------------------------------------------------------------------------
# Tile counts and capacities
# ---------------------------------------------------------------------------

def _fence(alpha_test=True):
    """Both packages' fence Renderers looking up at the fence, so its bars
    land on sky tiles that no opaque triangle's box touches
    (tests/test_capacity.py's pose)."""
    out = []
    for make, cls, kw in ((jfence_scene, JRenderer, {}),
                          (fence_scene, Renderer, dict(device="cpu"))):
        scene, cfg, lights = make(alpha_test=alpha_test)
        r = cls(scene, cfg, lights=lights, **kw)
        r.camera.look_at((0.0, 2.0, -14.0), (0.0, 6.0, 0.0), UP)
        out.append(r)
    return out


def _jax_requirements(r, cfg=None):
    cfg = r.cfg if cfg is None else cfg
    req = jax.jit(lambda s, c: jfr.capacity_requirements(s, c, cfg))(
        r.device_scene, r.frame_constants(0.0))
    return {k: int(v) for k, v in req.items()}


@pytest.mark.parametrize("scene", ["config4_pitched", "fence_alpha"])
def test_tile_counts_match_jax(base, scene):
    """capacity_requirements' shade_tiles and ssao_tiles equal the JAX
    package's. With the alpha layer on, the fence's bars add tiles over
    the sky, which both count (without them a covered fence tile would be
    filled with sky)."""
    if scene == "fence_alpha":
        rj, rt = _fence()
        ref = _jax_requirements(rj)
        off = _jax_requirements(rj, dataclasses.replace(
            rj.cfg, alpha_test_enabled=False))
        assert ref["shade_tiles"] > off["shade_tiles"], (ref, off)
        got = rt.capacity_requirements(0.0)
        off_t = fr.capacity_requirements(
            rt.device_scene, rt.frame_constants(0.0),
            dataclasses.replace(rt.cfg, alpha_test_enabled=False))
        assert int(off_t["shade_tiles"]) == off["shade_tiles"]
    else:
        rt = base["rt"]
        ref = _jax_requirements(base["rj"])
        got = rt.capacity_requirements(0.0)
    for k in ("shade_tiles", "ssao_tiles"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert got["shade_tiles"] > 0
    assert (got["ssao_tiles"] > 0) == rt.cfg.ssao_enabled


def test_autosized_capacities_match_jax(base):
    rj, rt = base["rj"], base["rt"]
    nt = -(-H // fr.SHADE_TILE_H) * -(-W // fr.SHADE_TILE_W)
    snt = (-(-rt.cfg.ssao_height // fr.SSAO_TILE_H)
           * -(-rt.cfg.ssao_width // fr.SSAO_TILE_W))
    for name in CAPACITY.values():
        assert getattr(rt.cfg, name) == getattr(rj.cfg, name), name
    assert rt.cfg.shade_tile_capacity < nt and rt.cfg.ssao_tile_capacity < snt
    req = rt.check_capacity(0.0)
    assert req["shade_tiles"] <= rt.cfg.shade_tile_capacity
    assert req["ssao_tiles"] <= rt.cfg.ssao_tile_capacity


# ---------------------------------------------------------------------------
# The compacted passes
# ---------------------------------------------------------------------------

def test_compacted_resolve(base):
    """Bit-equal to the port's dense resolve, plane by plane, and within
    1e-5 of the JAX package's compacted resolve on the same inputs."""
    rt, cfg = base["rt"], base["rt"].cfg
    args = (base["ttris"], _t(base["depth"]), _t(base["tid"]),
            _t(base["attr"]))
    stats = {}
    got = fr.resolve_gbuffer(rt.device_scene, base["tc"], cfg, *args,
                             stats=stats)
    dense = fr.resolve_gbuffer(rt.device_scene, base["tc"], _dense(cfg),
                               *args)
    assert not bool(stats["shade_tiles_overflowed"])
    valid = got["valid"]
    assert 0.0 < float(valid.float().mean()) < 0.5
    for k in dense:
        assert torch.equal(got[k], dense[k]), k
    assert base["rj"].cfg.shade_tile_capacity == cfg.shade_tile_capacity
    ref = jfr.resolve_gbuffer(base["js"], base["jc"], base["rj"].cfg,
                              base["tris"], base["depth"], base["tid"],
                              base["attr"])
    np.testing.assert_array_equal(np.asarray(ref["valid"]), valid.numpy())
    for k in ("pos_w", "normal_w", "normal_v", "albedo", "roughness",
              "metalness", "shininess_alpha"):
        _close(ref[k], got[k], f"compacted resolve: {k}")


def test_compacted_ssao(base):
    """The compacted occlusion (and the pass with its dense blurs) within
    1e-5 of the dense one, more than half of the pixels equal (the sky
    tiles' fill is their true value), and within 1e-5 of the JAX
    package's compacted occlusion."""
    rt, cfg = base["rt"], base["rt"].cfg
    ts, tc = rt.device_scene, base["tc"]
    normal_v, depth = base["tg"]["normal_v"], _t(base["depth"])
    valid = _t(base["tid"]) >= 0
    stats = {}
    got = fr.ssao_pass(ts, tc, cfg, normal_v, depth, valid=valid,
                       stats=stats)
    dense = fr.ssao_pass(ts, tc, _dense(cfg), normal_v, depth, valid=valid)
    assert not bool(stats["ssao_tiles_overflowed"])
    assert float(got.min()) < 0.9
    _close(dense, got, "compacted SSAO pass vs dense")
    assert float((got == dense).float().mean()) > 0.5

    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    occ, _ = fr._ssao_occlusion_compacted(ts, tc, cfg, n_half, d_half, depth,
                                          valid)
    jn, jd = jfr.ssao_inputs_half(cfg, base["g"]["normal_v"], base["depth"])
    ref = jfr._ssao_occlusion_compacted(base["js"], base["jc"],
                                        base["rj"].cfg, jn, jd,
                                        base["depth"], base["tid"] >= 0)
    _close(ref, occ, "compacted occlusion vs JAX")
    _close(jfr.ssao_pass(base["js"], base["jc"], base["rj"].cfg,
                         base["g"]["normal_v"], base["depth"],
                         valid=base["tid"] >= 0), got,
           "compacted SSAO pass vs JAX")


@pytest.mark.parametrize("radius", [None, SOFT], ids=["zero", "soft"])
def test_compacted_pcf_factor(base, shared_hash, monkeypatch, radius):
    """The compacted cascade PCF factor bit-equal to the dense one, with
    the zero radius and with the soft disk (K6's plain version over
    2 * CB * 1024 receiver-cascades), and within 1e-5 of the JAX
    package's compacted factor (rotation hash shared); the lighting pass
    that takes it within 1e-5 of the JAX package's."""
    rt = base["rt"]
    cfg = dataclasses.replace(rt.cfg, pcf_radius_texels=radius)
    jcfg = dataclasses.replace(base["rj"].cfg, pcf_radius_texels=radius)
    tc, jc, maps = base["tc"], base["jc"], _t(base["maps"])
    pos_w, valid = base["tg"]["pos_w"], base["tg"]["valid"]

    def sf(pw, dead):
        return shadows.cascade_shadow_factor(
            maps, tc.shadow_transforms, pw, tc.eye_pos, cfg.shadow_map_size,
            deferred_blend_quirk=True, soft_radius_texels=radius, dead=dead)

    def jsf(pw, dead):
        return jshadows.cascade_shadow_factor(
            base["maps"], jc.shadow_transforms, pw, jc.eye_pos,
            cfg.shadow_map_size, deferred_blend_quirk=True,
            soft_radius_texels=radius, dead=dead)

    receivers = []
    real_plain = pcf.soft_pcf_plain

    def counting_plain(qmap, params, r):
        receivers.append(params.shape[1])
        return real_plain(qmap, params, r)

    monkeypatch.setattr(pcf, "soft_pcf_plain", counting_plain)
    got = fr._pcf_factor_compacted(cfg, pos_w, valid, sf)
    assert receivers == ([] if radius is None
                         else [2 * cfg.shade_tile_capacity * 1024])
    dense = sf(pos_w, ~valid)
    assert torch.equal(got, dense)
    assert 0.0 < float(got[valid].mean()) < 1.0
    ref = jfr._pcf_factor_compacted(jcfg, base["g"]["pos_w"],
                                    base["g"]["valid"], jsf)
    _close(ref, got, "compacted PCF factor vs JAX")
    amb = np.ones((H, W), np.float32)
    _close(jfr.lighting_pass(base["js"], jc, jcfg, base["g"], base["maps"],
                             jnp.asarray(amb), base["depth"]),
           fr.lighting_pass(rt.device_scene, tc, cfg, base["tg"], maps,
                            _t(amb), _t(base["depth"])),
           "lighting with the compacted factor vs JAX")


def test_frame_through_both_renderers(base):
    """The whole pitched frame through both Renderers (compacted in
    both): at most 0.5% of pixels above 0.02; the port's frame also equals
    its dense frame to 1e-5 and flags no overflow."""
    rj, rt = base["rj"], base["rt"]
    got = rt.render_np(0.0)
    rt.check_overflow()
    ref = rj.render_np(0.0)
    diff = np.abs(ref - got).max(axis=-1)
    frac = float((diff > 0.02).mean())
    print(f"pitched {W}x{H} frame, port vs JAX: {frac:.4%} of pixels "
          f"> 0.02 (max {diff.max():.3g}, mean {diff.mean():.3g})")
    assert frac <= PIX_BOUND
    dense = fr.render_frame(rt.device_scene, rt.frame_constants(0.0),
                            _dense(rt.cfg))
    _close(np.clip(dense.numpy(), 0.0, 1.0), got, "compacted vs dense frame")


# ---------------------------------------------------------------------------
# Overflow is never silent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(CAPACITY))
def test_capacity_one_raises(base, which):
    rt = base["rt"]
    cfg = rt.cfg
    rt.cfg = dataclasses.replace(cfg, **{CAPACITY[which]: 1})
    try:
        with pytest.raises(CapacityError, match=f"{which} tile overflow"):
            rt.check_capacity(0.0)
    finally:
        rt.cfg = cfg


@pytest.mark.parametrize("which", sorted(CAPACITY))
def test_undersized_frame_flags_overflow(base, which):
    """A frame whose covered tiles outrun the capacity renders without
    waiting and sets the flag check_overflow raises on (once: the read
    clears it)."""
    rt = base["rt"]
    cfg = rt.cfg
    rt.check_overflow()
    rt.cfg = dataclasses.replace(cfg, **{CAPACITY[which]: 1})
    try:
        rt.render(0.0)
        with pytest.raises(RuntimeError, match=f"{which} tile overflow"):
            rt.check_overflow()
        rt.check_overflow()
    finally:
        rt.cfg = cfg


def test_ensure_capacity_grows():
    """Capacities sized at the pitched pose; looking down at the scene
    needs more tiles than they hold: check_capacity raises,
    ensure_capacity sizes them again, and the frame renders clean."""
    rt = _port_config4()
    small = rt.cfg.shade_tile_capacity
    rt.camera.look_at(*DOWN)
    with pytest.raises(CapacityError, match="shade tile overflow"):
        rt.check_capacity(0.0)
    req = rt.ensure_capacity(0.0)
    assert rt.cfg.shade_tile_capacity >= req["shade_tiles"] > small
    assert rt.cfg.ssao_tile_capacity >= req["ssao_tiles"]
    rt.render(0.0)
    rt.check_overflow()


def test_sharded_frame_stays_dense():
    """render_frame_sharded on 2 gloo ranks: a cfg that carries tile
    capacities gives the dense cfg's image exactly (the bands stay
    dense), and the single-card compacted frame's within 1e-5."""
    rt = _port_config4()
    cfg = rt.cfg
    assert cfg.shade_tile_capacity and cfg.ssao_tile_capacity
    scene, c = rt.device_scene, rt.frame_constants(0.0)
    runs = launch.render_sharded([scene], [c], [(cfg, 0, (0,)),
                                                (_dense(cfg), 0, (0,))],
                                 2, "gloo", "cpu")
    for rank in range(2):
        capped, dense = runs[rank]
        assert np.array_equal(capped["img"], dense["img"]), rank
        assert np.array_equal(capped["img"], runs[0][0]["img"]), rank
        assert not capped["overflowed"]
    single = fr.render_frame(scene, c, cfg).numpy()
    _close(single, runs[0][0]["img"], "sharded vs single-card frame")
