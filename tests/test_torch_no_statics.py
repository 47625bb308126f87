"""Draws without static corner tables (a DeviceScene built from
DeviceDraw.from_numpy draws, no attach_draw_statics) against the same
scene with them and against the JAX package, on the CPU.

The JAX package renders such a scene through its per-vertex path
(vertex_stage, vertex_records, build_tri_attrs, the legacy branches of
tri_attrs, shadow_tri_world and alpha_shadow_geom); the port does the
same. Inputs: BASELINE config 4 at 1/8 size (240x135, 256^2 maps) and
the fence scene at 160x90 (128^2 maps, the synthetic wire grid), both
packages' scenes from the JAX scene's leaves with the tables dropped.

Tolerances:
- the per-vertex stage, its records, the corner gather, shadow_clip,
  shadow_tri_world and alpha_shadow_geom equal the JAX functions' bit for
  bit, JAX run eagerly (jax.disable_jit(): jitted XLA contracts FMAs);
- the records, the world table, the alpha layer's peel and every frame
  without the tables are torch.equal to the same with them (rowmat is per
  row, so it commutes with the corner gather);
- the frame without the tables, on the kernel path and on the pure-XLA
  path (use_pallas=False), within the port's frame bound of the JAX
  package's frame of the same scene without tables (its CPU path, the
  XLA raster): at most 0.5% of pixels with a max-RGB |diff| above 0.02.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.models.scenes_baseline import fence_scene as jfence
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_fence import SMALL, fence_chains
from test_torch_frame import PIX_BOUND, _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()

DRAWS = ("opaque", "shadow", "alpha")
STATICS = ("tri_posw_h", "tri_instance", "tri_rest")


def scene_without_statics(leaves: dict) -> fr.DeviceScene:
    """A port DeviceScene built field by field from DeviceDraw.from_numpy
    draws that carry no static tables (the leaves' tables dropped)."""
    kw = {}
    for f in dataclasses.fields(fr.DeviceScene):
        v = leaves.get(f.name)
        if f.name in DRAWS:
            kw[f.name] = None if v is None else fr.DeviceDraw.from_numpy(
                {k: x for k, x in v.items() if k not in STATICS}, "cpu")
        elif f.name == "n_big_pairs":
            kw[f.name] = int(v)
        else:
            kw[f.name] = fr._tensor(v, "cpu")
    return fr.DeviceScene(**kw)


def jax_without_statics(scene):
    """The JAX DeviceScene with every draw's static tables dropped."""
    def strip(d):
        return None if d is None else dataclasses.replace(
            d, **{k: None for k in STATICS})

    return dataclasses.replace(scene, **{k: strip(getattr(scene, k))
                                         for k in DRAWS})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, what):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


@pytest.fixture(scope="module")
def config4():
    """The JAX Renderer of the 1/8-size config 4 (its CPU path, the XLA
    raster), the port's on the same leaves, both scenes without the
    tables, and the JAX frame of the scene without them."""
    scene, cfg, lights = JCONFIGS[4]()
    rj = jren.Renderer(scene, _small(cfg), lights=lights)
    tscene, tcfg, tlights = tsb.CONFIGS[4]()
    rt = tren.Renderer(tscene, _small(tcfg), lights=tlights, device="cpu")
    leaves = _leaves(rj.device_scene)
    rt.device_scene = fr.DeviceScene.from_numpy(leaves, "cpu")
    js = jax_without_statics(rj.device_scene)
    jc = rj.frame_constants(0.0)
    ref = np.clip(np.asarray(jax.jit(
        lambda s, c: jfr.render_frame(s, c, rj.cfg))(js, jc)), 0.0, 1.0)
    return dict(rj=rj, rt=rt, js=js, jc=jc, ts=scene_without_statics(leaves),
                tc=rt.frame_constants(0.0), ref=ref)


@pytest.mark.parametrize("path", ["kernel", "xla"])
def test_frame_without_statics(config4, path):
    """The repair: render_frame of a scene whose draws carry no static
    tables renders (it read draw.tri_posw_h unconditionally), equal to the
    frame with them, and within the frame bound of the JAX package's."""
    rt, tc = config4["rt"], config4["tc"]
    cfg = rt.cfg
    if path == "xla":
        cfg = dataclasses.replace(cfg, use_pallas=False,
                                  bin_cap=config4["rj"].cfg.bin_cap,
                                  shadow_bin_cap=config4["rj"].cfg
                                  .shadow_bin_cap)
    assert config4["ts"].opaque.tri_posw_h is None
    got = fr.render_frame(config4["ts"], tc, cfg)
    assert torch.equal(got, fr.render_frame(rt.device_scene, tc, cfg))
    diff = np.abs(np.clip(got.numpy(), 0.0, 1.0) - config4["ref"]).max(-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, f"{path}: {frac:.4%} of pixels > 0.02"


def test_vertex_stage_matches_jax(config4):
    """vertex_stage, vertex_records and build_tri_attrs of the opaque draw,
    shadow_clip and shadow_tri_world of the shadow draw, bit for bit
    against the JAX functions run eagerly."""
    js, jc, ts, tc = (config4[k] for k in ("js", "jc", "ts", "tc"))
    with jax.disable_jit():
        jv = jfr.vertex_stage(js.opaque, jc.opaque_visibility, jc.view_proj,
                              js.mat_transform)
        jattr = jfr.build_tri_attrs(js.opaque, *jv)
        jclip = jfr.shadow_clip(js.shadow, jc.shadow_visibility,
                                jc.cascade_view_projs[2])
        jworld = jfr.shadow_tri_world(js.shadow, jc.shadow_visibility)
    tv = fr.vertex_stage(ts.opaque, tc.opaque_visibility, tc.view_proj,
                         ts.mat_transform)
    for name, a, b in zip(("pos_w", "nrm_w", "tan_w", "uv", "clip"), tv, jv):
        _equal(a, b, name)
    _equal(fr.vertex_records(ts.opaque, *tv),
           jfr.vertex_records(js.opaque, *jv), "vertex_records")
    _equal(fr.build_tri_attrs(ts.opaque, *tv), jattr, "build_tri_attrs")
    _equal(fr.shadow_clip(ts.shadow, tc.shadow_visibility,
                          tc.cascade_view_projs[2]), jclip, "shadow_clip")
    _equal(fr.shadow_tri_world(ts.shadow, tc.shadow_visibility), jworld,
           "shadow_tri_world")


def test_records_without_statics_equal_statics(config4):
    """tri_attrs and shadow_tri_world through the per-vertex path equal
    the static tables' (torch.equal); capacity_requirements counts the
    same."""
    rt, ts, tc = config4["rt"], config4["ts"], config4["tc"]
    s = rt.device_scene
    assert torch.equal(
        fr.tri_attrs(ts.opaque, tc.opaque_visibility, tc.view_proj,
                     ts.mat_transform),
        fr.tri_attrs(s.opaque, tc.opaque_visibility, tc.view_proj,
                     s.mat_transform))
    assert torch.equal(fr.shadow_tri_world(ts.shadow, tc.shadow_visibility),
                       fr.shadow_tri_world(s.shadow, tc.shadow_visibility))
    for cfg in (rt.cfg, dataclasses.replace(rt.cfg, use_pallas=False)):
        a = fr.capacity_requirements(ts, tc, cfg)
        b = fr.capacity_requirements(s, tc, cfg)
        assert {k: int(v) for k, v in a.items()} == \
            {k: int(v) for k, v in b.items()}


def test_strip_and_attach_statics(config4):
    """strip_draw_statics drops every draw's tables, attach_draw_statics
    and DeviceScene.from_numpy put them back (unless asked not to)."""
    s = config4["rt"].device_scene
    bare = fr.strip_draw_statics(s)
    assert all(getattr(bare.opaque, k) is None for k in STATICS)
    assert bare.shadow.tri_posw_h is None and s.opaque.tri_rest is not None
    again = fr.attach_draw_statics(bare)
    for k in STATICS:
        assert torch.equal(getattr(again.opaque, k), getattr(s.opaque, k))
    leaves = _leaves(config4["js"])
    assert fr.DeviceScene.from_numpy(leaves, "cpu").opaque.tri_rest \
        is not None
    assert fr.DeviceScene.from_numpy(leaves, "cpu", attach_statics=False) \
        .opaque.tri_rest is None


@pytest.fixture(scope="module")
def fence():
    """The fence scene's renderers (textures patched), both scenes without
    the tables, and the port's frames and alpha merge with and without."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jren, "load_texture_chains", fence_chains)
    mp.setattr(tren, "load_texture_chains", fence_chains)
    try:
        scene, cfg, lights = jfence(alpha_test=True)
        rj = jren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                           lights=lights)
        tscene, tcfg, tlights = tsb.fence_scene(alpha_test=True)
        rt = tren.Renderer(tscene, dataclasses.replace(tcfg, **SMALL),
                           lights=tlights, device="cpu")
    finally:
        mp.undo()
    leaves = _leaves(rj.device_scene)
    rt.device_scene = fr.DeviceScene.from_numpy(leaves, "cpu")
    return dict(rj=rj, rt=rt, js=jax_without_statics(rj.device_scene),
                jc=rj.frame_constants(0.0), ts=scene_without_statics(leaves),
                tc=rt.frame_constants(0.0))


def test_fence_alpha_layer_without_statics(fence):
    """The alpha layer without tables: its shadow-punch inputs
    (alpha_shadow_geom) and its view triangles equal the JAX package's
    (eager) bit for bit, and the peel merged into the visibility buffer
    equals the one with the tables."""
    js, jc, ts, tc = (fence[k] for k in ("js", "jc", "ts", "tc"))
    cfg = fence["rt"].cfg
    with jax.disable_jit():
        jgeom = jfr.alpha_shadow_geom(js, jc)
        jtris, jattr = jfr.alpha_view_tris(js, jc, fence["rj"].cfg)
    tgeom = fr.alpha_shadow_geom(ts, tc)
    for name, a, b in zip(("tri_world", "uv", "mat"), tgeom, jgeom):
        _equal(a, b, name)
    ttris, tattr = fr.alpha_view_tris(ts, tc, cfg)
    _equal(tattr, jattr, "alpha tri_attr")
    for f in jtris._fields:
        _equal(getattr(ttris, f), getattr(jtris, f), f)
    for a, b in zip(tgeom, fr.alpha_shadow_geom(fence["rt"].device_scene,
                                                tc)):
        assert torch.equal(a, b)
    s = fence["rt"].device_scene
    tris, attr = fr.main_view_tris(s, tc, cfg)
    depth = torch.ones((cfg.height, cfg.width))
    tid = torch.full((cfg.height, cfg.width), -1, dtype=torch.int32)
    with_t = fr.alpha_merge_main(s, tc, cfg, depth, tid, tris, attr)
    without = fr.alpha_merge_main(ts, tc, cfg, depth, tid, tris, attr)
    assert (with_t[1] >= 0).any()
    for a, b in zip(with_t[:2], without[:2]):
        assert torch.equal(a, b)


def test_fence_frame_without_statics(fence):
    """The fence frame (alpha layer in the main view and punched into the
    shadow maps) without tables equals the frame with them."""
    rt, tc = fence["rt"], fence["tc"]
    got = fr.render_frame(fence["ts"], tc, rt.cfg)
    assert torch.equal(got, fr.render_frame(rt.device_scene, tc, rt.cfg))
