"""The port's alpha-tested layer against the JAX package's, whole frames:
fence_scene (two wire-fence boxes over a tiled floor, one directional
light, 4 cascades) at 160x90 with 128^2 maps and a 64^2 punch window.

WireFence.dds is absent here and a missing asset is a white 1x1, which
passes every clip; both packages' load_texture_chains are patched to
give the fence the same synthetic wire grid with holes
(models.scenes_baseline.wire_fence_chain). Each frame renders once per
module: the JAX Renderer's jitted frame (its CPU path) and the port's
Renderer on the CPU from the JAX scene's leaves. Bound: at most 0.5% of
pixels with a max-RGB |diff| above 0.02; measured 0% (max 1.1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models.scenes_baseline import fence_scene as jfence
from crychic_renderer_tpu_torch.app import profiler
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves
from torch_threads import cap_torch_threads

cap_torch_threads()

SMALL = dict(width=160, height=90, shadow_map_size=128,
             alpha_shadow_window=64)


def fence_chains(names, asset_dir=None):
    """load_texture_chains with the synthetic wire grid in the WireFence
    slot and white 1x1 chains elsewhere (both packages' fallback)."""
    white = [np.full((1, 1, 4), 255, np.uint8)]
    return [tsb.wire_fence_chain() if n == "WireFence" else white
            for n in names], {}


def fence_renderers(alpha_test=True, **over):
    """(JAX Renderer, port Renderer on the CPU with the JAX scene's
    leaves) of the fence scene at SMALL size, textures patched by the
    caller."""
    scene, cfg, lights = jfence(alpha_test=alpha_test)
    rj = jren.Renderer(scene, dataclasses.replace(cfg, **SMALL, **over),
                       lights=lights)
    tscene, tcfg, tlights = tsb.fence_scene(alpha_test=alpha_test)
    rt = tren.Renderer(tscene, dataclasses.replace(tcfg, **SMALL, **over),
                       lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    return rj, rt


@pytest.fixture(scope="module")
def fence():
    mp = pytest.MonkeyPatch()
    mp.setattr(jren, "load_texture_chains", fence_chains)
    mp.setattr(tren, "load_texture_chains", fence_chains)
    try:
        rj, rt = fence_renderers()
        scene, cfg, lights = _opaque_fence()
        opaque = tren.Renderer(scene, cfg, lights=lights, device="cpu")
        yield dict(rj=rj, rt=rt, ref=rj.render_np(0.0), got=rt.render_np(0.0),
                   opaque=opaque.render_np(0.0))
    finally:
        mp.undo()


def _opaque_fence():
    scene, cfg, lights = tsb.fence_scene(alpha_test=False)
    return scene, dataclasses.replace(cfg, **SMALL), lights


def test_fence_frame_matches_jax(fence):
    ref, got = fence["ref"], fence["got"]
    assert got.shape == ref.shape == (90, 160, 4)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, (f"{frac:.4%} of pixels >0.02 (max "
                               f"{diff.max():.4f})")
    fence["rt"].check_overflow()


def test_fence_has_holes(fence):
    """Against the same fence drawn opaque: the holes show the floor, the
    sky and the far fence in the main view, and let light through onto
    the floor (punching can only add light)."""
    got, opaque = fence["got"][..., :3], fence["opaque"][..., :3]
    changed = np.abs(got - opaque).max(-1) > 0.05
    assert 0.02 < changed.mean() < 0.8, changed.mean()
    floor = slice(2 * got.shape[0] // 3, None)
    assert (got[floor] - opaque[floor]).mean() > 0.001


def test_fence_shadow_punch(fence):
    """The punched maps hold the fence's passing fragments only: every
    punched texel is nearer than the opaque atlas, and the punch leaves
    holes (texels the fence's box covers that stay at the floor's
    depth)."""
    rt = fence["rt"]
    s, c, cfg = rt.device_scene, rt.frame_constants(0.0), rt.cfg
    maps = fr.render_shadow_atlas(s, c.shadow_visibility,
                                  c.cascade_view_projs, cfg)
    punched = fr.alpha_merge_shadow(s, c, cfg, maps)
    assert bool((punched <= maps).all())
    nearer = punched < maps
    assert int(nearer.sum()) > 50
    tw, uv, mat = fr.alpha_shadow_geom(s, c)
    _, aid, _, _ = fr.alpha_punch_window(s, cfg, tw, uv, mat,
                                         c.cascade_view_projs[0])
    solid = fr.alpha_punch_window(
        s, dataclasses.replace(cfg, alpha_clip=-1.0), tw, uv, mat,
        c.cascade_view_projs[0])[1]
    assert int((aid >= 0).sum()) < int((solid >= 0).sum())


def test_punch_window_short_of_the_layer_is_flagged(fence):
    """At fence_scene's own size (512^2 maps), a punch window one texel
    short of the layer's widest light-space extent sets the frame's
    alpha_window_overflowed flag and a window of the extent leaves it
    clear; the flag reaches check_overflow, which names the window."""
    scene, cfg, lights = tsb.fence_scene()
    r = tren.Renderer(scene, cfg, lights=lights, device="cpu")
    extent = r.capacity_requirements(0.0)["alpha_window"]
    assert 0 < extent <= cfg.alpha_shadow_window < cfg.shadow_map_size
    s, c = r.device_scene, r.frame_constants(0.0)
    maps = torch.ones((cfg.num_cascades, cfg.shadow_map_size,
                       cfg.shadow_map_size))
    for window, flagged in ((extent - 1, True), (extent, False)):
        stats, occ = {}, {}
        fr.alpha_merge_shadow(s, c, dataclasses.replace(
            r.cfg, alpha_shadow_window=window), maps, stats, occ)
        assert bool(stats["alpha_window_overflowed"]) == flagged, window
        assert int(occ["alpha_window"]) == extent
    rt = fence["rt"]
    small = rt.capacity_requirements(0.0)["alpha_window"]
    saved = rt.cfg
    try:
        rt.cfg = dataclasses.replace(saved, alpha_shadow_window=small - 1)
        rt.render(0.0)
        with pytest.raises(RuntimeError, match="alpha_shadow_window"):
            rt.check_overflow()
        rt.cfg = dataclasses.replace(saved, alpha_shadow_window=small)
        rt.render(0.0)
        rt.check_overflow()
    finally:
        rt.cfg = saved


def test_profile_frame_alpha_stages(fence):
    """profile_frame reports the alpha merge as its own stages, after the
    stages whose outputs they merge into; the chained stages give
    render_frame's image bit for bit."""
    from test_torch_app import _profile_keys

    rt = fence["rt"]
    report = profiler.profile_frame(rt, reps=1)
    want = [k for k in _profile_keys() if k != "ssao"]
    want.insert(want.index("raster_main") + 1, "alpha_merge_main")
    want.insert(want.index("shadow_maps_x4") + 1, "alpha_merge_shadow")
    assert list(report) == want
    assert all(v > 0 for v in report.values())
    consts = rt.frame_constants(0.0)
    img = profiler.run_stages(rt.device_scene, consts, rt.cfg,
                              lambda name, fn: fn())
    assert torch.equal(img, fr.render_frame(rt.device_scene, consts, rt.cfg))


def test_alpha_test_without_an_alpha_draw_is_off():
    """alpha_test_enabled with no alpha draw in the scene counts as off,
    as in the JAX package (frame.py:1430): the frame equals the one
    without it."""
    scene, cfg, lights = _opaque_fence()
    r = tren.Renderer(scene, cfg, lights=lights, device="cpu")
    assert r.device_scene.alpha is None
    consts = r.frame_constants(0.0)
    on = fr.render_frame(r.device_scene, consts,
                         dataclasses.replace(r.cfg, alpha_test_enabled=True))
    assert torch.equal(on, fr.render_frame(r.device_scene, consts, r.cfg))
