"""The port's forward path and Blinn-Phong lighting against the JAX
package's render_frame, whole frames.

Each case renders once per module: the JAX Renderer's jitted frame (its
CPU path: the XLA raster) and the port's Renderer on the CPU from the
JAX scene's leaves and identical frame constants, as
tests/test_torch_frame.py does. Bound: at most 0.5% of pixels with a
max-RGB |diff| above 0.02 (app/compare.py's parity bound). The cases:

- config 1 at 1/8 size (100x75): forward PBR with the sky, no shadows;
  the shininess comes from the normal map's alpha;
- config 4 at 1/8 size with deferred=False, use_pbr=False: config 2's
  lighting model (Blinn-Phong, 3 directional lights) with the shadow
  atlas, the forward cascade blend and the ShadowDebug quad;
- config 3's settings and 16-point-light rig on config 4's scene at 1/8
  size (deferred Blinn-Phong; the skull is absent here).

Measured: 0% of pixels above 0.02 in all three; max |diff| 6.3e-5,
9.6e-3 (a few shadow-edge pixels of the forward blend) and 8.3e-6.
"""
import dataclasses
import os

import numpy as np
import pytest

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu.models.materials import Lights as JLights
from crychic_renderer_tpu_torch.app import profiler, run
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()


def _config1(cfg):
    return dataclasses.replace(cfg, width=cfg.width // 8,
                               height=cfg.height // 8)


def _forward_blinn_phong(cfg):
    return dataclasses.replace(_small(cfg), deferred=False, use_pbr=False)


def _jax_config3_rig():
    """Config 3's settings and light rig on the JAX package's config-4
    scene (its config-3 builder needs the skull); the rig is the port's,
    field for field."""
    scene, cfg, _ = jsb.config4_shadow_pipeline()
    cfg = dataclasses.replace(cfg, deferred=True, use_pbr=False,
                              shadows_enabled=False, ssao_enabled=False,
                              num_dir_lights=0, num_point_lights=16)
    rig = tsb.point_light_rig()
    return scene, cfg, JLights(**{f.name: getattr(rig, f.name)
                                  for f in dataclasses.fields(JLights)})


# case -> (JAX builder, port builder, the cfg edit both get)
CASES = {
    "config1": (jsb.config1_woodcrate, tsb.config1_woodcrate, _config1),
    "config4_forward_blinn_phong": (jsb.config4_shadow_pipeline,
                                    tsb.config4_shadow_pipeline,
                                    _forward_blinn_phong),
    "config3_rig": (_jax_config3_rig, tsb.config3_rig_on_config4, _small),
}


def _build(case):
    jmake, tmake, edit = CASES[case]
    scene, cfg, lights = jmake()
    rj = JRenderer(scene, edit(cfg), lights=lights)
    tscene, tcfg, tlights = tmake()
    rt = Renderer(tscene, edit(tcfg), lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    return rj, rt


@pytest.fixture(scope="module", params=sorted(CASES))
def frames(request):
    rj, rt = _build(request.param)
    return request.param, rj, rt, rj.render_np(0.0), rt.render_np(0.0)


def test_frame_matches_jax(frames):
    case, rj, rt, ref, got = frames
    assert got.shape == ref.shape == (rt.cfg.height, rt.cfg.width, 4)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, (f"{case}: {frac:.4%} of pixels >0.02 "
                               f"(max {diff.max():.4f})")
    rt.check_overflow()


def test_forward_shadow_quad(frames):
    """The forward path with shadows draws the ShadowDebug quad (cascade
    3 blitted into the bottom-right quadrant); the other cases do not."""
    case, _, rt, _, got = frames
    cfg = rt.cfg
    consts = rt.frame_constants(0.0)
    H, W = cfg.height, cfg.width
    quad = got[H - H // 2:, W - W // 2:]
    if case == "config4_forward_blinn_phong":
        maps = fr.render_shadow_atlas(rt.device_scene,
                                      consts.shadow_visibility,
                                      consts.cascade_view_projs, cfg)
        S = cfg.shadow_map_size
        ys = np.arange(H // 2) * S // (H // 2)
        xs = np.arange(W // 2) * S // (W // 2)
        blit = maps[3].numpy()[ys[:, None], xs[None, :]]
        np.testing.assert_array_equal(quad[..., 0], np.clip(blit, 0, 1))
        assert (quad[..., 0] == quad[..., 2]).all()
    else:
        assert not (quad[..., 0] == quad[..., 2]).all()


def test_profile_frame_keys(frames):
    """profile_frame reports these frames with the JAX profiler's keys
    and the lighting's two stages (test_torch_app._profile_keys), and
    its chained stages give render_frame's image bit for bit."""
    from test_torch_app import _profile_keys

    _, _, rt, _, got = frames
    report = profiler.profile_frame(rt, reps=1)
    skip = {"shadow_maps_x4": not rt.cfg.shadows_enabled,
            "ssao": not rt.cfg.ssao_enabled}
    assert list(report) == [k for k in _profile_keys(rt.cfg.shadows_enabled)
                            if not skip.get(k)]
    img = profiler.run_stages(rt.device_scene, rt.frame_constants(0.0),
                              rt.cfg, lambda name, fn: fn())
    np.testing.assert_array_equal(np.clip(img.numpy(), 0, 1), got)


def test_run_config1(tmp_path, capsys):
    """app/run renders config 1 (the forward path) on the CPU."""
    out = str(tmp_path / "config1.png")
    run.main(["--config", "1", "--device", "cpu", "--small", "--frames",
              "1", "--out", out])
    assert os.path.getsize(out) > 0
    assert "ms/frame" in capsys.readouterr().out
