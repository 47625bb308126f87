"""The port's app layer (app/profiler, app/renderer's resize and capacity
checks) on the CPU; the viewer and the other app tools are in
test_torch_viewer.py.

Config 4 at 160x90 with 128^2 shadow maps keeps each frame under a second
here. Tolerances: none, where both sides run the same torch functions
(the profiler's stage chain against render_frame, a resized Renderer
against a fresh one).
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app import profiler
from crychic_renderer_tpu_torch.app.renderer import CapacityError, Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _renderer(width=160, height=90):
    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=width, height=height,
                              shadow_map_size=128)
    return Renderer(scene, cfg, lights=lights, device="cpu")


@pytest.fixture(scope="module")
def renderer():
    """One config-4 Renderer for the tests that leave it as it is."""
    return _renderer()


def _jax_profiler_keys():
    with open(os.path.join(REPO, "crychic_renderer_tpu", "app",
                           "profiler.py")) as f:
        return list(dict.fromkeys(re.findall(r'report\["(\w+)"\]', f.read())))


def _profile_keys(shadows: bool = True):
    """profile_frame's keys: the JAX profiler's, with the two stages its
    lighting holds timed alone before lighting, shadow_factor (with
    shadows on) and direct_light."""
    keys = _jax_profiler_keys()
    at = keys.index("lighting")
    return (keys[:at] + ["shadow_factor"] * shadows + ["direct_light"]
            + keys[at:])


def test_profile_frame_reports_every_stage(renderer):
    report = profiler.profile_frame(renderer, reps=1)
    assert list(report) == _profile_keys()
    assert all(np.isfinite(v) and v > 0 for v in report.values()), report


def test_stage_chain_is_render_frame(renderer):
    """The profiler's stages, chained, give render_frame's image bit for
    bit, in the JAX profiler's stage order with the lighting's two
    stages before lighting."""
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    consts = renderer.frame_constants(0.0)
    img = profiler.run_stages(renderer.device_scene, consts, renderer.cfg,
                              stage)
    want = fr.render_frame(renderer.device_scene, consts, renderer.cfg)
    assert torch.equal(img, want)
    assert names == _profile_keys()[:-1]


def test_resize_equals_fresh_renderer():
    r = _renderer()
    r.resize(128, 72)
    fresh = _renderer(128, 72)
    assert r.cfg == fresh.cfg
    assert torch.equal(r.device_scene.ssao_random_field,
                       fresh.device_scene.ssao_random_field)
    np.testing.assert_array_equal(r.render_np(0.0), fresh.render_np(0.0))


def _outrun_crippled(r):
    """tests/test_capacity.py's pose: the capacity cut to 16 pairs."""
    r.cfg = dataclasses.replace(r.cfg, pair_capacity=16)
    return "main raster overflow"


def _outrun_walk(r):
    """Capacities sized exactly for the start pose, then the camera looks
    down at the scene from closer in: the atlas expands more pairs."""
    req = r.capacity_requirements(0.0)
    r.cfg = dataclasses.replace(r.cfg, pair_capacity=req["main_pairs"],
                                shadow_pair_capacity=req["shadow_pairs"])
    r.camera.look_at((0.0, 1.0, -6.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    return "shadow raster overflow"


@pytest.mark.parametrize("outrun", [_outrun_crippled, _outrun_walk])
def test_check_capacity_raises_and_ensure_capacity_grows(outrun):
    r = _renderer()
    r.check_capacity(0.0)
    match = outrun(r)
    with pytest.raises(CapacityError, match=match):
        r.check_capacity(0.0)
    req = r.ensure_capacity(0.0)
    assert r.cfg.pair_capacity >= req["main_pairs"]
    assert r.cfg.shadow_pair_capacity >= req["shadow_pairs"]
    assert r.check_capacity(0.0) == req
    r.render(0.0)
    r.check_overflow()
