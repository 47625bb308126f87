"""The benchmark's point-light configuration (crychic-c3-pointlights:
BASELINE config 3, the deferred Blinn-Phong frame of the skull and grid
under 16 point lights) run through the harness on the CPU, at 160x96
with the small asset set:

- a traced run of the cell c3-static-q3 is correct, equal to the
  reference (max_abs 0.0) with no overflow, and reports
  stage_ms.direct_light;
- the program's side built with one point light fewer is not correct;
- scenes/pointlights.py hands both sides the same scene and lights, leaf
  for leaf, equal to the port's config3_deferred_pointlights;
- the frame trace's light_reach counts are the (light, covered pixel)
  pairs within each light's falloff_end, recounted from the resolved
  positions;
- profile_frame's stage chain, with the lighting's own stages, gives
  render_frame's image bit for bit for configs 3 and 5 (config 4's and
  the fence's are in test_torch_app.py and test_torch_fence.py).
"""
import dataclasses
import time

import pytest
import torch

from benchmark.harness import cell, sides, spec
from benchmark.scenes import synthetic_assets as sa
from crychic_renderer_tpu_torch.app import profiler
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_fence_config import _assert_same, _leaves
from torch_threads import cap_torch_threads

cap_torch_threads()

CELL = "c3-static-q3"
SMALL = dict(width=160, height=96, shadow_map_size=128)
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True)
def short_windows(monkeypatch):
    """The shortest window a run allows: one frame, the last, compared
    with the reference, one frame in the traced stretch, each stage
    timed once."""
    monkeypatch.setattr(cell, "COMPARED", 0)
    monkeypatch.setattr(cell, "STRETCH_FRAMES", 1)
    monkeypatch.setattr(cell, "STAGE_REPS", 1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The SMALL synthetic set, the port's REF_MODELS at its Models."""
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.SMALL, seed=SEED)
    mp = pytest.MonkeyPatch()
    mp.setattr(sb, "REF_MODELS", paths["models"])
    try:
        yield paths
    finally:
        mp.undo()


@pytest.fixture
def models(assets):
    return assets["models"]


def _run(traced=False):
    bench = spec.benchmark()
    return cell.run(bench, spec.workload(bench, CELL), SEED, 0.0, traced,
                    torch.device("cpu"), time.perf_counter(), size=SMALL)


def test_a_traced_run_is_correct_and_reads_the_light_loop():
    res, info = _run(traced=True)
    assert res["correct"] and res["failed"] == 0, (res["checks"], info)
    assert res["checks"]["max_abs"]["value"] == 0.0
    assert res["checks"]["overflow_flags"]["value"] == 0
    assert info["overflow"] is None
    assert res["metrics"]["stage_ms.direct_light"]["value"] > 0
    # no shadows: the shadow factor's stage is not run, so not read
    assert "stage_ms.shadow_factor" not in res["metrics"]


def test_one_point_light_fewer_fails(monkeypatch):
    real = sides.build

    def build(side, config, models_dir, size=None):
        scene, cfg, lights = real(side, config, models_dir, size)
        if side.Scene.__module__.startswith("crychic_renderer_tpu_torch"):
            cfg = dataclasses.replace(
                cfg, num_point_lights=cfg.num_point_lights - 1)
        return scene, cfg, lights

    monkeypatch.setattr(sides, "build", build)
    res, _ = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_abs"]["value"] > \
        res["checks"]["max_abs"]["limit"]
    assert res["checks"]["overflow_flags"]["value"] == 0


def test_both_sides_get_config3s_scene(models):
    from benchmark.scenes import pointlights

    port, ref = sides.program(), sides.reference()
    (ps, pl), (rs, rl) = (pointlights.build(port, models),
                          pointlights.build(ref, models))
    _assert_same(_leaves(ps), _leaves(rs))
    _assert_same(_leaves(pl), _leaves(rl), "lights")
    scene, cfg, lights = sb.config3_deferred_pointlights()
    _assert_same(_leaves(ps), _leaves(scene))
    _assert_same(_leaves(pl), _leaves(lights), "lights")
    bench = spec.benchmark()
    config = spec.config(bench, spec.workload(bench, CELL)["config"])
    for k, v in config["render"].items():
        assert getattr(cfg, k) == v, k
    assert ps.opaque.num_triangles == sa.SMALL.skull[1] + 59 * 39 * 2


def _covered_positions(r, consts):
    """(pos_w, valid) of the frame's G-buffer, resolved from its own
    raster."""
    cfg = r.cfg
    tris, attr = fr.main_view_tris(r.device_scene, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(r.device_scene, consts, cfg, tris, depth, tid,
                           attr)
    return g["pos_w"], g["valid"]


def test_light_reach_counts_the_lights_within_reach(models):
    scene, cfg, lights = sb.config3_deferred_pointlights()
    r = Renderer(scene, dataclasses.replace(cfg, **SMALL), lights=lights,
                 device="cpu", trace=True)
    want = []
    for i, turn in enumerate((0.0, 2.5)):
        r.camera.rotate_y(turn)
        pos_w, valid = _covered_positions(r, r.frame_constants(i / 30.0))
        pairs = 0
        for k in range(r.cfg.num_point_lights):
            lv = r.device_scene.light_position[k] - pos_w
            d = torch.sqrt((lv * lv).sum(-1))
            pairs += int(((d <= r.device_scene.light_falloff_end[k])
                          & valid).sum())
        want.append((pairs, int(valid.sum())))
        r.render(i / 30.0)
    rows = r.trace.rows()
    got = [(row.counts["light_reach_pairs"], row.counts["covered_pixels"])
           for row in rows]
    assert got == want
    # some lights reach some pixels, and not every light every pixel
    assert all(0 < p < 16 * n for p, n in got), got
    assert list(rows[0].stage_ms) == ["raster_main", "resolve_gbuffer",
                                      "direct_light", "lighting"]
    summary = profiler.trace_summary(rows, r.cfg)
    reach = sorted(100.0 * p / (16 * n) for p, n in got)
    assert summary["light_reach"] == pytest.approx(sum(reach) / 2)


@pytest.mark.parametrize("config", [3, 5])
def test_stage_chain_is_render_frame(config, assets):
    from test_torch_app import _profile_keys

    scene, cfg, lights = sb.CONFIGS[config]()
    r = Renderer(scene, dataclasses.replace(cfg, **SMALL), lights=lights,
                 device="cpu", asset_dir=assets["textures"],
                 sky_cubemap_path=assets["sky_cube"])
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    consts = r.frame_constants(0.1)
    img = profiler.run_stages(r.device_scene, consts, r.cfg, stage)
    assert torch.equal(img, fr.render_frame(r.device_scene, consts, r.cfg))
    skip = {"shadow_maps_x4": not r.cfg.shadows_enabled,
            "ssao": not r.cfg.ssao_enabled}
    assert names == [k for k in _profile_keys(r.cfg.shadows_enabled)[:-1]
                     if not skip.get(k)]
