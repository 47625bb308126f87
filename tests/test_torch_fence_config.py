"""The benchmark's fence configuration (crychic-c4-fence: config 4's
cascade scene with two wire-fence crates in its AlphaTested layer) run
through the harness on the CPU, at 160x96 with 128^2 maps and the small
asset set, whose WireFence.dds has holes that fail the clip:

- a traced run of the cell c4fence-static-q3 is correct, equal to the
  reference (max_abs 0.0) with no overflow, and reports the two
  alpha-layer stages it lists;
- the same cell with the punch window shrunk below the layer's
  light-space extent is not correct, and the overflow names the window;
- scenes/fence.py hands both sides the same scene, leaf for leaf.

Each run renders a handful of config-4 frames on the CPU (the shadow
atlas of 81,402 triangles is most of a frame's time), so the window is
as short as a run allows.
"""
import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, sides, spec
from torch_threads import cap_torch_threads

cap_torch_threads()

CELL = "c4fence-static-q3"
SMALL = dict(width=160, height=96, shadow_map_size=128)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def short_windows(monkeypatch):
    """The shortest window a run allows: one frame, the last, compared
    with the reference, one frame in the traced stretch, each stage
    timed once."""
    monkeypatch.setattr(cell, "COMPARED", 0)
    monkeypatch.setattr(cell, "STRETCH_FRAMES", 1)
    monkeypatch.setattr(cell, "STAGE_REPS", 1)


def _run(traced=False, **size):
    bench = spec.benchmark()
    return cell.run(bench, spec.workload(bench, CELL), SEED, 0.0, traced,
                    torch.device("cpu"), time.perf_counter(),
                    size=dict(SMALL, **size))


def _extent():
    """The layer's widest light-space extent at the cell's pose and the
    small size (the port's capacity_requirements)."""
    from benchmark.harness import traffic as traffic_mod
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    bench = spec.benchmark()
    config = spec.config(bench, spec.workload(bench, CELL)["config"])
    port = sides.program()
    scene, cfg, lights = sides.build(port, config, None, SMALL)
    tr = traffic_mod.from_spec(spec.traffic("static-q3"), SEED)
    cam = traffic_mod.camera(port.Camera, tr, tr.pose(0),
                             cfg.width / cfg.height)
    r = Renderer(scene, cfg, camera=cam, lights=lights, asset_dir="",
                 auto_capacity=False, device="cpu")
    return r.capacity_requirements(0.0)["alpha_window"]


def test_a_traced_run_is_correct_and_reads_the_alpha_stages():
    res, info = _run(traced=True)
    assert res["correct"] and res["failed"] == 0, (res["checks"], info)
    assert res["checks"]["max_abs"]["value"] == 0.0
    assert res["checks"]["overflow_flags"]["value"] == 0
    assert info["overflow"] is None
    assert {"stage_ms.alpha_merge_main", "stage_ms.alpha_merge_shadow"} <= \
        set(res["metrics"])
    assert all(res["metrics"][k]["value"] > 0 for k in (
        "stage_ms.alpha_merge_main", "stage_ms.alpha_merge_shadow"))


def test_a_window_short_of_the_layer_fails_and_names_it():
    extent = _extent()
    assert 0 < extent < SMALL["shadow_map_size"]
    res, info = _run(alpha_shadow_window=extent - 1)
    assert not res["correct"], res["checks"]
    assert res["checks"]["overflow_flags"]["value"] == 1
    assert res["failed"] == res["attempted"]
    assert "alpha_shadow_window" in info["overflow"]
    assert "alpha shadow window overflow" in info["overflow"]


def _leaves(obj):
    """A scene (or any nest of dataclasses, lists and arrays) as nested
    plain values: arrays as numpy, dataclasses by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_leaves(v) for v in obj]
    if isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj)
    return obj


def _assert_same(a, b, where="scene"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def test_both_sides_get_the_same_scene():
    from benchmark.scenes import fence

    port, ref = sides.program(), sides.reference()
    (ps, pl), (rs, rl) = fence.build(port), fence.build(ref)
    _assert_same(_leaves(ps), _leaves(rs))
    _assert_same(_leaves(pl), _leaves(rl), "lights")
    layer = importlib.import_module(port.Scene.__module__).LAYER_ALPHA_TESTED
    alpha = [i for i in ps.items if i.layer == layer]
    assert [i.num_instances for i in alpha] == [2]
    assert ps.alpha.indices.shape == (2 * 36,)
    assert ps.texture_names[10:] == ["WireFence", "default_nmap"]
