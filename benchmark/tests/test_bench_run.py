"""Runs of the harness on the CPU at a small size (160x96, 128^2 maps,
the small asset set): a sound run is correct; a run whose timed path is
broken underneath (a frame altered where it is produced, a frame that
returns the previous state unchanged, a dropped-geometry flag) is not;
the command prints no result without a card; the reference loads no
module of the port."""
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cell, spec

SMALL = dict(width=160, height=96, shadow_map_size=128)
SEED = 2 ** 31 + 3
ROOT = spec.REPO_ROOT


@pytest.fixture(autouse=True)
def short_windows(monkeypatch):
    """Compare frames the few frames of a CPU window hold."""
    monkeypatch.setattr(cell, "SAMPLE_BELOW", 2)
    monkeypatch.setattr(cell, "STRETCH_FRAMES", 2)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


def _run(workload, seconds=3.0, traced=False):
    bench = spec.benchmark(ROOT)
    return cell.run(bench, spec.workload(bench, workload), SEED, seconds,
                    traced, torch.device("cpu"), time.perf_counter(),
                    size=SMALL)


def _turning(monkeypatch):
    """A four-pose turn (90 degrees a frame) in place of the static mix."""
    real = spec.traffic

    def traffic(name, bench_dir=spec.BENCH_DIR):
        mix = dict(real(name, bench_dir))
        mix.update(turn_deg_per_frame=90.0, period_frames=4,
                   walk_capacities=True)
        return mix

    monkeypatch.setattr(spec, "traffic", traffic)


def test_a_sound_run_is_correct():
    res, info = _run("c4-static-q1")
    assert res["correct"] and res["failed"] == 0, (res["checks"], info)
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_abs"]["value"] == 0.0
    assert res["attempted"] == info["frames"] >= 3


def test_a_traced_run_reports_its_per_layer_metrics():
    res, _ = _run("c4soft-static-q3", traced=True)
    assert res["correct"]
    # no device trace on the CPU: the device's metrics are left out
    assert {"issue_ms", "stage_ms.resolve", "stage_ms.ssao"} <= \
        set(res["metrics"])
    assert "idle_share" not in res["metrics"]
    assert "roofline.k6" not in res["metrics"]


def test_a_frame_altered_where_it_is_produced_fails(monkeypatch):
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    real = Renderer.render

    def render(self, total_time=0.0):
        img = real(self, total_time).clone()
        img[:8, :8, 0] += 0.05
        return img

    monkeypatch.setattr(Renderer, "render", render)
    res, _ = _run("c4-static-q1")
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["max_abs"]["value"] > \
        res["checks"]["max_abs"]["limit"]


def test_a_frame_that_returns_its_state_unchanged_fails(monkeypatch):
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    _turning(monkeypatch)
    real = Renderer.render
    first = {}

    def render(self, total_time=0.0):
        img = real(self, total_time)
        return first.setdefault("img", img)

    monkeypatch.setattr(Renderer, "render", render)
    res, _ = _run("c4-static-q1", seconds=4.0)
    assert not res["correct"]


def test_the_same_turn_unbroken_is_correct(monkeypatch):
    _turning(monkeypatch)
    res, info = _run("c4-static-q1", seconds=4.0)
    assert res["correct"], (res["checks"], info)


def test_dropped_geometry_fails_every_frame(monkeypatch):
    from crychic_renderer_tpu_torch.app.renderer import Renderer

    def check_overflow(self):
        raise RuntimeError("main raster overflow")

    monkeypatch.setattr(Renderer, "check_overflow", check_overflow)
    res, _ = _run("c4-static-q1")
    assert not res["correct"] and res["failed"] == res["attempted"]


def _no_result(stdout):
    for line in stdout.strip().splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


@pytest.mark.parametrize("reader_loads_jax", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(monkeypatch, tmp_path,
                                                   capsys, reader_loads_jax):
    """Every per-layer reader runs after the window; one that loads a
    stand-in `jax` there leaves the run without a result line."""
    from benchmark import run

    stand_in = "jax"
    (tmp_path / stand_in).mkdir()
    (tmp_path / stand_in / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    real = spec.metric_reader

    def metric_reader(name, bench_dir=spec.BENCH_DIR):
        read = real(name, bench_dir)

        def loading(data):
            if reader_loads_jax:
                importlib.import_module(stand_in)
            return read(data)
        return loading

    monkeypatch.setattr(spec, "metric_reader", metric_reader)
    assert stand_in not in sys.modules
    try:
        res, info = _run("c4-static-q1", traced=True)
        rc = run.report(res, info)
    finally:
        sys.modules.pop(stand_in, None)
    out, err = capsys.readouterr()
    if reader_loads_jax:
        assert rc != 0 and _no_result(out)
        assert "holds JAX" in err and stand_in in err
    else:
        assert rc == 0 and json.loads(out.strip().splitlines()[-1])["correct"]


def test_the_command_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "c4-static-q1",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc.stdout)


def test_the_command_prints_no_result_beside_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "c4-static-q1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc.stdout)


def test_the_reference_loads_no_module_of_the_port():
    code = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from benchmark.harness import sides, traffic, spec
from benchmark.reference.render import ReferenceFrame
side = sides.reference()
config = spec.config(spec.benchmark(sys.argv[1]), "crychic-c4-shadows",
                     sys.argv[1])
scene, cfg, lights = sides.build(side, config, None,
                                 dict(width=64, height=32, shadow_map_size=64))
ref = ReferenceFrame(scene, cfg, lights, torch.device("cpu"))
tr = traffic.from_spec(spec.traffic("static-q1"), 5)
img = ref.render(traffic.camera(side.Camera, tr, tr.pose(0), 2.0), 0.0)
assert img.shape == (32, 64, 4)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    proc = subprocess.run([sys.executable, "-c", code, ROOT],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tops = proc.stdout.strip().splitlines()[-1]
    for name in ("crychic_renderer_tpu_torch", "crychic_renderer_tpu",
                 "jax"):
        assert f"'{name}'" not in tops
