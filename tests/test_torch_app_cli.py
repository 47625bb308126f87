"""The port's command-line tools (app/run, app/compare) against the JAX
package's, run with the same argv on the CPU.

- ``run --config 4 --small --frames 1 --stats``: both hand their Renderer
  the same RenderConfig (every field; 1/4 size, S // 4 maps, halved pair
  capacities), the port's frame is within the parity bound of the JAX
  frame (at most 0.5% of pixels whose max-RGB |diff| exceeds 0.02), and
  the --stats lines have the same keys in the same order and the same
  capacities. The JAX Renderer turns use_pallas off on a CPU backend
  (its XLA raster: 32-row tiles, a viewport per cascade, whose pair
  counts differ from the kernels'), so in this run the port's Renderer
  is handed use_pallas=False too.
- ``run --config 4 --small --frames 2 --orbit``: the camera turns before
  each timed frame in both; the port's last frame is within the parity
  bound of the JAX one and bit-equal to render_frame at the turned camera.
- ``compare``: --configs defaults to 1-5 in both, and --json-out writes
  the --parity report (indent=1) byte for byte as the JAX tool does; the
  exit code follows the report. --parity itself needs the card in the
  port, so its report stands in here (chip_smoke.py phase 28 checks the
  file against the printed report on the card).
"""
import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app import compare as jcompare
from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.app import run as jrun
from crychic_renderer_tpu_torch.app import compare, run
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_fullsize import assert_within_bound
from torch_threads import cap_torch_threads

cap_torch_threads()


def run_both(argv, out_dir, raster_as_jax=False):
    """JAX's and the port's run.main on the same argv (the port's with
    --device cpu): {"jax": ..., "port": ...}, each (the cfg handed to its
    Renderer, the Renderer, its last frame as clipped numpy, the printed
    lines). raster_as_jax: the port's Renderer takes use_pallas=False, as
    the JAX one does on the CPU."""
    made = {}

    def recording(base, key):
        class Recording(base):
            def __init__(self, scene, cfg, **kw):
                made[key] = (cfg, self)
                if key == "port" and raster_as_jax:
                    cfg = dataclasses.replace(cfg, use_pallas=False)
                super().__init__(scene, cfg, **kw)

            def render_np(self, total_time=0.0):
                self.last = super().render_np(total_time)
                return self.last

            def check_capacity(self, total_time=0.0):
                self.checked = getattr(self, "checked", []) + [total_time]
                return super().check_capacity(total_time)

        return Recording

    lines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jren, "Renderer", recording(jren.Renderer, "jax"))
        mp.setattr(tren, "Renderer", recording(tren.Renderer, "port"))
        mp.setattr(sys, "argv", ["run", *argv, "--out",
                                 str(out_dir / "jax.png")])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jrun.main()
        lines["jax"] = buf.getvalue().splitlines()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r, img = run.main([*argv, "--device", "cpu", "--out",
                               str(out_dir / "port.png")])
        lines["port"] = buf.getvalue().splitlines()
    assert made["port"][1] is r
    return {"jax": (*made["jax"], made["jax"][1].last, lines["jax"]),
            "port": (*made["port"], np.clip(img.numpy(), 0.0, 1.0),
                     lines["port"])}


@pytest.fixture(scope="module")
def small_stats(tmp_path_factory):
    return run_both(["--config", "4", "--small", "--frames", "1", "--stats"],
                    tmp_path_factory.mktemp("small"), raster_as_jax=True)


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    return run_both(["--config", "4", "--small", "--frames", "2",
                     "--orbit"], tmp_path_factory.mktemp("orbit"))


def test_small_hands_the_renderer_the_jax_config(small_stats):
    jcfg, tcfg = small_stats["jax"][0], small_stats["port"][0]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.width, tcfg.height, tcfg.shadow_map_size) == (480, 270, 512)


def test_small_frame_within_the_parity_bound(small_stats):
    _, _, ref, _ = small_stats["jax"]
    _, r, img, _ = small_stats["port"]
    assert img.shape == (r.cfg.height, r.cfg.width, 4) == (270, 480, 4)
    assert_within_bound(ref, img, "--small")


def test_stats_line_as_jax(small_stats):
    jline = json.loads(small_stats["jax"][3][-1])
    tline = json.loads(small_stats["port"][3][-1])
    assert list(tline) == list(jline) == [
        "ms_per_frame", "fps", "config", "capacity", "pair_capacity",
        "shadow_pair_capacity"]
    assert list(tline["capacity"]) == list(jline["capacity"])
    for k in ("config", "capacity", "pair_capacity", "shadow_pair_capacity"):
        assert tline[k] == jline[k], k
    for k in jline:
        assert type(tline[k]) is type(jline[k]), k


def test_stats_checks_the_capacities_as_jax(small_stats):
    """--stats calls check_capacity(0.0) (which raises on overflow) in
    both."""
    assert small_stats["jax"][1].checked == small_stats["port"][1].checked \
        == [0.0]


def test_orbit_moves_the_camera_as_jax(orbit):
    _, rj, ref, _ = orbit["jax"]
    _, rt, img, _ = orbit["port"]
    np.testing.assert_array_equal(rt.camera.view, rj.camera.view)
    default = tren.Renderer._default_camera(rt)
    assert not np.array_equal(rt.camera.view, default.view)
    assert_within_bound(ref, img, "--orbit")


def test_orbit_frame_equals_render_frame_at_the_turned_camera(orbit):
    _, rt, img, _ = orbit["port"]
    t = 1 / 60.0  # the last of 2 timed frames
    want = fr.render_frame(rt.device_scene, rt.frame_constants(t), rt.cfg)
    assert torch.equal(torch.from_numpy(img),
                       torch.clamp(want, 0.0, 1.0))


@pytest.mark.parametrize("ok", [True, False])
def test_compare_defaults_and_json_out_as_jax(tmp_path, monkeypatch, ok):
    """compare --parity --json-out with each package's parity() replaced
    by one report: both tools ask for configs 1-5 by default, print the
    report, write it with indent=1 (the same bytes), and exit 0 exactly
    when it is ok."""
    report = {1: {"max": 0.5, "mean": 1e-4, "frac_gt_2pct": 0.001,
                  "ok": True}, "ok": ok}
    asked = {}

    def parity(key):
        def fake(configs, small, *device):
            asked[key] = (list(configs), small)
            return dict(report)

        return fake

    monkeypatch.setattr(jcompare, "parity", parity("jax"))
    monkeypatch.setattr(compare, "parity", parity("port"))
    monkeypatch.setattr(sys, "argv", ["compare", "--parity", "--json-out",
                                      str(tmp_path / "jax.json")])
    printed = {}
    for key, call in (
            ("jax", jcompare.main),
            ("port", lambda: compare.main(
                ["--parity", "--json-out", str(tmp_path / "port.json")]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                pytest.raises(SystemExit) as ex:
            call()
        assert ex.value.code == (0 if ok else 1)
        printed[key] = buf.getvalue().splitlines()[-1]
    assert asked["port"] == asked["jax"] == ([1, 2, 3, 4, 5], False)
    assert printed["port"] == printed["jax"]
    jbytes = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == jbytes
    assert json.loads(jbytes) == json.loads(printed["port"])


def test_compare_parity_json_out_refuses_the_cpu(tmp_path):
    """The port's --parity holds the card's frame against the CPU path, so
    on the CPU it raises before it writes anything."""
    out = tmp_path / "parity.json"
    with pytest.raises(ValueError, match="not a CUDA device"):
        compare.main(["--parity", "--small", "--configs", "4", "--device",
                      "cpu", "--json-out", str(out)])
    assert not out.exists()
