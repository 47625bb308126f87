"""The port's viewer and app tools (app/viewer, the Renderer's viewer
step, app/stats, app/compare, utils/gametimer) on the CPU, against the
JAX package where it has a counterpart.

Config 4 at 160x90 with 128^2 shadow maps (test_torch_app.py's
renderer). Tolerances: none where both sides run the same host code
(camera moves, captions, image statistics); the viewer's display image is
within 1 of the downsampled frame, as in the JAX package's test
(rounding of x * 255 + 0.5).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app import compare, viewer
from test_torch_app import REPO, _renderer
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def renderer():
    return _renderer()


def test_viewer_step_fn_display_and_capacity(renderer):
    """The display image is the full render downsampled (within 1), and
    the pair and tile counts are capacity_requirements' exact ones."""
    step = renderer.viewer_step_fn(16, 32)
    disp, *counts = step(renderer.device_scene,
                         renderer.frame_constants(0.0))
    assert disp.shape == (16, 32, 3) and disp.dtype == torch.uint8
    req = renderer.capacity_requirements(0.0)
    assert [int(c) for c in counts] == [
        req[k] for k in ("main_pairs", "shadow_pairs", "shade_tiles",
                         "ssao_tiles")]
    full = renderer.render_np(0.0)
    ys = np.linspace(0, 89, 16).astype(int)
    xs = np.linspace(0, 159, 32).astype(int)
    want = (np.clip(full[ys][:, xs, :3], 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.abs(disp.numpy().astype(int) - want.astype(int)).max() <= 1


def test_apply_keys_moves_the_camera_as_jax():
    from crychic_renderer_tpu.app import viewer as jviewer
    from crychic_renderer_tpu.models.camera import Camera as JCamera
    from crychic_renderer_tpu_torch.models.camera import Camera

    cams = []
    for cls in (JCamera, Camera):
        cam = cls()
        cam.set_position(0.0, 2.0, -15.0)
        cam.set_lens(0.25 * np.pi, 4 / 3, 1.0, 100.0)
        cams.append(cam)
    for keys, dt in (("w", 0.5), ("wasd", 0.1), ("ijkl", 0.2), ("lli", 0.0),
                     ("xq", 0.1)):
        going = [apply(cam, keys, dt) for apply, cam in
                 zip((jviewer.apply_keys, viewer.apply_keys), cams)]
        assert going[0] == going[1] == ("q" not in keys)
        for name in ("position", "look", "right", "up", "view"):
            np.testing.assert_array_equal(getattr(cams[0], name),
                                          getattr(cams[1], name), name)


def test_host_helpers_match_jax():
    from crychic_renderer_tpu.app import compare as jcompare
    from crychic_renderer_tpu.app import viewer as jviewer
    from crychic_renderer_tpu.app.stats import FrameStats as JFrameStats
    from crychic_renderer_tpu_torch.app.stats import FrameStats

    captions = []
    for cls in (JFrameStats, FrameStats):
        s = cls()
        s.fps, s.mspf = 59.6, 16.7749
        s.visible_instances, s.total_instances = 45, 101
        captions.append(s.caption())
    assert captions[0] == captions[1]

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (9, 14, 4)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.02, a.shape), 0, 1).astype(np.float32)
    assert compare.stats(a) == jcompare.stats(a)
    assert compare.compare(a, b) == jcompare.compare(a, b)
    for h, w, cols in ((1080, 1920, 120), (90, 160, 120), (72, 128, 40)):
        assert viewer.display_dims(h, w, cols) == jviewer.display_dims(
            h, w, cols)
    for img in (a, (a * 255).astype(np.uint8)):
        assert viewer.ansi_frame(img, 8) == jviewer.ansi_frame(img, 8)


def test_viewer_pause_freezes_total_time():
    """tests/test_app.py's pause test on the port's GameTimer: space
    toggles stop/start, and time spent stopped does not count."""
    from crychic_renderer_tpu_torch.utils.gametimer import GameTimer

    t = GameTimer()
    t.reset()
    time.sleep(0.05)
    tick_at = time.perf_counter()
    t.tick()
    t0 = t.total_time()
    t.stop()
    stop_at = time.perf_counter()
    time.sleep(0.05)
    t.tick()
    frozen = t.total_time()
    assert t0 <= frozen + 1e-9
    assert frozen - t0 <= stop_at - tick_at + 1e-3
    before_start = time.perf_counter()
    t.start()
    time.sleep(0.02)
    t.tick()
    after_tick = time.perf_counter()
    assert t.total_time() > frozen
    assert t.total_time() <= frozen + (after_tick - before_start) + 1e-6


def test_viewer_scripted_loop(tmp_path, capsys):
    """Config 4 at 320x180 (fast preset, --small), 4 scripted frames with
    frames in flight: one caption per frame, a screenshot on 'p', no
    overflow."""
    out = str(tmp_path / "shot.png")
    frames = viewer.main(["--config", "4", "--small", "--script", "wwlp",
                          "--no-draw", "--device", "cpu", "--out", out])
    assert frames == 4
    assert os.path.exists(out)
    captions = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("fps:")]
    assert len(captions) == 4 and "[fast 320x180]" in captions[-1]


def test_app_and_probe_modules_import_without_jax():
    """With jax blocked, the app layer, the probes and the bench entry
    points import, and nothing of the JAX package or its experiments/
    comes with them."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "for m in ('app.profiler', 'app.compare', 'app.viewer', "
        "'app.stats', 'utils.gametimer', 'experiments.fma_kernel_probe', "
        "'experiments.bin_decomp_probe', 'experiments.sharded_ab_probe', "
        "'experiments.alpha_probe', 'bench', 'experiments.bench_all', "
        "'experiments.bench_ab_probe', 'app.graphs', "
        "'experiments.texture_capture_probe'):\n"
        "    importlib.import_module('crychic_renderer_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('crychic_renderer_tpu', 'experiments'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]


def test_compare_writes_and_checks_goldens(tmp_path):
    """One 480x270 frame written as the golden and checked against it:
    the .npy holds floor(x * 255), so the frame is within 1/255."""
    gold = str(tmp_path / "gold")
    report = compare.main(["--configs", "4", "--small", "--device", "cpu",
                           "--out-dir", gold, "--check", gold])
    assert os.path.exists(os.path.join(gold, "config4.png"))
    assert report[4]["diff"]["frac_gt_2pct"] == 0.0
    assert report[4]["diff"]["max"] <= 1 / 255 + 1e-6
    assert 0.0 < report[4]["mean"] < 1.0
    with pytest.raises(ValueError, match="not a CUDA device"):
        compare.parity([4], True, "cpu")
