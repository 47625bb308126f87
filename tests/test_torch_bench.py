"""The port's bench entry points (crychic_renderer_tpu_torch/bench.py and
experiments/bench_all.py) on the CPU at --small, and Renderer.render's
host reads.

A bench round queues its frames and reads one value back at the end, so
it times the overlap of host issue and device work. That holds only if
Renderer.render never waits for the device: no tensor is read on the host
(aten._local_scalar_dense: int(), float(), bool(), .item()) and no host
data becomes a tensor (aten.lift_fresh: torch.tensor, as_tensor, a list
index, from_numpy, a number written into an element) except the frame's
own uploads, which go through pinned asynchronous copies on the card.
torch records both ops on CPU tensors too, so a TorchDispatchMode finds
them on the CPU; on the card, chip_smoke.py phase 23 renders the same
configs under torch.cuda.set_sync_debug_mode("error").
The plain raster and PCF versions read the host by design and are left
out (the card launches the kernels instead).
"""
import collections
import contextlib
import dataclasses
import io
import json
import statistics

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from crychic_renderer_tpu_torch import bench
from crychic_renderer_tpu_torch.app import renderer as ren
from crychic_renderer_tpu_torch.experiments import bench_all
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.ops import pcf, raster
from torch_threads import cap_torch_threads

cap_torch_threads()

KEYS = {"metric", "value", "unit", "vs_baseline", "rounds_ms", "card",
        "assets"}


def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """bench.main(["--device", "cpu", "--small"]) with REF_MODELS pointed
    at a missing directory, and Renderer.render and bench.read_back
    patched to log each call: (printed lines, log)."""
    log = []
    render, read_back = ren.Renderer.render, bench.read_back

    def logged_render(self, total_time=0.0):
        log.append("render")
        return render(self, total_time)

    def logged_read_back(img):
        log.append("read")
        return read_back(img)

    mp = pytest.MonkeyPatch()
    mp.setattr(sb, "REF_MODELS",
               str(tmp_path_factory.mktemp("no_reference") / "Models"))
    mp.setattr(ren.Renderer, "render", logged_render)
    mp.setattr(bench, "read_back", logged_read_back)
    try:
        lines = _run_main(bench.main, ["--device", "cpu", "--small"])
    finally:
        mp.undo()
    return lines, log


def test_bench_prints_one_json_line(bench_run):
    """One parseable line with bench.py's four keys, the rounds, the card
    and the asset source; without the reference's files it renders the
    synthetic set and says so."""
    lines, _ = bench_run
    assert len(lines) == 1, lines
    got = json.loads(lines[-1])
    assert KEYS <= set(got), got
    assert got["unit"] == "ms/frame" and got["card"] == "cpu"
    assert got["assets"] == "synthetic" and "synthetic" in got["metric"]
    assert "160x90" in got["metric"] and "skull+car" in got["metric"]
    rounds = got["rounds_ms"]
    assert len(rounds) == bench.SMALL_ROUNDS and min(rounds) > 0
    assert got["value"] == statistics.median(rounds)
    assert got["vs_baseline"] == bench.BASELINE_MS / got["value"]
    assert got["frames"] == 1 + bench.SMALL_ROUNDS * bench.SMALL_FRAMES
    # the CPU runs the kernels' plain versions, which launch nothing
    assert got["kernel_launches"] == dict(ids=0, depth=0, pcf=0)


def test_bench_queues_frames_and_reads_once_per_round(bench_run):
    """A warm-up frame read back, then each round renders its n frames
    and reads back once, after the last."""
    _, log = bench_run
    n = bench.SMALL_FRAMES
    assert log == ["render", "read"] + (["render"] * n + ["read"]) * \
        bench.SMALL_ROUNDS


def test_bench_all_prints_a_line_per_config(monkeypatch, tmp_path):
    """The card line, then one JSON line for each of configs 1-5 and the
    fast preset of 4 and 5."""
    monkeypatch.setattr(sb, "REF_MODELS", str(tmp_path / "Models"))
    lines = _run_main(bench_all.main, ["--device", "cpu", "--small"])
    assert lines[0] == "card: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [(r["config"], r["fast"]) for r in rows] == list(bench_all.CELLS)
    assert len(rows) == 7
    for r in rows:
        assert r["ms_per_frame"] > 0 and r["frames"] == 1, r
        assert r["size"] == "160x90", r
        assert r["kernel_launches"] == dict(ids=0, depth=0, pcf=0), r
        assert r["assets"] == ("synthetic" if r["config"] in (2, 3, 5)
                               else "built in"), r


class HostReads(TorchDispatchMode):
    """Counts aten._local_scalar_dense and aten.lift_fresh, except while
    `paused` (inside the plain raster and PCF versions)."""

    OPS = {torch.ops.aten._local_scalar_dense.default: "local_scalar_dense",
           torch.ops.aten.lift_fresh.default: "lift_fresh"}

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func in self.OPS:
            self.seen[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def asset_set(tmp_path_factory):
    return sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                              sa.SMALL, seed=0)


def _renderer(name, paths):
    """The named scene's Renderer on the CPU at 160x90 with 128^2 maps;
    the fence and config 5 load the synthetic set's files (the fence's
    WireFence.dds has holes)."""
    kw = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "REF_MODELS", paths["models"])
        if name == "fence":
            scene, cfg, lights = sb.fence_scene(alpha_test=True)
            cfg = dataclasses.replace(cfg, alpha_shadow_window=64)
            kw = dict(asset_dir=paths["textures"])
        else:
            scene, cfg, lights = sb.CONFIGS[int(name[-1])]()
            if name == "config5":
                kw = dict(asset_dir=paths["textures"],
                          sky_cubemap_path=paths["sky_cube"])
    return ren.Renderer(scene, bench.shrink(cfg), lights=lights,
                        device="cpu", **kw)


@pytest.mark.parametrize("name", ["config1", "config4", "fence", "config5"])
def test_render_reads_nothing_from_the_host(name, asset_set, monkeypatch):
    """After a warm-up frame, Renderer.render reads no tensor on the host
    and makes no tensor of host data but its uploads: the frame constants
    and, with an animated slot (config 5), the material's pair indices."""
    r = _renderer(name, asset_set)
    r.render(0.0)
    mode = HostReads()

    def paused(fn):
        def run(*args, **kwargs):
            mode.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        return run

    monkeypatch.setattr(raster, "rasterize_plain",
                        paused(raster.rasterize_plain))
    monkeypatch.setattr(pcf, "soft_pcf_plain", paused(pcf.soft_pcf_plain))
    uploads = 1 + (1 if r.anim_specs else 0)
    with mode:
        img = r.render(0.1)
    assert img.shape == (r.cfg.height, r.cfg.width, 4)
    assert (name == "config5") == bool(r.anim_specs)
    assert mode.seen == {"lift_fresh": uploads}, dict(mode.seen)
