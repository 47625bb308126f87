"""The frame trace (app/profiler.FrameTrace; Renderer(..., trace=True);
passes/frame.render_frame's mark hook; csrc/frame_trace.cu on the card).

On the CPU, where the frame runs eagerly and the hook writes the host
clock into the rows the card's marks fill:

- a traced Renderer's frames equal an untraced one's bit for bit
  (config 4, config 5 from the SMALL synthetic asset set, the fence);
- every frame gives one row, its stages in profile_frame's order (its
  stage chain, less the parts of raster_main it times alone) with
  non-negative times, its four host parts contiguous and inside the
  render() call, also as profiler ranges;
- the counts are the frame's own: the pairs equal capacity_requirements'
  at each pose (both are the binning's total), on the kernel and the
  pure-tensor raster path; the tiles equal the
  tiles the compacted passes see, recounted from the raster, and stay
  within capacity_requirements', which counts triangle boxes;
- a wrapped ring returns its last rows and says so; run --profile's line
  reads the trace.

On the card (marked ``cuda``; ``python -m pytest
tests/test_torch_frame_trace.py -m cuda --noconftest``): traced renders
queue without a host sync; one row per replay with 1 and 3 frames in
flight, the marks in device order; an untraced Renderer's graph has as
many nodes as the frame without the hook, and a traced one those plus
its marks and its counts' nodes.

Frames at 160x90 with 128^2 maps on the CPU, 480x270 on the card.
"""
import ctypes
import dataclasses
import json
import time
import warnings

import pytest
import torch

from crychic_renderer_tpu_torch.app import graphs, profiler, run
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.ops import pcf, raster
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

SMALL = dict(width=160, height=90, shadow_map_size=128)
TURNS = (0.0, 0.6)  # rad about y before each frame


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The SMALL synthetic set, the port's REF_MODELS at its Models."""
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.SMALL, seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(sb, "REF_MODELS", paths["models"])
    try:
        yield paths
    finally:
        mp.undo()


def _renderer(name, device="cpu", assets=None, size=SMALL, **kw):
    if name == "fence":
        scene, cfg, lights = sb.fence_scene(alpha_test=True)
    else:
        scene, cfg, lights = sb.CONFIGS[int(name[-1])]()
    if name == "config5":
        kw.update(asset_dir=assets["textures"],
                  sky_cubemap_path=assets["sky_cube"])
    return Renderer(scene, dataclasses.replace(cfg, **size), lights=lights,
                    device=device, **kw)


def _frames(r, turns=TURNS):
    out = []
    for i, a in enumerate(turns):
        r.camera.rotate_y(a)
        out.append(r.render(i / 30.0))
    return out


@pytest.mark.parametrize("name", ["config4", "config5", "fence"])
def test_traced_frames_equal_untraced(name, request):
    assets = request.getfixturevalue("assets") if name == "config5" else None
    plain = _renderer(name, assets=assets)
    traced = _renderer(name, assets=assets, trace=True)
    assert plain.trace is None and traced.trace is not None
    for a, b in zip(_frames(plain), _frames(traced)):
        assert torch.equal(a, b)
    assert len(traced.trace.rows()) == len(TURNS)


def _chain_stages(r):
    """profile_frame's stages in order (its stage chain, run once)."""
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    profiler.run_stages(r.device_scene, r.frame_constants(0.0), r.cfg,
                        stage)
    return names


@pytest.mark.parametrize("name", ["config4", "fence"])
def test_one_row_per_frame_in_stage_order(name):
    r = _renderer(name, trace=True)
    _frames(r)
    want = [s for s in _chain_stages(r) if s in fr.FRAME_STAGES]
    assert "raster_main" in want and "lighting" in want
    assert ("alpha_merge_main" in want) == (name == "fence")
    rows = r.trace.rows()
    assert [row.frame for row in rows] == list(range(len(TURNS)))
    for row in rows:
        assert list(row.stage_ms) == want
        assert all(v >= 0.0 for v in row.stage_ms.values()), row.stage_ms
        assert all(v >= 0.0 for v in row.host_ms.values()), row.host_ms
        # the fence's cfg turns SSAO off and adds the alpha layer's
        # counts: its light-space extent and one count per peel
        assert set(row.counts) == (set(profiler.TRACE_COUNTS) - (
            {"ssao_tiles"} if name == "fence" else set())) | (
            set(profiler.ALPHA_COUNTS[:1 + r.cfg.alpha_peels])
            if name == "fence" else set())


def _exact_tiles(r, consts):
    """The tiles the compacted resolve and SSAO evaluate, recounted from
    the frame's own raster: the (8, 128) tiles with a covered pixel, and
    the half-res (8, 32) tiles within the dilation of one."""
    cfg = r.cfg
    tris, _ = fr.main_view_tris(r.device_scene, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    tiles, _, _ = fr._tiles(tid, fr.SHADE_TILE_H, fr.SHADE_TILE_W, -1)
    shade = int((tiles[..., 0] >= 0).any(dim=1).sum())
    n_half, _ = fr.ssao_inputs_half(cfg, tid[..., None], depth)
    h, w = n_half.shape[:2]
    k = cfg.ssao_scale
    vh = (tid >= 0)[:h * k, :w * k].reshape(h, k, w, k).any(3).any(1)
    ssao = int(fr._ssao_tile_occupancy(vh, -(-h // fr.SSAO_TILE_H),
                                       -(-w // fr.SSAO_TILE_W)).sum())
    return shade, ssao


def test_counts_are_the_frames_counts():
    r = _renderer("config4", trace=True)
    want = []
    for i, a in enumerate(TURNS):
        r.camera.rotate_y(a)
        req = r.capacity_requirements(i / 30.0)
        want.append((req, _exact_tiles(r, r.frame_constants(i / 30.0))))
        r.render(i / 30.0)
    rows = r.trace.rows()
    seen = set()
    for row, (req, (shade, ssao)) in zip(rows, want):
        c = row.counts
        assert c["main_pairs"] == req["main_pairs"]
        assert c["shadow_pairs"] == req["shadow_pairs"]
        assert (c["shade_tiles"], c["ssao_tiles"]) == (shade, ssao)
        assert 0 < c["shade_tiles"] <= req["shade_tiles"]
        assert 0 < c["ssao_tiles"] <= req["ssao_tiles"]
        seen.add(c["main_pairs"])
    assert len(seen) > 1  # the turns change the work


def test_counts_on_the_tensor_raster_path():
    """use_pallas False: the pairs of the main view and of the four
    cascades' own viewports, summed, equal capacity_requirements'."""
    scene, cfg, lights = sb.CONFIGS[4]()
    r = Renderer(scene, dataclasses.replace(cfg, use_pallas=False, **SMALL),
                 lights=lights, device="cpu", trace=True)
    r.camera.rotate_y(0.6)
    req = r.capacity_requirements(0.1)
    r.render(0.1)
    (row,) = r.trace.rows()
    assert row.counts["main_pairs"] == req["main_pairs"]
    assert row.counts["shadow_pairs"] == req["shadow_pairs"]
    assert 0 < row.counts["shade_tiles"] <= req["shade_tiles"]


def test_host_spans_inside_render():
    r = _renderer("config4", trace=True)
    bounds = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i, a in enumerate(TURNS):
            r.camera.rotate_y(a)
            t0 = time.perf_counter_ns()
            r.render(i / 30.0)
            bounds.append((t0, time.perf_counter_ns()))
    rows = r.trace.rows()
    assert [row.frame for row in rows] == [0, 1]
    for row, (t0, t1) in zip(rows, bounds):
        t = row.host_ns
        assert len(t) == 1 + len(profiler.HOST_PARTS)
        assert t0 <= t[0] and t[-1] <= t1
        assert all(a <= b for a, b in zip(t, t[1:])), t
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.name.startswith(profiler.SPAN_PREFIX))
    names = [n[len(profiler.SPAN_PREFIX):] for _, _, n in spans]
    assert names == list(profiler.HOST_PARTS) * 2
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans


def _fake_frame(trace, f):
    """One frame through the trace's hooks, as the Renderer drives them,
    with counts that say which frame wrote them."""
    trace.begin_frame()
    for part in profiler.HOST_PARTS:
        with trace.part(part):
            pass
    trace.mark("start")
    for s in ("raster_main", "resolve_gbuffer", "lighting"):
        trace.mark(s)
    trace.write_counts({k: torch.tensor(100 * f + j)
                        for j, k in enumerate(profiler.TRACE_COUNTS)
                        if k != "ssao_tiles"})
    trace.end_frame()


def test_wrapped_ring_returns_the_last_rows(monkeypatch):
    monkeypatch.setattr(profiler, "RING_FRAMES", 4)
    trace = profiler.FrameTrace("cpu")
    for f in range(6):
        _fake_frame(trace, f)
    with pytest.warns(UserWarning, match="frames 0 to 1 are lost"):
        rows = trace.rows()
    assert [r.frame for r in rows] == [2, 3, 4, 5]
    for r in rows:
        assert list(r.stage_ms) == ["raster_main", "resolve_gbuffer",
                                    "lighting"]
        assert r.counts == {"main_pairs": 100 * r.frame,
                            "shadow_pairs": 100 * r.frame + 1,
                            "shade_tiles": 100 * r.frame + 2}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert [r.frame for r in trace.rows(since=4)] == [4, 5]


def test_frame_without_the_hook_gives_no_counts():
    """render_frame without mark fills stats with the flags alone; with
    it, the flags are the same and the counts are added."""
    r = _renderer("config4")
    consts = r.frame_constants(0.0)
    plain, marked, names = {}, {}, []
    a = fr.render_frame(r.device_scene, consts, r.cfg, plain)
    b = fr.render_frame(r.device_scene, consts, r.cfg, marked, names.append)
    assert torch.equal(a, b)
    assert set(plain) == {k for k in plain if k.endswith("_overflowed")}
    assert set(marked) == set(plain) | set(profiler.TRACE_COUNTS)
    assert names == ["start", "raster_main", "resolve_gbuffer",
                     "shadow_maps_x4", "ssao", "shadow_factor",
                     "direct_light", "lighting"]


def test_trace_summary():
    cfg = dataclasses.replace(sb.CONFIGS[4]()[1], pair_capacity=1000,
                              shadow_pair_capacity=2000,
                              shade_tile_capacity=100,
                              ssao_tile_capacity=None)
    rows = [profiler.FrameRow(
        f, (0, 1_000_000, 3_000_000, 3_500_000, 3_500_000 + 1_000_000 * f),
        {"raster_main": 1.0 + f, "lighting": 2.0},
        {"main_pairs": 100 * (f + 1), "shadow_pairs": 500,
         "shade_tiles": 50, "ssao_tiles": 7}) for f in range(3)]
    s = profiler.trace_summary(rows, cfg)
    assert s["frames"] == 3
    assert s["host_ms"] == {"constants": 1.0, "cull": 2.0, "upload": 0.5,
                            "launch": 1.0}
    assert s["replay_ms"] == {"raster_main": 2.0, "lighting": 2.0}
    # a capacity the cfg does not set (dense SSAO) has no occupancy
    assert s["occupancy"] == {"main_pairs": 20.0, "shadow_pairs": 25.0,
                              "shade_tiles": 50.0}


def test_profile_line_reads_the_trace(capsys):
    r = _renderer("config4", trace=True)
    run.profile_frames(r, 12.5, {"config": 4}, frames=1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["card"] == "cpu" and line["frame_ms"] == 12.5
    assert "busy_share" not in line and "device_ms_per_frame" not in line
    assert list(line["replay_ms"]) == ["raster_main", "resolve_gbuffer",
                                       "shadow_maps_x4", "ssao",
                                       "shadow_factor", "direct_light",
                                       "lighting"]
    assert list(line["host_ms"]) == list(profiler.HOST_PARTS)
    assert set(line["occupancy"]) == set(profiler.TRACE_COUNTS)
    assert all(0.0 < v <= 100.0 for v in line["occupancy"].values())
    assert line["top"] and all(t["ms_per_frame"] >= 0 for t in line["top"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD = dict(width=480, height=270)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_render_queues_without_a_host_sync(cuda):
    """Traced renders under set_sync_debug_mode("error") raise nothing
    and equal an untraced Renderer's frames."""
    plain = _renderer("config4", cuda, size=CARD)
    traced = _renderer("config4", cuda, size=CARD, trace=True)
    want = _frames(plain)
    traced.render(0.0)  # the eager frame, the capture, one replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = []
        for i, a in enumerate(TURNS):
            traced.camera.rotate_y(a)
            got.append(traced.render(i / 30.0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    traced.check_overflow()
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert len(traced.trace.rows()) == 1 + len(TURNS)


@pytest.mark.cuda
@pytest.mark.parametrize("in_flight", [1, 3])
def test_traced_compiled_frame_writes_a_row_per_replay(cuda, in_flight):
    """N frames, frame n issued once the event behind frame n - F has
    completed: N rows, frames 0 .. N - 1, every stage and count, and the
    marks in device order (a frame starts after the last one ended)."""
    r = _renderer("config4", cuda, size=CARD, trace=True)
    n, events = 12, []
    for i in range(n):
        if i >= in_flight:
            events[i - in_flight].synchronize()
        r.camera.rotate_y(0.1)
        r.render(i / 60.0)
        ev = torch.cuda.Event()
        ev.record()
        events.append(ev)
    rows = r.trace.rows()
    r.check_overflow()
    assert [row.frame for row in rows] == list(range(n))
    stages = ["raster_main", "resolve_gbuffer", "shadow_maps_x4", "ssao",
              "shadow_factor", "direct_light", "lighting"]
    marks = r.trace.marks.cpu().numpy()
    for row in rows:
        assert list(row.stage_ms) == stages
        assert all(v > 0.0 for v in row.stage_ms.values()), row.stage_ms
        assert set(row.counts) == set(profiler.TRACE_COUNTS)
        assert all(v > 0 for v in row.counts.values()), row.counts
    for f in range(1, n):
        assert marks[f, 1] >= marks[f - 1, 2 + fr.FRAME_STAGES.index(
            "lighting")]


def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _node_count(fn, device) -> int:
    """Nodes of fn captured as graphs.capture does (one eager run first),
    from cuGraphGetNodes on the kept graph; where this torch cannot keep
    the graph, the kernel launches of one profiled replay."""
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
        keep = True
    except TypeError:
        keep = False
    pieces = graphs.Pieces(
        (lambda: torch.cuda.CUDAGraph(keep_graph=True)) if keep else None)
    maps = pcf.OwnedMaps()
    try:
        graphs.capture(fn, device, maps, pieces)
        assert len(pieces.graphs) == 1
        if keep:
            n = ctypes.c_size_t(0)
            rc = _libcuda().cuGraphGetNodes(
                ctypes.c_void_p(pieces.graphs[0].raw_cuda_graph()), None,
                ctypes.byref(n))
            assert rc == 0, rc
            return n.value
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pieces.replay()
            torch.cuda.synchronize(device)
        return sum(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())
    finally:
        torch.cuda.synchronize(device)
        pieces.reset()
        maps.release()


@pytest.mark.cuda
def test_untraced_graph_is_the_frame_without_the_hook(cuda):
    """The untraced Renderer's frame has as many nodes as render_frame
    without the hook plus the overflow ORs (the frame before the trace
    existed); the traced frame adds its marks and its counts' nodes."""
    plain = _renderer("config4", cuda, size=CARD)
    traced = _renderer("config4", cuda, size=CARD, trace=True)
    packed = fr.upload(plain._pack_frame_constants(
        plain.frame_constants_np(0.0)), cuda)
    n_op = plain.scene.opaque.num_instances
    n_sh = plain.scene.shadow.num_instances

    def without_hook():
        consts = plain._unpack_frame_constants(packed, n_op, n_sh, 0)
        stats = {}
        img = fr.render_frame(plain.device_scene, consts, plain.cfg, stats)
        for k, flag in plain._overflow.items():
            if k in stats:
                flag |= stats[k]
        return img

    stats = {k: torch.zeros((), dtype=torch.int64, device=cuda)
             for k in profiler.TRACE_COUNTS}
    stats["main_pairs"] = stats["shadow_pairs"] = torch.zeros(
        (), dtype=torch.int32, device=cuda)

    def counts_alone():
        traced.trace.write_counts(stats)

    n_plain = _node_count(
        lambda: plain.compiled_frame.fn(plain.device_scene, packed), cuda)
    n_before = _node_count(without_hook, cuda)
    n_traced = _node_count(
        lambda: traced.compiled_frame.fn(traced.device_scene, packed), cuda)
    n_counts = _node_count(counts_alone, cuda)
    marks = 1 + 7  # the start and config 4's seven stages
    assert n_plain == n_before
    assert n_traced == n_plain + marks + n_counts, (n_traced, n_plain,
                                                    n_counts)
