"""The benchmark's arithmetic on synthetic inputs: the frame rate and the
95th percentile of frame intervals, the device's busy and idle time from
trace events, the labels of idle gaps, the K2/K6 work counts on a tiny
raster against a hand count, and the rooflines."""
import statistics

import pytest
import torch

from benchmark.harness import cell, loop, trace, work
from benchmark.reference.ops import raster
from benchmark.reference.ops import rasterizer as rz


class Clock:
    """Events whose times the test sets (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_p95_of_intervals_takes_every_interval():
    times = [0.0]
    for i in range(199):
        times.append(times[-1] + (100.0 if i % 20 == 7 else 10.0))
    ev = [Clock(t) for t in times]
    intervals = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    assert len(intervals) == 199
    # 10 of 199 intervals are long: the p95 lies between the two kinds
    p95 = cell._p95(intervals)
    assert p95 == statistics.quantiles(intervals, n=20)[18]
    assert 10.0 < p95 <= 100.0
    assert cell._p95([10.0] * 100 + [50.0]) == 10.0
    assert cell._p95([5.0]) == 5.0


def test_frame_rate_is_window_time_over_frames():
    frames = []

    def issue(n):
        frames.append(n)
        return torch.zeros(1)

    w = loop.run(issue, 2, 0.05, torch.device("cpu"), keep=(0, 1))
    assert w.frames == len(frames) >= 1
    assert len(w.intervals_ms) == w.frames - 1
    assert set(w.kept) == {0, 1, w.frames - 1} or w.frames <= 2
    assert w.seconds >= 0.05
    assert len(w.render_s) == w.frames


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_gap_labels():
    events = [
        _ev("kernel", "void k_a<1>(int)", 0.0, 10.0),
        _ev("kernel", "void k_a<1>(int)", 5.0, 10.0),  # overlaps: 0-15
        _ev("gpu_memcpy", "Memcpy HtoD", 20.0, 5.0),  # 20-25
        _ev("kernel", "k_b(float)", 45.0, 5.0),  # 45-50
        _ev("user_annotation", "bench.render", 14.0, 8.0),  # covers 15-20
        _ev("user_annotation", "bench.wait", 24.0, 30.0),  # covers 25-45
        _ev("cpu_op", "aten::add", 0.0, 100.0),
    ]
    s = trace.summarize(events)
    assert s.busy_s == pytest.approx((15 + 5 + 5) * 1e-6)
    assert s.window_s == pytest.approx(50e-6)
    assert s.idle_share == pytest.approx(100.0 * (1 - 25 / 50))
    assert s.gaps[0][0] == "wait" and s.gaps[0][1] == pytest.approx(20e-6)
    assert s.gaps[1][0] == "render" and s.gaps[1][1] == pytest.approx(5e-6)
    assert s.kernel_seconds(r"k_a<") == (pytest.approx(20e-6), 2)
    assert s.top_ops(1) == [["k_a<1>", pytest.approx(20e-6)]]
    assert trace.summarize([_ev("cpu_op", "x", 0, 1)]) is None


def test_merge_and_short_names():
    assert trace.merge([(3, 4), (0, 2), (1, 3), (6, 7)]) == [[0, 4], [6, 7]]
    assert trace.short_name(
        "void raster_tiles_kernel<false, true>(float4 const*, int)") == \
        "raster_tiles_kernel<false, true>"
    assert trace.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>"
        "(int*, unsigned int)") == "at::native::CatArrayBatchedCopy<int>"


def _rectangle(width, height, x1, y1):
    """Two front-facing triangles tiling the pixel rectangle
    [0, x1) x [0, y1) of a width x height screen."""
    xy = torch.tensor([[[0.0, 0.0], [x1, 0.0], [x1, y1]],
                       [[0.0, 0.0], [x1, y1], [0.0, y1]]])
    return rz.ScreenTris(xy=xy, z=torch.full((2, 3), 0.5),
                         inv_w=torch.ones(2, 3),
                         valid=torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("x1,y1", [(32.0, 8.0), (200.0, 16.0)])
def test_fragment_counts_against_a_hand_count(x1, y1):
    tris = _rectangle(256, 16, x1, y1)
    raster.reset_fragments()
    raster.rasterize(tris, 256, 16, 1024, with_ids=False)
    # every pixel centre of the rectangle is covered once: none lies on
    # the shared diagonal, and the top-left rule keeps the outer edges'
    assert int(raster.FRAGMENTS["depth"]) == int(x1 * y1)
    raster.rasterize(tris, 256, 16, 1024, with_ids=True)
    assert int(raster.FRAGMENTS["covered_pixels"]) == int(x1 * y1)


def test_work_counts_and_rooflines():
    w = dict(shadow_triangles=1000, cascades=4, map_size=64,
             atlas_fragments=3000, receivers=500)
    k2_bytes = 4 * 1000 * 36 + 4 * 64 * 64 * 4
    assert work.k2_least_s(w) == pytest.approx(max(
        k2_bytes / 3.35e12, 3000 * 17 / 67e12))
    k6_bytes = 4 * 64 * 64 * 4 + 500 * 16
    assert work.k6_least_s(w) == pytest.approx(max(
        k6_bytes / 3.35e12, 500 * 16 * 20 / 67e12))
    # the bytes bound both at these sizes; operations bound many fragments
    assert work.k2_least_s(dict(w, atlas_fragments=10 ** 9)) == \
        pytest.approx(10 ** 9 * 17 / 67e12)
    assert work.roofline_pct([1e-6, 3e-6], 8e-6, 2) == pytest.approx(50.0)
    assert work.roofline_pct([1e-6], 0.0, 0) is None
