"""The reduction of a profiler trace (a Chrome trace's events, as
``torch.profiler`` exports them) to the device's busy and idle time, the
kernels that took most time, and the longest idle gaps labelled by the
benchmark's own host span that covered them."""
from __future__ import annotations

import dataclasses
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Summary:
    busy_s: float  # the union of device-activity intervals
    window_s: float  # first device activity to the last
    kernels: dict  # kernel name -> [seconds, launches]
    gaps: list  # [(host span label, seconds)], longest first

    @property
    def idle_share(self) -> float:
        """100 x (1 - busy / window), in percent."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, pattern: str):
        """(seconds, launches) of the kernels whose name matches the
        regular expression, summed."""
        rx = re.compile(pattern)
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if rx.search(name):
                s += sec
                n += count
        return s, n

    def top_ops(self, k: int = 10) -> list:
        """[[short kernel name, seconds]] of the k kernels that took most
        time in the stretch."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[short_name(name), sec] for name, (sec, _) in ops]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and argument list, at
    most `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def merge(intervals: list) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(gap, spans: list) -> str:
    """The host span that overlaps the gap most, or "host" where none."""
    best, label = 0.0, "host"
    for a, b, name in spans:
        ov = min(b, gap[1]) - max(a, gap[0])
        if ov > best:
            best, label = ov, name[len(SPAN_PREFIX):]
    return label


def summarize(events: list, top_gaps: int = 10) -> Summary:
    """Summary of trace events (dicts with "cat", "name", "ts" and "dur"
    in microseconds). Device activity is the kernels, copies and sets;
    the host spans are the user annotations named bench.*. Returns None
    where the trace holds no device activity."""
    dev, spans, kernels = [], [], {}
    for e in events:
        cat = e.get("cat", "")
        if "ts" not in e or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, b))
            if cat == "kernel":
                k = kernels.setdefault(e["name"], [0.0, 0])
                k[0] += float(e["dur"]) * 1e-6
                k[1] += 1
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((a, b, e["name"]))
    if not dev:
        return None
    busy = merge(dev)
    window = busy[-1][1] - busy[0][0]
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])),
                  key=lambda g: g[0] - g[1])[:top_gaps]
    return Summary(
        busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=window * 1e-6,
        kernels=kernels,
        gaps=[(_label(g, spans), (g[1] - g[0]) * 1e-6) for g in gaps])


def summarize_profiler(profiler, scratch_dir: str) -> Summary:
    """Export the profiler's trace into scratch_dir, read it back and
    summarize it; the file is deleted."""
    path = os.path.join(scratch_dir, "trace.json")
    profiler.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events)
