"""The frame loop of the window: frame n is issued after the host has
waited on the event recorded behind frame n - F, and an event is recorded
behind every frame on the stream, so the intervals between frame
completions come from the device's own clock."""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


class HostEvent:
    """A CUDA event's stand-in on the CPU, where every frame has finished
    when render() returns: the host clock at record()."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return 1000.0 * (end.t - self.t)


def new_event(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    frames: int  # frames issued and completed in the window
    seconds: float  # first issue to the synchronize after the last frame
    intervals_ms: list  # between successive frame completions
    render_s: list  # host seconds of each render() call
    kept: dict  # frame index -> the frame's image
    profiled: list  # indices of the frames inside the profiler's stretch


class Stretch:
    """The profiler's steady stretch inside a traced window: from the first
    frame issued at or after `start_s` into the window, `frames` frames.
    The queue is drained before it starts and after its last frame, so
    the trace holds the device work of exactly those frames."""

    def __init__(self, profiler, device, start_s: float, frames: int):
        self.profiler, self.device = profiler, device
        self.start_s, self.frames = start_s, frames
        self.first = None
        self.done = False

    def before(self, n: int, elapsed: float):
        if self.first is None and elapsed >= self.start_s:
            synchronize(self.device)
            self.profiler.start()
            self.first = n

    def after(self, n: int):
        if (self.first is not None and not self.done
                and n - self.first + 1 == self.frames):
            synchronize(self.device)
            self.profiler.stop()
            self.done = True

    def frame_indices(self) -> list:
        return list(range(self.first, self.first + self.frames)
                    if self.done else [])


def span(name: str, on: bool):
    """A named range in the profiler's trace (the benchmark's own host
    spans), when on."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def run(issue, frames_in_flight: int, seconds: float, device: torch.device,
        keep=(), stretch: Stretch = None) -> Window:
    """Issue frames issue(0), issue(1), ... until `seconds` have passed
    since the first (and, in a traced window, until the stretch is done;
    in any window, until the last frame lies beyond those in `keep`),
    each after waiting on the event behind frame n - frames_in_flight.
    Keeps the images of the frames in `keep` and of the last frame."""
    F = frames_in_flight
    traced = stretch is not None
    last_kept = max(keep, default=-1)
    events, render_s, kept = [], [], {}
    t0 = time.perf_counter()
    n, img = 0, None
    while True:
        if n >= F:
            with span("bench.wait", traced):
                events[n - F].synchronize()
        elapsed = time.perf_counter() - t0
        if (n > last_kept + 1 and elapsed >= seconds
                and (not traced or stretch.done)):
            break
        if traced:
            stretch.before(n, elapsed)
        with span("bench.render", traced):
            a = time.perf_counter()
            img = issue(n)
            render_s.append(time.perf_counter() - a)
        ev = new_event(device)
        ev.record()
        events.append(ev)
        if n in keep:
            kept[n] = img
        if traced:
            stretch.after(n)
        n += 1
    kept[n - 1] = img
    synchronize(device)
    total = time.perf_counter() - t0
    intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return Window(frames=n, seconds=total, intervals_ms=intervals,
                  render_s=render_s, kept=kept,
                  profiled=stretch.frame_indices() if traced else [])
