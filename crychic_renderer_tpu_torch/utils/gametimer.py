"""Frame timer with pause support (the port's copy of
``crychic_renderer_tpu.utils.gametimer``).

Re-implements the reference renderer's GameTimer (Common/GameTimer.{h,cpp}):
QPC-based delta/total time where TotalTime excludes paused spans;
Reset/Start/Stop/Tick semantics preserved.
"""
from __future__ import annotations

import time


class GameTimer:
    def __init__(self):
        self._delta = -1.0
        self._paused = 0.0  # accumulated paused duration
        self._base = time.perf_counter()
        self._stop_time = 0.0
        self._prev = self._base
        self._curr = self._base
        self._stopped = False

    def total_time(self) -> float:
        """Seconds since Reset, not counting time spent stopped
        (GameTimer.cpp TotalTime)."""
        if self._stopped:
            return (self._stop_time - self._paused) - self._base
        return (self._curr - self._paused) - self._base

    def delta_time(self) -> float:
        return self._delta

    def reset(self):
        now = time.perf_counter()
        self._base = now
        self._prev = now
        self._stop_time = 0.0
        self._paused = 0.0
        self._stopped = False

    def start(self):
        if self._stopped:
            now = time.perf_counter()
            self._paused += now - self._stop_time
            self._prev = now
            self._stop_time = 0.0
            self._stopped = False

    def stop(self):
        if not self._stopped:
            self._stop_time = time.perf_counter()
            self._stopped = True

    def tick(self):
        if self._stopped:
            self._delta = 0.0
            return
        self._curr = time.perf_counter()
        self._delta = max(self._curr - self._prev, 0.0)
        self._prev = self._curr
