"""Frame statistics (the port's copy of ``crychic_renderer_tpu.app.stats``).

Mirrors the reference renderer's D3DApp::CalculateFrameStats
(Common/d3dApp.cpp:598-628): FPS and ms/frame averaged over 1-second
windows, plus the visible-instance counter the reference shows in its
caption (CRYCHIC.cpp:558-563).
"""
from __future__ import annotations

import time


class FrameStats:
    def __init__(self, window_seconds: float = 1.0):
        self.window = window_seconds
        self._frame_count = 0
        self._window_start = time.perf_counter()
        self.fps = 0.0
        self.mspf = 0.0
        self.visible_instances = 0
        self.total_instances = 0

    def tick(self) -> bool:
        """Count one frame; returns True when a new 1s average is ready."""
        self._frame_count += 1
        now = time.perf_counter()
        elapsed = now - self._window_start
        if elapsed >= self.window:
            self.fps = self._frame_count / elapsed
            self.mspf = 1000.0 * elapsed / self._frame_count
            self._frame_count = 0
            self._window_start = now
            return True
        return False

    def caption(self) -> str:
        """The reference's window-caption line."""
        return (f"fps: {self.fps:.0f}   mspf: {self.mspf:.2f}   "
                f"{self.visible_instances} objects visible out of "
                f"{self.total_instances}")
