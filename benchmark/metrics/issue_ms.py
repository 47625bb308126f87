"""issue_ms: host ms per frame inside Renderer.render (the frame's
constants, culling, packing, the pinned upload and the replay's launch),
from the benchmark's own span around each render() call, over every
frame of the traced window."""


def read(run):
    s = run.window.render_s
    return 1000.0 * sum(s) / len(s) if s else None
