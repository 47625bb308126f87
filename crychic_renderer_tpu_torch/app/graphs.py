"""The compiled frame: a frame function captured into one CUDA graph and
replayed, the port's counterpart of the JAX Renderer's ``jax.jit`` of
``frame_packed`` and of its viewer's ``jax.jit(step)``.

``CompiledFrame(fn, device)`` binds ``fn(scene, *inputs)``, whose inputs
are tensors (the packed frame constants, say) and whose output is a
tensor or a tuple of tensors. Its first call, and every call whose scene
leaves are not the tensors it bound or whose inputs changed shape, does
three things: it runs fn once eagerly, captures fn into a
``torch.cuda.CUDAGraph`` on its own copies of the inputs, and replays the
graph. Every other call copies the inputs into those copies on the
current stream and replays the graph: one graph launch and a few small
copies instead of the frame's thousands of kernel launches. It returns
clones of the graph's outputs, as the JAX frame returns new arrays, so a
frame the caller still holds is not overwritten by the next replay.

The eager frame comes first because a capture refuses what a frame does
on its first run: ``ops/consts.device_constant`` makes its tensors with a
pageable copy, the kernel libraries load, and the soft PCF's
window-ready map buffers and their texture objects are made
(``ops/pcf.OwnedMaps``; the capture makes none and never touches the
kernel's texture cache). The capture
runs in CUDA's global capture mode, PyTorch's default: a host sync or an
unsafe call inside the frame makes it raise, and nothing falls back to
the eager frame.

The kernel wrappers count a launch in the tally (``ops/tally.py``) when
they are called, and a band gather counts itself when it is made, so
``capture`` takes back what the capture counted and each replay adds it
again with one ``tally.add``: the tally counts what the card ran, the
eager frame's included.

The graph's intermediate tensors live in its private memory pool
(``pool_bytes``, measured as the device memory the capture reserved).
``release()`` waits for the card, then frees the graph, its pool and the
texture objects; it runs when the object is collected.

``capture`` and ``Pieces`` are that procedure for any function: the
profiler's stage graphs (app/profiler.py) and the band-sharded frame
(parallel/graphs.py) use them too. ``Pieces`` holds a capture split into
several graphs where the function hands work to the host between two of
them (the band frame's gloo gathers), replayed in capture order with
that work between the graphs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..ops import pcf, tally

# Captures in this process. Each ran one eager frame first, whose kernel
# launches the tally holds.
CAPTURES = 0


def _leaves(obj) -> list:
    """The fields of a dataclass container (DeviceScene), nested
    containers flattened."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _same_leaves(a: list, b: list) -> bool:
    """The same tensors (by identity) and the same other values."""
    return len(a) == len(b) and all(
        x is y if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor)
        else x == y for x, y in zip(a, b))


class Pieces:
    """The CUDA graphs of one capture, in capture order. ``split(fn,
    *args)``, called while a graph is being captured, ends that graph,
    records fn(*args) as host work to run after it, and opens the next
    graph; without a split the capture is one graph. Every graph after
    the first shares the first's memory pool, so a tensor one graph makes
    and a later one reads keeps its address: the graphs replay in capture
    order on one stream (``replay``: graph 0, step 0, graph 1, ...).
    new_graph makes a graph (torch.cuda.CUDAGraph; a test hands a
    stand-in)."""

    def __init__(self, new_graph=None):
        self.new_graph = new_graph or torch.cuda.CUDAGraph
        self.graphs = []
        self.steps = []  # (fn, args) run between graph k and graph k + 1
        self.open = False

    def begin(self):
        pool = self.graphs[0].pool() if self.graphs else None
        graph = self.new_graph()
        graph.capture_begin(pool=pool, capture_error_mode="global")
        self.graphs.append(graph)
        self.open = True

    def end(self):
        if self.open:
            self.open = False
            self.graphs[-1].capture_end()

    def split(self, fn, *args):
        self.end()
        self.steps.append((fn, args))
        self.begin()

    def replay(self):
        for graph, (fn, args) in zip(self.graphs, self.steps):
            graph.replay()
            fn(*args)
        self.graphs[-1].replay()

    def reset(self):
        for graph in self.graphs:
            graph.reset()
        self.graphs, self.steps = [], []


def capture(fn, device, maps: pcf.OwnedMaps, pieces: Pieces,
            during=None):
    """Run fn() once eagerly, then capture it into `pieces` on a side
    stream, both with the soft PCF's maps and texture objects in `maps`
    (see the module doc). `during`, a context manager, is entered around
    the capture alone (the band frame's split_gathers). Returns (fn's
    output in the capture, capture ms on the host clock, the device
    memory the capture reserved, what the capture counted in the tally:
    {key: count} of the keys it moved, which it takes back from the
    tally and a replay adds again)."""
    global CAPTURES
    device = torch.device(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    # the eager frame runs on the capture's stream: what a library makes
    # once per stream (cuBLAS's workspace) is made here, outside the
    # graph's pool, which would otherwise keep it after the graph is freed
    with pcf.owned_maps(maps), torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = tally.snapshot()
    t0 = time.perf_counter()
    try:
        with pcf.owned_maps(maps), torch.cuda.stream(stream), \
                during or contextlib.nullcontext():
            pieces.begin()
            try:
                out = fn()
            finally:
                pieces.end()
    finally:
        launches = tally.since(before)
        tally.add({k: -n for k, n in launches.items()})
    torch.cuda.current_stream(device).wait_stream(stream)
    capture_ms = 1000.0 * (time.perf_counter() - t0)
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    CAPTURES += 1
    return out, capture_ms, pool_bytes, launches


class CompiledFrame:
    """fn(scene, *inputs) captured into a CUDA graph (see the module doc).
    After a capture: ``capture_ms`` (host time of the capture alone),
    ``pool_bytes``, ``launches`` (what a replay adds to the tally, by key;
    {} before a capture).

    A traced Renderer's fn (app/profiler.FrameTrace) queues its marks and
    counts only while it is being captured, so the eager frame before a
    capture records nothing and the graph holds the trace's frame
    counter: the start mark advances it once per replay, and every
    replay writes one row of the trace."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.maps = pcf.OwnedMaps()
        self.static = ()
        self.outputs = ()
        self.single = True
        self.scene_leaves = []
        self.launches = {}
        self.capture_ms = None
        self.pool_bytes = None

    def __call__(self, scene, *inputs):
        if self.graph is None or not self._bound(scene, inputs):
            self._capture(scene, inputs)
        else:
            for s, x in zip(self.static, inputs):
                s.copy_(x)
        self.graph.replay()
        tally.add(self.launches)
        out = tuple(o.clone() for o in self.outputs)
        return out[0] if self.single else out

    def _bound(self, scene, inputs) -> bool:
        return _same_leaves(_leaves(scene), self.scene_leaves) and all(
            s.shape == x.shape and s.dtype == x.dtype and s.device == x.device
            for s, x in zip(self.static, inputs))

    def _capture(self, scene, inputs):
        self.release()
        self.static = tuple(x.clone() for x in inputs)
        graph = Pieces()
        out, self.capture_ms, self.pool_bytes, self.launches = capture(
            lambda: self.fn(scene, *self.static), self.device, self.maps,
            graph)
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.scene_leaves = _leaves(scene)
        self.graph = graph

    def release(self):
        """Free the graph, its pool and its maps' texture objects, once
        the card has finished every replay queued so far."""
        if self.graph is None and not self.maps.held():
            return
        torch.cuda.synchronize(self.device)
        self.outputs = ()
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self.maps.release()
        self.static = ()
        self.scene_leaves = []

    def __del__(self):
        self.release()
