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
pageable copy, the kernel libraries load, and the soft PCF's map buffers
and their texture objects are made (``ops/pcf.OwnedMaps``; the capture
makes none and never touches the kernel's texture cache). The capture
runs in CUDA's global capture mode, PyTorch's default: a host sync or an
unsafe call inside the frame makes it raise, and nothing falls back to
the eager frame.

The kernel wrappers count a launch when they are called, so the counts
the capture adds are taken back and added again on every replay
(``ops/raster.add_launches``, ``ops/pcf.add_launches``): the counters
count the kernels the card ran, the eager frame's included.

The graph's intermediate tensors live in its private memory pool
(``pool_bytes``, measured as the device memory the capture reserved).
``release()`` waits for the card, then frees the graph, its pool and the
texture objects; it runs when the object is collected.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..ops import pcf, raster

# Captures in this process. Each ran one eager frame first, whose kernel
# launches the counters hold.
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


def _tally():
    return dict(raster.LAUNCHES_BY_VARIANT), pcf.LAUNCHES


class CompiledFrame:
    """fn(scene, *inputs) captured into a CUDA graph (see the module doc).
    After a capture: ``capture_ms`` (host time of the capture alone),
    ``pool_bytes``, ``launches`` (per replay: the raster kernel's count by
    variant and the soft PCF's)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.maps = pcf.OwnedMaps()
        self.static = ()
        self.outputs = ()
        self.single = True
        self.scene_leaves = []
        self.launches = ({}, 0)
        self.capture_ms = None
        self.pool_bytes = None

    def __call__(self, scene, *inputs):
        if self.graph is None or not self._bound(scene, inputs):
            self._capture(scene, inputs)
        else:
            for s, x in zip(self.static, inputs):
                s.copy_(x)
        self.graph.replay()
        raster.add_launches(self.launches[0])
        pcf.add_launches(self.launches[1])
        out = tuple(o.clone() for o in self.outputs)
        return out[0] if self.single else out

    def _bound(self, scene, inputs) -> bool:
        return _same_leaves(_leaves(scene), self.scene_leaves) and all(
            s.shape == x.shape and s.dtype == x.dtype and s.device == x.device
            for s, x in zip(self.static, inputs))

    def _capture(self, scene, inputs):
        global CAPTURES
        self.release()
        dev = self.device
        self.static = tuple(x.clone() for x in inputs)
        with pcf.owned_maps(self.maps):  # the eager frame
            self.fn(scene, *self.static)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _tally()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        try:
            with pcf.owned_maps(self.maps), torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="global")
                try:
                    out = self.fn(scene, *self.static)
                finally:
                    graph.capture_end()
        finally:
            counts, n_pcf = _tally()
            by_variant = {k: counts[k] - before[0][k] for k in counts}
            raster.add_launches({k: -n for k, n in by_variant.items()})
            pcf.add_launches(before[1] - n_pcf)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.capture_ms = 1000.0 * (time.perf_counter() - t0)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = ({k: n for k, n in by_variant.items() if n},
                         n_pcf - before[1])
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.scene_leaves = _leaves(scene)
        self.graph = graph
        CAPTURES += 1

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
