"""The compiled band frame: one rank's ``render_frame_sharded`` (or
``render_frames_replicated``) captured into CUDA graphs and replayed, the
port's counterpart of the JAX callers' ``jax.jit`` of the band-sharded
frame with its ``shard_map`` inside.

``CompiledBandFrame(render, mesh, device)`` follows
``app/graphs.CompiledFrame``'s rules: its first call, and every call
whose cfg, scene tensors or constants' shapes differ from those it bound,
runs the frame once eagerly, captures it in CUDA's global capture mode on
its own copies of the constants and replays it; every other call copies
the constants in and replays. It returns a clone of the frame (and
clones of the overflow flags in ``stats``); what the capture counted in
the tally is added per replay (on NCCL the gathers inside the graph; on
gloo each replay's host gathers count themselves); K6 reads the
window-ready map buffers and texture objects of the frame's
``ops/pcf.OwnedMaps``, made in the eager frame, never the eager texture
cache; ``release()`` frees everything after a synchronize. A host sync
left in the frame makes the capture raise, and nothing falls back to the
eager frame.

Its mode follows the band group's backend:

- **NCCL** (one rank per card): the whole frame, its
  ``all_gather_into_tensor`` collectives included, is one graph. The
  eager frame before the capture brings the communicator up and runs
  every collective once.
- **gloo** (ranks that share a card; NCCL refuses two ranks on one GPU):
  gloo runs its collectives on the host, and a capture refuses them. The
  capture is piecewise (``app/graphs.Pieces``): inside
  ``sharded.split_gathers`` every gather ends the graph being captured
  and opens the next. A replay runs graph 0, gather 0 (made on the host
  from graph 0's static input into the static buffer graph 1 reads),
  graph 1, and so on in capture order: the graphs are the gathers + 1,
  they share one memory pool, and the gathers' inputs and buffers are
  held by the object until ``release()``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..app import graphs as app_graphs
from ..ops import pcf, tally
from . import sharded


def _clone(consts):
    """A FrameConstants with every tensor cloned."""
    return dataclasses.replace(consts, **{
        f.name: getattr(consts, f.name).clone()
        for f in dataclasses.fields(consts)
        if isinstance(getattr(consts, f.name), torch.Tensor)})


def _tensor_shapes(consts) -> list:
    return [(v.shape, v.dtype, v.device) if isinstance(v, torch.Tensor)
            else v for v in app_graphs._leaves(consts)]


class CompiledBandFrame:
    """render(scene, consts, cfg, mesh, stats) of this rank captured into
    CUDA graphs (see the module doc). After a capture: ``graphs`` (1 on
    NCCL, the gathers + 1 on gloo), ``capture_ms``, ``pool_bytes``,
    ``launches`` (what a replay adds to the tally, by key)."""

    def __init__(self, render, mesh: sharded.BandMesh, device):
        self.render = render
        self.mesh = mesh
        self.device = torch.device(device)
        self.pieces = None
        self.maps = pcf.OwnedMaps()
        self.static = None
        self.outputs = ()
        self.flags = ()
        self.key = None
        self.launches = {}
        self.capture_ms = None
        self.pool_bytes = None

    @property
    def graphs(self) -> int:
        return len(self.pieces.graphs) if self.pieces is not None else 0

    def __call__(self, scene, consts, cfg, stats: dict = None):
        key = (cfg, app_graphs._leaves(scene), _tensor_shapes(consts))
        if self.pieces is None or not self._bound(key):
            self._capture(scene, consts, cfg, key)
        else:
            for f in dataclasses.fields(consts):
                v = getattr(consts, f.name)
                if isinstance(v, torch.Tensor):
                    getattr(self.static, f.name).copy_(v)
        self.pieces.replay()
        tally.add(self.launches)
        img, *flags = (o.clone() for o in self.outputs)
        if stats is not None:
            stats.update(zip(self.flags, flags))
        return img

    def _bound(self, key) -> bool:
        cfg, leaves, shapes = key
        return (cfg == self.key[0] and shapes == self.key[2]
                and app_graphs._same_leaves(leaves, self.key[1]))

    def _capture(self, scene, consts, cfg, key):
        self.release()
        self.static = _clone(consts)
        stats = {}

        def frame():
            stats.clear()
            img = self.render(scene, self.static, cfg, self.mesh, stats)
            return (img,) + tuple(stats[k] for k in sorted(stats))

        pieces = app_graphs.Pieces()
        nccl = dist.get_backend(self.mesh.group) == "nccl"
        out, self.capture_ms, self.pool_bytes, self.launches = \
            app_graphs.capture(frame, self.device, self.maps, pieces,
                               None if nccl
                               else sharded.split_gathers(pieces.split))
        self.outputs = out
        self.flags = tuple(sorted(stats))
        self.key = key
        self.pieces = pieces

    def release(self):
        """Free the graphs, their pool, the gathers' buffers and the maps'
        texture objects, once the card has finished every replay queued
        so far."""
        if self.pieces is None and not self.maps.held():
            return
        torch.cuda.synchronize(self.device)
        self.outputs = ()
        if self.pieces is not None:
            self.pieces.reset()
            self.pieces = None
        self.maps.release()
        self.static = None
        self.key = None

    def __del__(self):
        self.release()
