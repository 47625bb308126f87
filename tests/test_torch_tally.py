"""The port's one tally of launches and gathers (ops/tally.py), the
compiled frames that add a capture's delta to it on every replay
(app/graphs.py, parallel/graphs.py), and the one launch helper that
counts into it (ops/build.KernelLibrary).

On the CPU (counted in the tier-1 run): a replay of a compiled frame
adds what its capture counted to that key and no other, for every key;
the frames hold {} before a capture; a key outside the tally is
refused; a C entry that returns an error code raises RuntimeError with
the library's error text and counts nothing, and an accepted launch
gets the current stream last and counts n under its key (None: not
counted). The CUDA entry points are stand-ins here; on the card the
kernels' tests (``-m cuda``) read the same tally.
"""
import contextlib
import dataclasses
import types

import pytest
import torch

from crychic_renderer_tpu_torch.app import graphs
from crychic_renderer_tpu_torch.ops import build, tally
from crychic_renderer_tpu_torch.parallel import graphs as band_graphs
from crychic_renderer_tpu_torch.parallel import sharded
from torch_threads import cap_torch_threads

cap_torch_threads()


@dataclasses.dataclass
class _Scene:
    x: torch.Tensor


class _Graph:
    """A captured graph's stand-in: replays do nothing."""

    def replay(self):
        pass


@pytest.mark.parametrize("key", tally.KEYS)
def test_replay_adds_its_capture_to_its_key_only(key):
    """A compiled frame whose capture counted 3 under `key` adds 3 there
    on each replay, and nothing under any other key."""
    frame = graphs.CompiledFrame(lambda scene: None, "cpu")
    assert frame.launches == {}
    band = band_graphs.CompiledBandFrame(None, sharded.BandMesh(None, 1),
                                         "cpu")
    assert band.launches == {}
    scene = _Scene(torch.zeros(1))
    frame.graph, frame.outputs = _Graph(), (torch.ones(2),)
    frame.scene_leaves = graphs._leaves(scene)
    frame.launches = {key: 3}
    before = tally.snapshot()
    try:
        frame(scene)
        out = frame(scene)
    finally:
        frame.graph = None
    moved = tally.since(before)
    tally.add({k: -n for k, n in moved.items()})
    assert moved == {key: 6}
    assert tally.snapshot() == before
    assert torch.equal(out, torch.ones(2))


def test_tally_refuses_an_unknown_key():
    before = tally.snapshot()
    with pytest.raises(KeyError):
        tally.add({"raster.rgb": 1})
    assert tally.since(before) == {}


class _Entries:
    """A loaded library's stand-in: its one entry returns rc and records
    its arguments; its error entry names the code."""

    def __init__(self, rc: int):
        self.rc = rc
        self.args = None

    def crychic_probe(self, *args):
        self.args = args
        return self.rc

    def crychic_probe_error(self, rc: int):
        return f"probe refused with {rc}".encode()


def _library(rc: int) -> build.KernelLibrary:
    lib = build.KernelLibrary("probe.cu", "crychic_probe", {},
                              error="crychic_probe_error")
    lib._lib = _Entries(rc)
    return lib


@pytest.fixture
def stand_in_stream(monkeypatch):
    """torch.cuda's device context and current stream as stand-ins: the
    stream's handle is 77."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))


@pytest.mark.parametrize("method", ["call", "launch"])
def test_refused_entry_raises_with_the_library_text(method,
                                                    stand_in_stream):
    """A C entry that returns non-zero raises RuntimeError with the
    library's error text, and nothing is counted."""
    lib = _library(rc=5)
    before = tally.snapshot()
    with pytest.raises(RuntimeError,
                       match="crychic_probe failed: probe refused with 5"):
        if method == "call":
            lib.call("crychic_probe", 1, 2)
        else:
            lib.launch("crychic_probe", "cuda", 1, 2, key="resolve")
    assert tally.since(before) == {}


def test_launch_appends_the_stream_and_counts(stand_in_stream):
    """An accepted launch gets the device's current stream last and
    counts n under its key; a key of None counts nothing."""
    lib = _library(rc=0)
    before = tally.snapshot()
    lib.launch("crychic_probe", "cuda", 1, 2, key="alpha_peel", n=6)
    assert lib._lib.args == (1, 2, 77)
    lib.launch("crychic_probe", "cuda", 3, key=None)
    assert lib._lib.args == (3, 77)
    lib.call("crychic_probe", 4)
    assert lib._lib.args == (4,)
    moved = tally.since(before)
    tally.add({k: -n for k, n in moved.items()})
    assert moved == {"alpha_peel": 6}
