"""The port's one tally of what it has run: the hand kernels' launches and
the band frame's gathers, counted by name since import.

Keys (``KEYS``): ``raster.<variant>`` for the raster kernel's variants
(``RASTER_VARIANTS``: "ids" K1 the main view, "depth" K2 the shadow
atlas, "band_ids" and "band_depth" K3 the band-sharded frame,
"field_ids" and "field_depth" K4 the layout probe), "pcf" (K6),
"resolve" (K7), "alpha_peel" (K8, two a peel round), "ssao.occlusion"
and "ssao.blur" (K9, one a frame and one a blur iteration), "light"
(K10, one a frame), "gathers" and
"gathered_bytes" (the band frame's all-gathers and the bytes they
received, ``parallel/sharded._Comm.gather_into``).

A kernel counts where it is launched (``ops/build.KernelLibrary.launch``).
A CUDA graph's capture takes back what it counted and each replay adds
it again (``app/graphs.capture``), so the tally counts what the card
ran, the eager frame before a capture included. A reader takes a
``snapshot``, runs, and reads ``since`` it.
"""
from __future__ import annotations

RASTER_VARIANTS = ("ids", "depth", "band_ids", "band_depth", "field_ids",
                   "field_depth")
KEYS = tuple(f"raster.{v}" for v in RASTER_VARIANTS) + (
    "pcf", "resolve", "alpha_peel", "ssao.occlusion", "ssao.blur", "light",
    "gathers", "gathered_bytes")

_COUNTS = dict.fromkeys(KEYS, 0)


def snapshot() -> dict:
    """Every key's count now."""
    return dict(_COUNTS)


def since(snap: dict) -> dict:
    """What was counted since `snap` (a snapshot), by key: the keys that
    moved only."""
    return {k: n - snap[k] for k, n in _COUNTS.items() if n != snap[k]}


def add(delta: dict):
    """Add {key: count} to the tally (a negative count takes it back). A
    key outside KEYS raises KeyError."""
    for k, n in delta.items():
        _COUNTS[k] += n
