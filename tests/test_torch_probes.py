"""The port's timing probes (crychic_renderer_tpu_torch/experiments/)
against the JAX package's, on the same triangles, on the CPU.

- K4 (``fma_kernel_probe.rasterize_fma``, both layouts) against the JAX
  probe's ``_fma_kernel`` run in interpret mode through the probe's own
  ``rasterize_fma`` (its ``pl.pallas_call`` given ``interpret=True``), on
  a 256x128 main view with ids and a 256x64 atlas with the column guard.
- K5 (``bin_decomp_probe``: the raster kernel alone on precomputed
  inputs) against ``rasterize_pallas(interpret=True)``.

Tolerance: that of tests/test_torch_raster.py (tids differ on at most
0.1% of pixels, depth within 1e-6 where they agree; the depth residue is
XLA's FMA contraction inside the traced kernel body). Among the port's own
outputs there is no tolerance: the layouts, the plain version and the
full rasterize are equal (torch.equal).
"""
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crychic_renderer_tpu.ops import raster_pallas as rp
from crychic_renderer_tpu_torch.experiments import bin_decomp_probe as bd
from crychic_renderer_tpu_torch.experiments import fma_kernel_probe as fma
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from test_torch_raster import _compare
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = ["bin_triangles", "tile_bbox", "tri_of_pair", "packed_gather",
          "key_sort", "histogram", "build_records", "kernel_only",
          "rasterize"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def views():
    """view -> (JAX tris, port tris, W, H, capacity, JAX xrange, port
    xrange, with_ids) of the cascade scene's main view (256x128, 11.6k
    pairs) and its 4-cascade atlas (4 x 64 wide, 12.9k pairs)."""
    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.config import RenderConfig
    from crychic_renderer_tpu.models.scene import build_cascade_scene
    from crychic_renderer_tpu.passes import frame as jfr

    cfg = RenderConfig(width=256, height=128, shadow_map_size=64,
                       pair_capacity=1 << 15, shadow_pair_capacity=1 << 15,
                       ssao_enabled=False)
    r = Renderer(build_cascade_scene(), cfg, auto_capacity=False)
    consts = r.frame_constants(0.0)
    main, _ = jax.jit(functools.partial(jfr.main_view_tris, cfg=cfg))(
        r.device_scene, consts)
    atlas, xr = jax.jit(lambda s, c: jfr.shadow_atlas_tris(
        s, c.shadow_visibility, c.cascade_view_projs, cfg))(
            r.device_scene, consts)

    def port(tris):
        return rz.ScreenTris(*(_t(x) for x in tris))

    return {
        "main": (main, port(main), 256, 128, 1 << 15, None, None, True),
        "atlas": (atlas, port(atlas), 256, 64, 1 << 15, xr,
                  tuple(_t(x) for x in xr), False),
    }


class _InterpretPallas:
    """The pallas module with pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def jax_fma_probe():
    """experiments/fma_kernel_probe.py, loaded by path, its kernel run in
    interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "fma_kernel_probe", os.path.join(REPO, "experiments",
                                         "fma_kernel_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    probe.pl = _InterpretPallas()
    return probe


@pytest.mark.parametrize("view", ["main", "atlas"])
@pytest.mark.parametrize("layout", ["t", "l"])
def test_k4_matches_jax_fma_kernel(views, jax_fma_probe, view, layout):
    jtris, tris, W, H, cap, jxr, xr, ids = views[view]
    # 4 tiles per grid step (the probe's default is 16): the same
    # function, with fewer per-tile conditions to interpret per block
    d_ref, t_ref = jax_fma_probe.rasterize_fma(
        jtris, W, H, cap, with_ids=ids, xrange=jxr, layout=layout,
        tiles_per_prog=4)
    d, t = fma.rasterize_fma(tris, W, H, cap, with_ids=ids, xrange=xr,
                             layout=layout)
    assert bool((d < 1.0).any())
    _compare(d_ref, t_ref, d, t, f"K4 {view} {layout}")


@pytest.mark.parametrize("view", ["main", "atlas"])
def test_k4_layouts_equal_plain(views, view):
    _, tris, W, H, cap, _, xr, ids = views[view]
    rec, starts, counts, over = raster.binned_records(tris, W, H, cap, xr)
    assert not bool(over)
    plain = raster.rasterize_plain(rec, starts, counts, W, H, ids,
                                   xr is not None)
    for layout in fma.LAYOUTS:
        d, t = fma.rasterize_fma(tris, W, H, cap, ids, xr, layout)
        assert torch.equal(d, plain[0]), layout
        assert (t is None) == (not ids)
        assert t is None or torch.equal(t, plain[1]), layout
    with pytest.raises(ValueError, match="layout"):
        fma.rasterize_fma(tris, W, H, cap, ids, xr, "x")


def test_field_wrapper_rejects_other_devices():
    rec = torch.empty((16, 128), device="meta")
    st = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        raster.raster_tiles_field(rec, st, st, 256, 8)


def test_k5_decompose_times_every_piece(views):
    _, tris, W, H, cap, _, xr, ids = views["main"]
    ms = bd.decompose("main view", tris, W, H, cap, xr, ids, reps=1)
    assert list(ms) == PIECES
    assert all(np.isfinite(v) and v > 0 for v in ms.values()), ms


@pytest.mark.parametrize("view", ["main", "atlas"])
def test_k5_pieces_are_bin_triangles(views, view):
    """The pieces repeat bin_triangles' steps: their sort and histogram
    give its order, sorted_tile, starts and counts."""
    _, tris, W, H, cap, _, xr, ids = views[view]
    fns = bd.pieces(tris, W, H, cap, xr, ids)
    bins = fns["bin_triangles"]()
    sorted_tile, order = fns["key_sort"]()
    starts, counts = fns["histogram"]()
    for got, want in ((sorted_tile, bins.sorted_tile), (order, bins.order),
                      (starts, bins.starts), (counts, bins.counts)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("view", ["main", "atlas"])
def test_k5_kernel_alone_matches_rasterize_and_pallas(views, view):
    jtris, tris, W, H, cap, jxr, xr, ids = views[view]
    fns = bd.pieces(tris, W, H, cap, xr, ids)
    d, t = fns["kernel_only"]()
    d_full, t_full, over = fns["rasterize"]()
    assert not bool(over)
    assert torch.equal(d, d_full)
    assert (t is None and t_full is None) or torch.equal(t, t_full)
    if ids:
        d_ref, t_ref = rp.rasterize_pallas(jtris, W, H, cap, interpret=True)
    else:
        d_ref, t_ref = rp.rasterize_pallas(jtris, W, H, cap, tile_h=8,
                                           with_ids=False, xrange=jxr,
                                           interpret=True, tiles_per_prog=32)
    _compare(d_ref, t_ref, d, t, f"K5 {view}")
