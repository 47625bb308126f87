"""The band-sharded frame of the two families the JAX package renders
besides the kernel path with static tables, over 2 gloo CPU ranks: the
pure-XLA raster (use_pallas=False: each rank's interleaved 32-row tiles
of the main view and of each cascade, gathered as f32) and a scene whose
draws carry no static tables (the vertex-sharded vertex stage and the
triangle-sharded corner gathers of _band_vertex_records,
_band_shadow_tri_world and _chunk_gather_rows).

Inputs: BASELINE config 4 at 1/8 size (240x135, 256^2 maps), the scene
from the JAX scene's leaves. One gloo job of 2 CPU ranks renders each
family's band frame eagerly, then again under a TorchDispatchMode that
counts host reads (the plain raster and PCF versions, and the CPU's stop
after the valid pairs in rasterize_binned, read the host by design and
are left out; the card runs the fixed capacity), then through
app/graphs.Pieces with stand-in graphs split at its gathers, which
counts the graphs a gloo rank's compiled band frame holds: 14 for the
pure-XLA family, 21 without static tables (18 for the kernel path with
them, test_torch_sharded_compiled.py).

Tolerances: against the port's render_frame of the same scene and cfg
max |diff| <= 1e-5 and at most 1e-3 of pixels above 0.02
(tests/test_multichip.py's bound); against the JAX package's frame of
the scene without static tables (its CPU path, the XLA raster) at most
0.5% of pixels above 0.02; band_requirements equal to the JAX package's
on the pure-XLA path.
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.ops import pcf, raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.parallel import launch, sharded
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

SHARD_MAX = 1e-5
SHARD_FRAC = 1e-3
N = 2
# graphs of a gloo rank's compiled band frame, per family (config 4)
GRAPHS = {"xla": 14, "no_statics": 21}


def rank_body(scenes, consts, jobs):
    """One rank: per (name, cfg, scene index) job the eager band frame,
    the frame again with its host reads counted, and the piecewise run.
    Returns {name: results}. The ranks import this module: what imports
    jax is imported where used."""
    from test_torch_bench import HostReads
    from test_torch_sharded_compiled import _piecewise

    dev = torch.device("cpu")
    dscenes = [fr.DeviceScene.from_numpy(s, dev, attach_statics=False)
               for s in scenes]
    c = fr.FrameConstants.from_numpy(consts, dev)
    mode = HostReads()

    def paused(fn):
        def run(*args, **kwargs):
            mode.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        return run

    raster.rasterize_plain = paused(raster.rasterize_plain)
    pcf.soft_pcf_plain = paused(pcf.soft_pcf_plain)
    rz.rasterize_binned = paused(rz.rasterize_binned)
    mesh = sharded.make_mesh()
    out = {}
    for name, cfg, si in jobs:
        scene = dscenes[si]
        stats = {}
        img = sharded.render_frame_sharded(scene, c, cfg, mesh, stats)
        mode.seen.clear()
        with mode:
            again = sharded.render_frame_sharded(scene, c, cfg, mesh)
        out[name] = dict(
            img=img.numpy(), again=again.numpy(), reads=dict(mode.seen),
            flags=sorted(stats),
            overflowed=any(bool(v) for v in stats.values()),
            piecewise=_piecewise(sharded.render_frame_sharded, scene, c,
                                 cfg, mesh))
    return out


@pytest.fixture(scope="module")
def spawned():
    """The port's Renderer of config 4 at 1/8 size on the JAX scene's
    leaves, the pure-XLA cfg at the JAX Renderer's capacities, the 2-rank
    job and the single-card frames; the JAX package's frame of the scene
    without static tables."""
    import jax

    from crychic_renderer_tpu.app import renderer as jren
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.parallel import sharded as jsharded
    from crychic_renderer_tpu.passes import frame as jfr
    from test_torch_frame import _leaves, _small
    from test_torch_no_statics import jax_without_statics

    scene, cfg, lights = CONFIGS[4]()
    rj = jren.Renderer(scene, _small(cfg), lights=lights)
    tscene, tcfg, tlights = tsb.CONFIGS[4]()
    rt = tren.Renderer(tscene, _small(tcfg), lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    xcfg = dataclasses.replace(rt.cfg, use_pallas=False,
                               **{k: getattr(rj.cfg, k) for k in (
                                   "pair_capacity", "shadow_pair_capacity",
                                   "bin_cap", "shadow_bin_cap")})
    bare = fr.strip_draw_statics(rt.device_scene)
    c = rt.frame_constants(0.0)
    jobs = [("xla", xcfg, 0), ("no_statics", rt.cfg, 1)]
    ranks = launch.spawn_ranks(
        rank_body, N, "gloo", "cpu",
        ([launch.host_leaves(s) for s in (rt.device_scene, bare)],
         launch.host_leaves(c), jobs), timeout=600)
    single = {"xla": fr.render_frame(rt.device_scene, c, xcfg).numpy(),
              "no_statics": fr.render_frame(bare, c, rt.cfg).numpy()}
    jc = rj.frame_constants(0.0)
    ref = np.clip(np.asarray(jax.jit(
        lambda s, c: jfr.render_frame(s, c, rj.cfg))(
            jax_without_statics(rj.device_scene), jc)), 0.0, 1.0)
    jreq = jax.jit(lambda s, c: jsharded.band_requirements(
        s, c, rj.cfg, N))(rj.device_scene, jc)
    return dict(ranks=ranks, single=single, jax=ref, rt=rt, xcfg=xcfg, c=c,
                jreq={k: int(v) for k, v in jreq.items()})


@pytest.mark.parametrize("name", ["xla", "no_statics"])
def test_band_frame_matches_port(spawned, name):
    """Both ranks return the same frame, equal to render_frame's within
    the bound, with no overflow; the eager frame again is the same."""
    img = spawned["ranks"][0][name]["img"]
    for rank in range(N):
        got = spawned["ranks"][rank][name]
        assert np.array_equal(got["img"], img) and not got["overflowed"]
        assert np.array_equal(got["again"], img)
    ref = spawned["single"][name]
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref).max(axis=-1)
    assert diff.max() <= SHARD_MAX and (diff > 0.02).mean() <= SHARD_FRAC


@pytest.mark.parametrize("name", ["xla", "no_statics"])
def test_band_frame_matches_jax(spawned, name):
    img = np.clip(spawned["ranks"][0][name]["img"], 0.0, 1.0)
    frac = (np.abs(img - spawned["jax"]).max(axis=-1) > 0.02).mean()
    assert frac <= 0.005, f"{name}: {frac:.4%} of pixels > 0.02"


@pytest.mark.parametrize("name", ["xla", "no_statics"])
def test_band_frame_graphs_and_host_reads(spawned, name):
    """The piecewise capture of each family: a graph per stretch between
    two gathers (GRAPHS), replayed in order; the band frame reads no
    tensor on the host. The pure-XLA path flags cut tile runs."""
    for rank in range(N):
        got = spawned["ranks"][rank][name]
        p = got["piecewise"]
        assert p["graphs"] == p["gathers"] + 1 == GRAPHS[name], p["graphs"]
        assert p["replay"] == ["graph", "gather"] * p["gathers"] + ["graph"]
        assert np.array_equal(p["img"], got["img"])
        assert got["reads"] == {}, (rank, got["reads"])
    flags = spawned["ranks"][0][name]["flags"]
    bins = {"main_bin_overflowed", "shadow_bin_overflowed"}
    assert bins <= set(flags) if name == "xla" else not bins & set(flags)


def test_band_requirements_match_jax(spawned):
    """The pure-XLA path's worst-rank pair counts (32-row tiles; the
    shadow count the worst cascade's) equal the JAX package's."""
    got = sharded.band_requirements(spawned["rt"].device_scene,
                                    spawned["c"], spawned["xcfg"], N)
    for k in ("band_h", "main_band_pairs", "shadow_band_pairs"):
        assert got[k] == spawned["jreq"][k], (k, got[k], spawned["jreq"][k])
