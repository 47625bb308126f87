"""What the compiled band-sharded frame (parallel/graphs.py) stands on,
on the CPU: the u16-packed atlas gather, a band frame with no host sync,
the piecewise capture's order, and profile_frame's stages.

One gloo job of 4 CPU ranks renders, per config, the band frame with the
atlas gathered as f32 (packed_atlas=False; also the warm-up frame), then
the band frame as it is by default under a TorchDispatchMode that counts
host reads (aten._local_scalar_dense: int(), float(), bool(), .item())
and tensors made from host data (aten.lift_fresh). Configs: config 4 at
1/8 size (240x135, 256^2 maps) with the zero-radius PCF, with the soft
disk and with the fast preset, its forward Blinn-Phong frame, the fence
at 160x90, over all 4 ranks, and config 4 on 2 x 2 replica groups. The
plain raster and PCF versions read the host by design and are left out
of the count (the card launches the kernels instead). On the card,
chip_smoke.py phase 25 and the card-only tests capture the frame, which
a host sync would make raise.

Tolerances: the packed-atlas frame torch.equal to the f32-gather frame
(quantization is per texel and commutes with the reassembly); against the
port's render_frame max |diff| <= 1e-5 and at most 1e-3 of pixels above
0.02 (tests/test_multichip.py's bound); against the JAX package's
render_frame on the interpret-mode kernel at most 0.5% of pixels above
0.02 (the port's frame bound); the packed words equal to the JAX
package's pack_depth_rows_u16 bit for bit.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app import graphs, profiler
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.ops import pcf, raster, tally
from crychic_renderer_tpu_torch.parallel import launch, sharded
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_app import _profile_keys
from test_torch_bench import HostReads
from torch_threads import cap_torch_threads

cap_torch_threads()

SHARD_MAX = 1e-5
SHARD_FRAC = 1e-3
# the ranks import this module: what imports jax is imported where used
PACKED = ("zero", "soft", "fast", "zero_2x2")
UNPACKED = ("forward", "fence")


class StandInGraph:
    """A CUDA graph's stand-in for app/graphs.Pieces: it logs its calls."""

    def __init__(self, log):
        self.log = log

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.log.append(("begin", pool, capture_error_mode))

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("graph")

    def pool(self):
        return "pool of graph 0"


def _piecewise(render, scene, c, cfg, mesh):
    """The band frame through Pieces with stand-in graphs, split at its
    gathers as a capture splits it, then Pieces.replay. On the CPU the
    frame's ops run while it is "captured", so each gather is also made
    at the split, where the card would make it only at replay."""
    log = []
    pieces = graphs.Pieces(lambda: StandInGraph(log))

    def split(gather, out, x):
        gather(out, x)

        def logged(out, x):
            log.append("gather")
            gather(out, x)

        pieces.split(logged, out, x)

    before = tally.snapshot()
    pieces.begin()
    with sharded.split_gathers(split):
        img = render(scene, c, cfg, mesh)
    pieces.end()
    made = tally.since(before).get("gathers", 0)
    captured = list(log)
    log.clear()
    pieces.replay()
    return dict(capture=captured, replay=list(log), graphs=len(pieces.graphs),
                steps=len(pieces.steps), gathers=made, img=img.numpy())


def rank_body(scenes, consts, jobs):
    """One rank: for each (name, cfg, scene index, consts indices) job the
    f32-gather band frame (also the warm-up: it makes the frame's device
    constants) and the counted frame; on the first job also the
    piecewise run. Returns {name: results}."""
    dev = torch.device("cpu")
    dscenes = [fr.DeviceScene.from_numpy(s, dev) for s in scenes]
    dconsts = [fr.FrameConstants.from_numpy(c, dev) for c in consts]
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
    out = {}
    for k, (name, cfg, si, ci) in enumerate(jobs):
        if len(ci) == 1:
            mesh = sharded.make_mesh()
            scene, c = dscenes[si], dconsts[ci[0]]
            render = sharded.render_frame_sharded
        else:
            mesh = sharded.make_mesh2(len(ci), 4 // len(ci))
            scene = sharded.stack_frames([dscenes[si]] * len(ci))
            c = sharded.stack_frames([dconsts[i] for i in ci])
            render = sharded.render_frames_replicated
        # the warm-up frame: the f32-gather one
        f32 = render(scene, c, cfg, mesh, packed_atlas=False).numpy()
        mode.seen.clear()
        stats = {}
        with mode:
            img = render(scene, c, cfg, mesh, stats)
        res = dict(img=img.numpy(), reads=dict(mode.seen), f32=f32,
                   overflowed=any(bool(v) for v in stats.values()))
        if k == 0:
            res["piecewise"] = _piecewise(render, scene, c, cfg, mesh)
        out[name] = res
    return out


@pytest.fixture(scope="module")
def setup():
    """The port's and the JAX package's 1/8 renderers of config 4 on one
    scene (test_torch_sharded.renderers), the other configs' renderers,
    and the constants (c1: the camera moved)."""
    from test_torch_fence import SMALL, fence_chains
    from test_torch_frame import _small
    from test_torch_sharded import renderers

    rj, rt = renderers()
    c0 = rt.frame_constants(0.0)
    cam = copy.deepcopy(rt.camera)
    rt.camera.walk(2.0)
    rt.camera.rotate_y(0.1)
    c1 = rt.frame_constants(0.5)
    rt.camera = cam
    scene, cfg, lights = tsb.CONFIGS[4]()
    fast = tren.Renderer(scene, _small(cfg).fast_preset(), lights=lights,
                         device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tren, "load_texture_chains", fence_chains)
    try:
        scene, cfg, lights = tsb.fence_scene(alpha_test=True)
        fence = tren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                              lights=lights, device="cpu")
    finally:
        mp.undo()
    return dict(rj=rj, rt=rt, fast=fast, fence=fence, c0=c0, c1=c1)


@pytest.fixture(scope="module")
def spawned(setup):
    rt, fast, fence = setup["rt"], setup["fast"], setup["fence"]
    cfg2 = sharded.autosize_band_capacities(rt.device_scene, setup["c0"],
                                            rt.cfg, 2)
    jobs = [("zero", rt.cfg, 0, (0,)),
            ("soft", dataclasses.replace(rt.cfg, pcf_radius_texels=2.5), 0,
             (0,)),
            ("fast", fast.cfg, 1, (1,)),
            ("forward", dataclasses.replace(rt.cfg, deferred=False,
                                            use_pbr=False), 0, (0,)),
            ("fence", fence.cfg, 2, (2,)),
            ("zero_2x2", cfg2, 0, (0, 3))]
    scenes = [rt.device_scene, fast.device_scene, fence.device_scene]
    consts = [setup["c0"], fast.frame_constants(0.0),
              fence.frame_constants(0.0), setup["c1"]]
    ranks = launch.spawn_ranks(
        rank_body, 4, "gloo", "cpu",
        ([launch.host_leaves(s) for s in scenes],
         [launch.host_leaves(c) for c in consts], jobs), timeout=600)
    return dict(ranks=ranks, jobs={j[0]: j for j in jobs},
                scenes=scenes, consts=consts)


def _group(spawned, name):
    """The results of the ranks that rendered job `name`'s frame at
    consts[0] of its consts indices (ranks 0-1 on the 2 x 2 job)."""
    n = 2 if name == "zero_2x2" else 4
    return [spawned["ranks"][r][name] for r in range(n)]


@pytest.mark.parametrize("name", PACKED)
def test_packed_atlas_frame_equals_f32_gather(spawned, name):
    """The frame whose atlas travels u16-packed (the default here) is
    torch.equal to the frame whose atlas is gathered as f32, on every
    rank, with no overflow; every rank of a group has the same frame."""
    for rank in range(4):
        got = spawned["ranks"][rank][name]
        assert np.array_equal(got["img"], got["f32"]), (name, rank)
        assert not got["overflowed"], (name, rank)
    group = _group(spawned, name)
    for got in group:
        assert np.array_equal(got["img"], group[0]["img"]), name


@pytest.mark.parametrize("name", PACKED + UNPACKED)
def test_packs_atlas_where_the_jax_package_does(spawned, name):
    """The JAX rule: packed unless the alpha punch min-merges into the
    maps (the fence) or the shadow debug quad blits them (the forward
    frame); the f32 frames are the same either way."""
    _, cfg, si, _ = spawned["jobs"][name]
    assert sharded.packs_atlas(spawned["scenes"][si], cfg) == (
        name in PACKED)


@pytest.mark.parametrize("name", PACKED + UNPACKED)
def test_band_frame_makes_no_host_sync(spawned, name):
    """After a warm-up frame the band frame reads no tensor on the host
    and makes no tensor of host data, on any rank."""
    for rank in range(4):
        assert spawned["ranks"][rank][name]["reads"] == {}, rank


@pytest.mark.parametrize("n", [2, 4])
def test_packed_band_frame_matches_port_and_jax(setup, spawned, n):
    """The packed-atlas band frame on n ranks against the port's
    render_frame and the JAX package's on the same scene and constants."""
    from test_torch_frame import PIX_BOUND

    img = _group(spawned, "zero" if n == 4 else "zero_2x2")[0]["img"]
    rt = setup["rt"]
    ref = fr.render_frame(rt.device_scene, setup["c0"], rt.cfg).numpy()
    diff = np.abs(img - ref).max(axis=-1)
    assert diff.max() <= SHARD_MAX and (diff > 0.02).mean() <= SHARD_FRAC
    jdiff = np.abs(np.clip(img, 0.0, 1.0)
                   - setup["rj"].render_np(0.0)).max(axis=-1)
    frac = (jdiff > 0.02).mean()
    assert frac <= PIX_BOUND, f"n={n}: {frac:.4%} of pixels > 0.02"


def test_packed_stripes_equal_jax_pack(setup):
    """Each owner's atlas stripes (the band raster, 4 owners) packed by
    sharded.pack_stripes are the words of the JAX package's
    shadows.pack_depth_rows_u16 of the same rows, and unpack to the
    16-bit depths of ops.pcf.quantize_bits; rows of edge values too
    (outside [0, 1], 1.0, halfway between two steps)."""
    import jax.numpy as jnp

    from crychic_renderer_tpu.ops import shadows as jshadows

    rt, c = setup["rt"], setup["c0"]
    cfg, S = rt.cfg, rt.cfg.shadow_map_size
    tris, xr = fr.shadow_atlas_tris(rt.device_scene, c.shadow_visibility,
                                    c.cascade_view_projs, cfg)
    rows = []
    for d in range(4):
        depth, _, _ = raster.rasterize(tris, 4 * S, S,
                                       cfg.shadow_pair_capacity,
                                       with_ids=False, xrange=xr,
                                       row_stride=(4, d))
        rows.append(depth)
    steps = np.arange(4 * S, dtype=np.float32) - 8.0
    edge = np.stack([steps / 65535.0, (steps + 0.5) / 65535.0,
                     1.0 - steps / 65535.0, np.linspace(-2, 2, 4 * S)])
    rows.append(torch.from_numpy(edge.astype(np.float32)))
    for depth in rows:
        assert bool(((depth > 0) & (depth < 1)).any())
        words = sharded.pack_stripes(depth).numpy().view(np.uint32)
        want = np.asarray(jshadows.pack_depth_rows_u16(
            jnp.asarray(depth.numpy())))
        np.testing.assert_array_equal(words, want)
        texels = np.stack([want & 0xFFFF, want >> 16], axis=-1).reshape(
            depth.shape)
        bits = pcf.quantize_bits(depth).numpy().astype(np.int64) & 0xFFFF
        np.testing.assert_array_equal(bits, texels)


def test_piecewise_capture_order(spawned):
    """The band frame split at its gathers (sharded.split_gathers into
    app/graphs.Pieces, stand-in graphs): every gather the frame makes
    ends a graph, so the graphs are the gathers + 1, each opened in the
    first's pool in the global capture mode; a replay runs graph, gather,
    graph, ... in capture order. The frame is the eager one."""
    for rank in range(4):
        got = spawned["ranks"][rank]["zero"]
        p = got["piecewise"]
        k = p["gathers"]
        assert k > 1 and p["steps"] == k and p["graphs"] == k + 1
        assert p["capture"] == (
            [("begin", None, "global"), "end"]
            + [("begin", "pool of graph 0", "global"), "end"] * k)
        assert p["replay"] == ["graph", "gather"] * k + ["graph"]
        assert np.array_equal(p["img"], got["img"])


def test_profile_frame_keeps_keys_and_chain(setup, monkeypatch):
    """profile_frame reports its keys (the JAX profiler's with the
    lighting's two stages, test_torch_app._profile_keys), and the chain its
    timed stages hand on gives render_frame's image bit for bit."""
    scene, cfg, lights = tsb.CONFIGS[4]()
    r = tren.Renderer(scene, dataclasses.replace(
        cfg, width=160, height=90, shadow_map_size=128), lights=lights,
        device="cpu")
    chains = []
    run_stages = profiler.run_stages

    def spy(*args):
        chains.append(run_stages(*args))
        return chains[-1]

    monkeypatch.setattr(profiler, "run_stages", spy)
    report = profiler.profile_frame(r, reps=1)
    assert list(report) == _profile_keys()
    assert all(np.isfinite(v) and v > 0 for v in report.values()), report
    want = fr.render_frame(r.device_scene, r.frame_constants(0.0), r.cfg)
    assert len(chains) == 1 and torch.equal(chains[0], want)
