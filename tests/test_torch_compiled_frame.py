"""The port's compiled frame (app/renderer.py: _pack_frame_constants,
_unpack_frame_constants, frame_packed, rebind_frame_fn; app/graphs.py)
on the CPU, against the JAX Renderer's.

On the card Renderer.render replays a CUDA graph of frame_packed; on the
CPU the same frame_packed runs eagerly, so these tests hold everything but
the capture (tests/test_torch_cuda.py holds the replay on the card):

- the packed constants equal the JAX Renderer's bit for bit (config 4,
  config 5 from the SMALL synthetic asset set, the fence with its alpha
  visibility), and unpack to the FrameConstants leaves;
- Renderer.render equals render_frame on frame_constants bit for bit, and
  the JAX Renderer.render within the port's frame bound (at most 0.5% of
  pixels with a max-RGB |diff| above 0.02);
- after resize, a grown capacity and an outside replacement of self.cfg,
  the next frame equals a fresh Renderer's (the JAX Renderer needs an
  explicit rebind_frame_fn() after the last);
- a BoltAnim slot change reaches the packed frame through the bound
  mat_pair tensor, written in place;
- the compiled frame's map buffers (ops/pcf.OwnedMaps) and its scene
  check (graphs._same_leaves).

Every frame at 160x90 with 128^2 maps: configs 1 (the frames and the
rebinds: cheap on the CPU) and 5, and the constants of config 4 and the
fence; the JAX Renderers are built without capacity autosizing where
only their constants are read.
"""
import dataclasses

import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu_torch.app import graphs
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.ops import pcf
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND
from torch_threads import cap_torch_threads

cap_torch_threads()

SMALL = dict(width=160, height=90, shadow_map_size=128)
TIMES = (0.0, 0.1)  # BoltAnim frames 0 and 3 (30 fps over 15 frames)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The SMALL synthetic set, both packages' REF_MODELS at its Models."""
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.SMALL, seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsb, "REF_MODELS", paths["models"])
    mp.setattr(tsb, "REF_MODELS", paths["models"])
    try:
        yield paths
    finally:
        mp.undo()


def _scene(pkg, name):
    if name == "fence":
        return pkg.fence_scene(alpha_test=True)
    return pkg.CONFIGS[int(name[-1])]()


def _port(name, assets=None, **kw):
    scene, cfg, lights = _scene(tsb, name)
    if name == "config5":
        kw.update(asset_dir=assets["textures"],
                  sky_cubemap_path=assets["sky_cube"])
    return tren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                         lights=lights, device="cpu", **kw)


@pytest.mark.parametrize("name", ["config4", "config5", "fence"])
def test_packed_constants_equal_jax(name, assets):
    """The port packs the JAX Renderer's vector bit for bit, and unpacks
    it to the leaves FrameConstants.from_numpy makes."""
    scene, cfg, lights = _scene(jsb, name)
    rj = jren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                       lights=lights, auto_capacity=False)
    rt = _port(name, assets, auto_capacity=False)
    n = [rt.scene.opaque.num_instances, rt.scene.shadow.num_instances,
         rt.scene.alpha.num_instances if rt.scene.alpha else 0]
    assert (name == "fence") == (n[2] > 0)
    for t in TIMES:
        want = rj._pack_frame_constants(rj.frame_constants_np(t))
        got = rt._pack_frame_constants(rt.frame_constants_np(t))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (16 * 4 + 3 + 64 * 2 + 1 + sum(n),)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        consts = rt._unpack_frame_constants(torch.from_numpy(got), *n)
        ref = rt.frame_constants(t)
        for f in dataclasses.fields(fr.FrameConstants):
            a, b = getattr(consts, f.name), getattr(ref, f.name)
            if b is None:
                assert a is None, f.name
            else:
                assert a.shape == b.shape and torch.equal(a, b), f.name


def test_render_equals_render_frame_and_jax():
    """render() is frame_packed on the packed constants: a new tensor
    per call, bit-equal to render_frame on frame_constants, and within
    the frame bound of the JAX Renderer's frame (config 1; config 4's
    render() is held against the live JAX frame by test_torch_frame.py)."""
    r = _port("config1")
    img = r.render(0.1)
    again = r.render(0.1)
    assert img is not again and torch.equal(img, again)
    want = fr.render_frame(r.device_scene, r.frame_constants(0.1), r.cfg)
    assert torch.equal(img, want)
    r.check_overflow()
    scene, cfg, lights = jsb.CONFIGS[1]()
    ref = jren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                        lights=lights).render_np(0.1)
    got = np.clip(img.numpy(), 0.0, 1.0)
    diff = np.abs(ref - got).max(axis=-1)
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert (diff > 0.02).mean() <= PIX_BOUND, (diff > 0.02).mean()


def _config1(**over):
    """Config 1 on the CPU at SMALL size updated with `over`."""
    scene, cfg, lights = tsb.CONFIGS[1]()
    return tren.Renderer(scene, dataclasses.replace(cfg, **{**SMALL, **over}),
                         lights=lights, device="cpu")


def _rebind_resize():
    r = _config1()
    r.resize(128, 72)
    return r, _config1(width=128, height=72)


def _rebind_capacity():
    """At 640x360 the start pose needs 6 shade tiles (capacity 64); a
    closer pose needs 72, and ensure_capacity grows the capacity. The
    fresh Renderer sizes its capacities at that pose."""
    r = _config1(width=640, height=360)
    r.camera.look_at((0.0, 1.0, -3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    r.ensure_capacity(0.0)
    fresh = _config1(width=640, height=360)
    fresh.camera = r.camera
    fresh._autosize_capacity()
    fresh.rebind_frame_fn()
    return r, fresh


def _rebind_cfg():
    """An outside replacement of self.cfg (the cascade debug view)."""
    r = _config1()
    r.cfg = dataclasses.replace(r.cfg, debug_view="cascades")
    return r, _config1(debug_view="cascades")


@pytest.mark.parametrize("change", [_rebind_resize, _rebind_capacity,
                                    _rebind_cfg],
                         ids=["resize", "ensure_capacity", "cfg_replaced"])
def test_rebind_matches_a_fresh_renderer(change):
    """A Renderer bound at construction, then changed, binds the new cfg
    and renders its next frame as a Renderer built for the new state
    does (config 1)."""
    r, fresh = change()
    got = r.render(0.0)
    assert r._bound_cfg == r.cfg == fresh.cfg
    assert torch.equal(got, fresh.render(0.0))
    r.check_overflow()


def test_ensure_capacity_grows_the_bound_cfg():
    """The pose of _rebind_capacity outruns the start capacity, so the
    bound cfg changes (and the frame rebinds) there."""
    r, _ = _rebind_capacity()
    assert r.cfg.shade_tile_capacity == 128
    assert r._bound_cfg.shade_tile_capacity == 128


def test_bolt_anim_slot_reaches_the_packed_frame(assets):
    """Config 5's BoltAnim pair is written into the scene's mat_pair
    tensor, the one the frame was bound to: the frame at t = 0.1 shows
    pair 7 where t = 0 showed pair 4, and equals render_frame there."""
    r = _port("config5", assets)
    mat_pair = r.device_scene.mat_pair
    img0 = r.render(TIMES[0])
    assert int(mat_pair[6]) == 4
    img1 = r.render(TIMES[1])
    assert r.device_scene.mat_pair is mat_pair and int(mat_pair[6]) == 7
    assert int(r._base_mat_pair[6]) == 4
    assert (np.abs(img1.numpy() - img0.numpy()).max(axis=-1) > 0.02).any()
    assert torch.equal(img1, fr.render_frame(
        r.device_scene, r.frame_constants(TIMES[1]), r.cfg))


def test_owned_maps_keep_their_buffers():
    """Inside owned_maps, the k-th quantize_map of a frame writes into
    buffer k, the same tensor every frame, with quantize_map's bits; the
    soft PCF reads it (the plain version on the CPU); a second map makes
    a second buffer; outside the block nothing is owned."""
    rng = np.random.default_rng(3)
    maps = [torch.from_numpy(rng.uniform(-0.1, 1.1, (4, 64, 64))
                             .astype(np.float32)) for _ in range(2)]
    params = pcf.receiver_params(
        torch.from_numpy(np.c_[rng.uniform(0, 1, (50, 3)),
                               np.ones(50)].astype(np.float32)),
        torch.from_numpy(rng.integers(0, 4, 50)), 64)
    owned = pcf.OwnedMaps()
    seen = []
    for _ in range(2):
        with pcf.owned_maps(owned):
            q = [pcf.quantize_map(m) for m in maps]
            got = pcf.soft_pcf(q[0], params, 2.5)
        seen.append([t.data_ptr() for t in q])
        for a, m in zip(q, maps):
            assert torch.equal(a, pcf.quantize_map(m))
        assert owned.texture(q[0]) == (0, 0) and owned.held()
        assert torch.equal(got, pcf.soft_pcf_plain(q[0], params, 2.5))
    assert seen[0] == seen[1] and seen[0][0] != seen[0][1]
    assert owned.texture(pcf.quantize_map(maps[0])) is None
    owned.release()
    assert not owned.held()


def test_scene_leaves_bind_by_identity():
    """The compiled frame captures anew when a device-scene leaf is not
    the tensor it bound: mat_pair written in place is the same tensor,
    resize's new SSAO random field is not."""
    r = _config1()
    bound = graphs._leaves(r.device_scene)
    assert graphs._same_leaves(bound, graphs._leaves(r.device_scene))
    r.device_scene.mat_pair.copy_(r.device_scene.mat_pair + 1)
    assert graphs._same_leaves(bound, graphs._leaves(r.device_scene))
    r.resize(128, 72)
    assert not graphs._same_leaves(bound, graphs._leaves(r.device_scene))
    assert r.compiled_frame is None  # the CPU runs frame_packed eagerly
