"""BASELINE config 5 (skull + car + instanced boxes + grid, PBR, shadows,
SSAO, the animated BoltAnim slot) and configs 2 and 3 as written, built
by the port from files on disk against the JAX package.

The files are the synthetic asset set
(crychic_renderer_tpu_torch/experiments/synthetic_assets.py) at its SMALL
size, written once per module: 64² textures (DXT5 bricks, DXT1 tile,
RGBA8 normal maps with full chains), 60 BoltAnim and 120 FireAnim BMP
frames of 64x64, a DXT1 cubemap of 32² faces, the published car (1,860
vertices, 1,850 triangles) and a skull trimmed from the published 60,339
triangles to 2,000 (1,040 vertices) to keep the CPU frames short. Both
packages' scenes_baseline.REF_MODELS point at its Models/.

- configs 2, 3 and 5 build with every scene leaf EQUAL to the JAX
  package's, and config 5's texture chains and pair pool are equal leaf
  for leaf; the set's WireFence.dds decodes in both packages to the
  fence's synthetic wire grid;
- config 5 at 240x135 (256² cascades) with the loaded cube renders
  within the parity bound of the live JAX frame (the JAX frame forced
  onto its Pallas kernel in interpret mode, as tests/test_fuzz_parity.py
  does) at two times that select different BoltAnim frames: at most 0.5%
  of pixels with a max-RGB |diff| above 0.02. Measured: 0.0093% (3 of
  32,400 pixels) at both times, max 0.026, mean 5.3e-5; the 325 pixels
  the animation changes are the same in both packages.
"""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from test_torch_frame import PIX_BOUND
from test_torch_host import _eq, assert_configs_equal
from torch_threads import cap_torch_threads

cap_torch_threads()

# t = 0 shows BoltAnim's first subsampled frame, t = 0.1 its fourth
# (30 fps over 15 frames: int(0.1 * 30) % 15 = 3)
TIMES = (0.0, 0.1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.SMALL, seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsb, "REF_MODELS", paths["models"])
    mp.setattr(tsb, "REF_MODELS", paths["models"])
    try:
        yield paths
    finally:
        mp.undo()


@pytest.mark.parametrize("config", [2, 3, 5])
def test_scene_and_config_equal(assets, config):
    ts = tsb.CONFIGS[config]()
    assert_configs_equal(jsb.CONFIGS[config](), ts)
    skull = next(i for i in ts[0].items if i.name == "skull")
    assert skull.mesh.num_triangles == sa.SMALL.skull[1]


def test_wire_fence_file_decodes_to_the_fence_chain(assets):
    """The set's WireFence.dds (RGBA8, full chain) decodes, in both
    packages, to the wire grid that synthetic_wire_fence patches in."""
    want = tsb.wire_fence_chain()
    for ren in (jren, tren):
        (got,), anim = ren.load_texture_chains(["WireFence"],
                                               assets["textures"])
        assert not anim and len(got) == len(want)
        for m, (a, b) in enumerate(zip(got, want)):
            _eq(a, b, f"{ren.__name__} mip {m}")


def test_texture_chains_and_pair_pool_equal(assets):
    js, ts = jsb.CONFIGS[5]()[0], tsb.CONFIGS[5]()[0]
    tex = assets["textures"]
    jchains, janim = jren.load_texture_chains(js.texture_names, tex)
    tchains, tanim = tren.load_texture_chains(ts.texture_names, tex)
    for slot, (jc, tc) in enumerate(zip(jchains, tchains)):
        assert len(jc) == len(tc)
        for m, (a, b) in enumerate(zip(jc, tc)):
            _eq(a, b, f"slot {slot} mip {m}")
    assert sorted(janim) == sorted(tanim) == [8, 9]
    for slot in janim:
        (jf, jfps), (tf, tfps) = janim[slot], tanim[slot]
        assert jfps == tfps and len(jf) == len(tf) == 15
        for a, b in zip(jf, tf):
            for m, (x, y) in enumerate(zip(a, b)):
                _eq(x, y, f"anim slot {slot} mip {m}")
    jpool, jmat, jspecs = jren.build_pair_pool(js, tex, dual=True)
    tpool, tmat, tspecs = tren.build_pair_pool(ts, tex, dual=True)
    _eq(jpool.data, tpool.data, "pair pool")
    assert (jpool.n_big, jpool.dual) == (tpool.n_big, tpool.dual) == (4, True)
    _eq(jmat, tmat, "mat_pair")
    assert jspecs == tspecs == {6: (4, 15, 30.0)}


@pytest.fixture(scope="module")
def frames(assets):
    """The JAX and the port's config-5 Renderer at 240x135 with the loaded
    cube, each built from the files, and their frames at TIMES."""
    def small(cfg):
        return dataclasses.replace(cfg, width=240, height=135,
                                   shadow_map_size=256)

    kw = dict(asset_dir=assets["textures"],
              sky_cubemap_path=assets["sky_cube"])
    scene, cfg, lights = jsb.CONFIGS[5]()
    rj = jren.Renderer(scene, small(cfg), lights=lights, **kw)
    rj.cfg = dataclasses.replace(rj.cfg, use_pallas=True,
                                 pallas_interpret=True)
    rj._autosize_capacity()
    rj.rebind_frame_fn()
    tscene, tcfg, tlights = tsb.CONFIGS[5]()
    rt = tren.Renderer(tscene, small(tcfg), lights=tlights, device="cpu",
                       **kw)
    out = []
    for t in TIMES:
        ref = rj.render_np(t)
        got = rt.render_np(t)
        out.append((ref, got, rt.device_scene.mat_pair.numpy().copy()))
    return rj, rt, out


def test_loaded_cube_replaces_the_procedural_sky(frames):
    rj, rt, _ = frames
    assert not rt.cfg.procedural_sky and not rj.cfg.procedural_sky
    _eq(np.asarray(rj.device_scene.cubemap),
        rt.device_scene.cubemap.numpy().view(np.uint32), "packed cube")
    assert rt.device_scene.cubemap.shape == (6, 32, 32, 4)


@pytest.mark.parametrize("k", range(len(TIMES)))
def test_frame_matches_jax(frames, k):
    _, rt, out = frames
    ref, got, _ = out[k]
    assert got.shape == ref.shape == (135, 240, 4)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, (f"t={TIMES[k]}: {frac:.4%} of pixels >0.02 "
                               f"(max {diff.max():.4f})")
    rt.check_overflow()


def test_animated_slot_cycles(frames):
    """The two times select different BoltAnim frames: the bolt material's
    pair moves and the frame changes, in both packages alike."""
    _, _, out = frames
    (ref0, got0, pair0), (ref1, got1, pair1) = out
    assert pair0[6] == 4 and pair1[6] == 4 + 3
    moved = np.abs(got1 - got0).max(axis=-1) > 0.02
    jmoved = np.abs(ref1 - ref0).max(axis=-1) > 0.02
    assert moved.any() and jmoved.any()
    assert (moved != jmoved).mean() <= PIX_BOUND
