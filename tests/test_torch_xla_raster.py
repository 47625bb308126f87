"""The port's pure-XLA raster path (RenderConfig.use_pallas=False) against
the JAX package's, on the CPU.

The JAX package's rasterizer (ops/rasterizer.py: setup_triangles,
rasterize_bruteforce, rasterize_binned in its full-screen, contiguous-band
and row_stride modes, raster_stats, rasterize) runs eagerly here
(jax.disable_jit(): jitted XLA contracts a*b+c into FMAs, eager JAX and
torch round every op), so the bound is bit equality: every tid equal and
every depth equal (measured: max |diff| 0.0). Inputs: seeded random
triangles (runs of at most 77 per 32x128 tile) and the main-view
triangles of BASELINE config 4 at 1/8 size (240x135, 256^2 maps), whose
tiles hold up to 4,598 triangles; bin caps below the largest run check
that both packages drop the same pairs.

The frame: the port's Renderer with use_pallas=False against the JAX
Renderer's own CPU frame, which is this path natively (jitted), at 1/8
size: config 4 with the zero-radius PCF and with the soft disk, and
config 1 (forward). Bound: at most 0.5% of pixels with a max-RGB |diff|
above 0.02 (app/compare.py's parity bound). The Renderers' autosized
capacities (bin_cap and shadow_bin_cap included) are equal, and so are
the tile-overflow errors. The per-cascade shadow maps equal JAX's
render_shadow_maps (eager) bit for bit. Against the port's atlas (the
kernel path's, here its plain version) the coverage differs on at most
SHADOW_COVER of the texels (measured 0) and at most SHADOW_FAR of the
texels both cover are more than 1e-3 apart (measured 34 of 86,000,
0.040%): the atlas evaluates tile-local depth planes, this path global
ones, so their roundings differ (9% of covered texels by more than
1e-5), and where two nearly coplanar casters meet another one wins.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app import compare, profiler
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_app import _profile_keys
from test_torch_frame import PIX_BOUND, _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()

SHADOW_COVER = 1e-3  # per-cascade maps vs the atlas: coverage differs
SHADOW_FAR = 1e-3    # ... covered texels more than 1e-3 apart


def _t(a):
    return torch.from_numpy(np.array(a))


def _tris_t(tris):
    return rz.ScreenTris(*(_t(x) for x in tris))


def _random_clip(seed: int, T: int = 400):
    """(V, 4) clip-space vertices of T small triangles over the screen,
    both windings, and (3T,) indices, the vertices listed in a seeded
    order."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-1.0, 1.0, (T, 1, 2))
    v = np.concatenate([cent + rng.uniform(-0.15, 0.15, (T, 3, 2)),
                        rng.uniform(0.0, 1.0, (T, 3, 1)),
                        np.ones((T, 3, 1))], -1).reshape(-1, 4)
    perm = rng.permutation(3 * T)
    idx = np.argsort(perm).astype(np.int32)  # v[idx] is the list above
    return v[perm].astype(np.float32), idx


@pytest.fixture(scope="module")
def random_tris():
    W, H = 300, 140
    clip, idx = _random_clip(0)
    with jax.disable_jit():
        jt = jrz.setup_triangles(jnp.asarray(clip), jnp.asarray(idx), W, H,
                                 cull_backface=False)
    return jt, W, H


@pytest.fixture(scope="module")
def frame():
    """The 1/8-size config-4 JAX Renderer (its XLA path, as on any CPU
    backend), the port's on the same scene leaves with use_pallas=False,
    and the JAX main-view triangles."""
    scene, cfg, lights = JCONFIGS[4]()
    rj = JRenderer(scene, _small(cfg), lights=lights)
    assert not rj.cfg.use_pallas
    tscene, tcfg, tlights = CONFIGS[4]()
    rt = tren.Renderer(tscene, dataclasses.replace(_small(tcfg),
                                                   use_pallas=False),
                       lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    jc = rj.frame_constants(0.0)
    main, _ = jax.jit(lambda s, c: jfr.main_view_tris(s, c, rj.cfg))(
        rj.device_scene, jc)
    return dict(rj=rj, rt=rt, jc=jc, tc=rt.frame_constants(0.0), main=main)


def _modes(n_rows_tiles):
    """(JAX binning kwargs, raster kwargs) of the three modes."""
    half = n_rows_tiles // 2
    return {"full": ({}, {}),
            "band": (dict(ty_lo=1, num_rows=half),
                     dict(tile_row_offset=1, num_tile_rows=half)),
            "stride": (dict(row_stride=(2, 1)), dict(row_stride=(2, 1)))}


def _raster_both(jt, W, H, cap, mode, ids=True):
    kw_b, kw_r = _modes(-(-H // rz.XLA_TILE_H))[mode]
    # the binning is integer work and the bbox a division: jitted it
    # rounds as eager code does (the bins are held equal below)
    bj = jax.jit(lambda t: jrz.bin_triangles(t, W, H, 1 << 15, **kw_b))(jt)
    with jax.disable_jit():
        dj, ij = jrz.rasterize_binned(jt, bj, W, H, cap, with_ids=ids,
                                      **kw_r)
    bt = rz.bin_triangles(_tris_t(jt), W, H, 1 << 15, tile_h=rz.XLA_TILE_H,
                          ty_lo=kw_b.get("ty_lo"),
                          num_rows=kw_b.get("num_rows"),
                          row_stride=kw_b.get("row_stride"))
    for f in bj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(bj, f)),
                                      getattr(bt, f).numpy(), err_msg=f)
    dt, it = rz.rasterize_binned(_tris_t(jt), bt, W, H, cap, with_ids=ids,
                                 **kw_r)
    return (np.asarray(dj), None if ij is None else np.asarray(ij), dt,
            it, int(bt.counts.max()))


@pytest.mark.parametrize("mode", ["full", "band", "stride"])
@pytest.mark.parametrize("cap", [128, 32])
def test_rasterize_binned_matches_jax(random_tris, mode, cap):
    """Seeded triangles: every run fits bin_cap 128; at 32 the longer runs
    are cut, the same pairs in both packages."""
    jt, W, H = random_tris
    dj, ij, dt, it, top = _raster_both(jt, W, H, cap, mode)
    assert dt.shape == dj.shape and (top > cap) == (cap == 32)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(dt.numpy(), dj)
    assert (it.numpy() >= 0).mean() > 0.2
    d2, _ = rz.rasterize_binned(_tris_t(jt), rz.bin_triangles(
        _tris_t(jt), W, H, 1 << 15, tile_h=rz.XLA_TILE_H,
        **_modes(-(-H // 32))[mode][0]), W, H, cap, with_ids=False,
        **_modes(-(-H // 32))[mode][1])
    assert torch.equal(d2, dt)


def test_rasterize_binned_config4_drops_the_same_pairs(frame):
    """Config 4's main view at bin_cap 128, far below its largest run
    (4,598): both packages truncate the same runs, and the truncation
    shows (pixels differ from the untruncated raster)."""
    rt = frame["rt"]
    W, H = rt.cfg.width, rt.cfg.height
    dj, ij, dt, it, top = _raster_both(frame["main"], W, H, 128, "full")
    assert top > 128
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(dt.numpy(), dj)
    full, _, _, _ = rz.binned_raster(_tris_t(frame["main"]), W, H,
                                     rt.cfg.pair_capacity, 1 << 13)
    assert not torch.equal(full, dt)


@pytest.mark.parametrize("backend", ["brute", "binned"])
def test_rasterize_end_to_end_matches_jax(backend):
    """rasterize (setup_triangles + a backend) on seeded vertices and
    indices, culling back faces; rasterize_bruteforce through "brute"."""
    clip, idx = _random_clip(1, T=160)
    W, H = 200, 96
    with jax.disable_jit():
        dj, ij = jrz.rasterize(jnp.asarray(clip), jnp.asarray(idx), W, H,
                               pair_capacity=1 << 13, bin_cap=64,
                               backend=backend)
    dt, it = rz.rasterize(_t(clip), _t(idx), W, H, pair_capacity=1 << 13,
                          bin_cap=64, backend=backend)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).mean() > 0.1


def test_setup_and_raster_stats_match_jax(random_tris, frame):
    clip, idx = _random_clip(0)
    jt, W, H = random_tris
    tt = rz.setup_triangles(_t(clip), _t(idx), W, H, cull_backface=False)
    for f in jt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).numpy(), err_msg=f)
    cfg = frame["rt"].cfg
    for tris, w, h, cap in ((jt, W, H, 1 << 12),
                            (frame["main"], cfg.width, cfg.height, 1 << 12)):
        for th in (None, 8):
            want = jrz.raster_stats(tris, w, h, cap, tile_h=th)
            got = rz.raster_stats(_tris_t(tris), w, h, cap,
                                  tile_h=th or rz.XLA_TILE_H)
            assert got == want, (th, got, want)
    assert rz.raster_stats(_tris_t(frame["main"]), cfg.width, cfg.height,
                           1 << 12)["overflowed"]


@pytest.fixture(scope="module")
def shadow_maps(frame):
    rj, rt = frame["rj"], frame["rt"]
    # runs cut at 256; 32k pairs hold each cascade's and keep the eager
    # sort small
    cut = dict(shadow_bin_cap=256, shadow_pair_capacity=1 << 15)
    with jax.disable_jit():
        ref = np.asarray(jfr.render_shadow_maps(
            rj.device_scene, frame["jc"], dataclasses.replace(rj.cfg, **cut)))
    s, c = rt.device_scene, frame["tc"]
    stats = {}
    got = fr.render_shadow_maps(s, c, dataclasses.replace(rt.cfg, **cut),
                                stats)
    full = fr.render_shadow_maps(s, c, rt.cfg)
    atlas = fr.render_shadow_maps(s, c, dataclasses.replace(
        rt.cfg, use_pallas=True))
    return dict(ref=ref, got=got, stats=stats, full=full, atlas=atlas)


def test_render_shadow_maps_matches_jax(shadow_maps):
    """Each cascade in its own viewport at shadow_bin_cap 256 (cut runs,
    flagged), equal to JAX's render_shadow_maps."""
    got, ref = shadow_maps["got"], shadow_maps["ref"]
    assert got.shape == ref.shape == (4, 256, 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert bool(shadow_maps["stats"]["shadow_bin_overflowed"])
    assert not bool(shadow_maps["stats"]["shadow_overflowed"])
    assert not torch.equal(got, shadow_maps["full"])


def test_render_shadow_maps_matches_the_atlas(frame, shadow_maps):
    """At the autosized shadow_bin_cap (no run cut) the per-cascade maps
    agree with the kernel path's atlas (its plain version here)."""
    full, atlas = shadow_maps["full"].numpy(), shadow_maps["atlas"].numpy()
    assert frame["rt"].capacity_requirements()["shadow_max_tile"] <= \
        frame["rt"].cfg.shadow_bin_cap
    both = (full < 1.0) & (atlas < 1.0)
    assert both.mean() > 0.05
    assert ((full < 1.0) != (atlas < 1.0)).mean() <= SHADOW_COVER
    assert (np.abs(full - atlas)[both] > 1e-3).mean() <= SHADOW_FAR


def test_capacities_match_jax(frame):
    """The Renderer sizes the pure-tensor path as the JAX Renderer does:
    the pair capacities from 32-row tiles (the cascades summed), bin_cap
    and shadow_bin_cap from the largest runs; capacity_requirements'
    counts equal JAX's."""
    rj, rt = frame["rj"], frame["rt"]
    for k in ("pair_capacity", "shadow_pair_capacity", "bin_cap",
              "shadow_bin_cap", "shade_tile_capacity", "ssao_tile_capacity"):
        assert getattr(rt.cfg, k) == getattr(rj.cfg, k), k
    want = rj.capacity_requirements(0.0)
    got = rt.capacity_requirements(0.0)
    assert got == want, (got, want)
    assert got["main_max_tile"] > 1000
    # the kernel path counts on its own 8-row tiles
    kernel = fr.capacity_requirements(
        rt.device_scene, frame["tc"],
        dataclasses.replace(rt.cfg, use_pallas=True))
    assert int(kernel["main_pairs"]) > got["main_pairs"]


@pytest.mark.parametrize("which", ["main", "shadow"])
def test_tile_overflow_errors_match_jax(frame, which):
    """check_capacity raises on a run longer than its bin cap with the
    JAX Renderer's message."""
    rj, rt = frame["rj"], frame["rt"]
    key = "bin_cap" if which == "main" else "shadow_bin_cap"
    saved = rj.cfg, rt.cfg
    try:
        rj.cfg = dataclasses.replace(rj.cfg, **{key: 64})
        rt.cfg = dataclasses.replace(rt.cfg, **{key: 64})
        with pytest.raises(RuntimeError) as want:
            rj.check_capacity(0.0)
        with pytest.raises(tren.CapacityError) as got:
            rt.check_capacity(0.0)
        assert str(got.value) == str(want.value)
        assert re.match(rf"{'shadow ' * (which == 'shadow')}tile overflow",
                        str(got.value))
    finally:
        rj.cfg, rt.cfg = saved


def test_frame_flags_cut_runs(frame):
    """A frame whose runs outrun bin_cap and shadow_bin_cap flags both
    (check_overflow), which the JAX package's frame does not."""
    rt = frame["rt"]
    saved = rt.cfg
    try:
        rt.cfg = dataclasses.replace(rt.cfg, bin_cap=64, shadow_bin_cap=64)
        rt.render(0.0)
        with pytest.raises(RuntimeError) as got:
            rt.check_overflow()
        assert "main tile overflow" in str(got.value)
        assert "shadow tile overflow" in str(got.value)
    finally:
        rt.cfg = saved
        rt.rebind_frame_fn()


@pytest.fixture(scope="module")
def frames(frame):
    """{case: (JAX frame, port frame)}: config 4 zero radius and soft
    disk, config 1 (forward), each the JAX Renderer's CPU frame against
    the port's with use_pallas=False."""
    rj, rt = frame["rj"], frame["rt"]
    out = {"zero": (rj.render_np(0.0), rt.render_np(0.0))}
    saved = rj.cfg, rt.cfg
    try:  # the soft disk on the same Renderers, rebound
        rj.cfg = dataclasses.replace(rj.cfg, pcf_radius_texels=2.5)
        rt.cfg = dataclasses.replace(rt.cfg, pcf_radius_texels=2.5)
        rj.rebind_frame_fn()
        out["soft"] = (rj.render_np(0.0), rt.render_np(0.0))
    finally:
        rj.cfg, rt.cfg = saved
        rj.rebind_frame_fn()
        rt.rebind_frame_fn()
    scene, cfg, lights = JCONFIGS[1]()  # config 1, the forward path
    rj1 = JRenderer(scene, _small(cfg), lights=lights)
    tscene, tcfg, tlights = CONFIGS[1]()
    rt1 = tren.Renderer(tscene, dataclasses.replace(_small(tcfg),
                                                    use_pallas=False),
                        lights=tlights, device="cpu")
    assert rt1.cfg.bin_cap == rj1.cfg.bin_cap
    rt1.device_scene = fr.DeviceScene.from_numpy(_leaves(rj1.device_scene),
                                                 "cpu")
    out["config1"] = (rj1.render_np(0.0), rt1.render_np(0.0))
    rt1.check_overflow()
    frame["rt"].check_overflow()
    return out


@pytest.mark.parametrize("case", ["zero", "soft", "config1"])
def test_xla_frame_matches_jax(frames, case):
    ref, got = frames[case]
    assert got.shape == ref.shape and np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, f"{case}: {frac:.4%} of pixels > 0.02"


def test_use_pallas_selects_the_raster(frame, monkeypatch):
    """use_pallas=False runs the binned tensor raster and no raster
    kernel wrapper; use_pallas=True the wrapper and no binned raster."""
    rt = frame["rt"]
    calls = {"wrapper": 0, "binned": 0}

    def counting(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(raster, "raster_tiles",
                        counting("wrapper", raster.raster_tiles))
    monkeypatch.setattr(rz, "rasterize_binned",
                        counting("binned", rz.rasterize_binned))
    s, c = rt.device_scene, frame["tc"]
    cfg = dataclasses.replace(rt.cfg, ssao_enabled=False)
    fr.render_frame(s, c, cfg)
    assert calls == {"wrapper": 0, "binned": 5}  # main view + 4 cascades
    calls.update(wrapper=0, binned=0)
    fr.render_frame(s, c, dataclasses.replace(cfg, use_pallas=True))
    assert calls == {"wrapper": 2, "binned": 0}


def test_profiler_xla_stages(frame, frames):
    """run_stages on the pure-tensor path: the JAX profiler's XLA keys
    (no bin_main) and the Renderer's image bit for bit."""
    rt = frame["rt"]
    names = []

    def stage(name, fn):
        names.append(name)
        return fn()

    img = profiler.run_stages(rt.device_scene, frame["tc"], rt.cfg, stage)
    assert names == [k for k in _profile_keys()[:-1] if k != "bin_main"]
    assert np.array_equal(np.clip(img.numpy(), 0.0, 1.0), frames["zero"][1])


def test_compare_kernel_vs_xla_keys():
    """compare's kernel-vs-XLA check (the "xla" key of --parity) on the
    CPU at 160x90: the compare() stats and "ok" under the parity bound;
    --parity itself still refuses the CPU."""
    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=160, height=90, shadow_map_size=128)
    d = compare.kernel_vs_xla(scene, cfg, lights, "cpu")
    assert set(d) == {"max", "mean", "frac_gt_2pct", "ok"}
    assert d["ok"] and d["frac_gt_2pct"] < compare.PARITY_FRAC
    with pytest.raises(ValueError, match="not a CUDA device"):
        compare.main(["--parity", "--device", "cpu", "--small"])
