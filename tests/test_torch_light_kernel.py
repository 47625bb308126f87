"""The light-loop kernel K10 (csrc/light.cu, ops/light_kernel.py) against its
plain version (passes/frame.direct_light_plain).

On the CPU (counted in the tier-1 run; small random G-buffers in K7's
(H, W, 16) layout): direct_light takes the plain version for CPU tensors;
the plain version is the former direct_light, key for key; a local light
past its falloff_end adds exactly 0 to the plain loop, with a finite
contribution (what lets K10 skip such a pair); the deferred stage reads
no shininess alpha; the wrapper refuses CPU tensors, a G-buffer of
separate planes, a buffer not in K7's layout, more than 16 lights and
other malformed inputs, and hands its C entry one argument per declared
type.

On the card (``cuda``; no tolerance, torch.equal): config 3 at 1920x1080
at the reference pose (Blinn-Phong over 16 point lights, the reach counts
too); configs 4 and 5 (PBR over 3 directional lights) with the
zero-radius and the soft factor; a forward Blinn-Phong frame mixing
directional, point and spot lights with a shadow factor on light 0; a
band of rows at a row offset; random G-buffers; the traced frame's
light_reach_pairs and covered_pixels; the compiled frame, whose replay
launches K10 once and equals the frame rendered with the plain stage;
and the stage on the card dispatching no torch compute op.

Imports torch and the port only (the card's machine has no jax). Run the
card cases with ``python -m pytest tests/test_torch_light_kernel.py -m
cuda --noconftest``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.config import RenderConfig
from crychic_renderer_tpu_torch.models import scenes_baseline as sb
from crychic_renderer_tpu_torch.models.materials import (
    MAX_LIGHTS, Lights, build_reference_lights)
from crychic_renderer_tpu_torch.ops import (light_kernel, raster, resolve,
                                            shading, tally)
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

# the light sets of the cases: (use_pbr, deferred, num_dir, num_point,
# num_spot)
KINDS = {
    "pbr": (True, True, 3, 0, 0),
    "blinn_points": (False, True, 0, 16, 0),
    "forward_mixed": (False, False, 2, 6, 4),
}


def mixed_lights(num_dir: int, num_point: int, num_spot: int) -> Lights:
    """The reference's directional lights, then point lights on a ring of
    radius 6 (falloff 1-9) and spot lights above the scene aimed down at
    it (falloff 2-20, powers 8, 2.5, 64 and 1), seeded colours."""
    ref = build_reference_lights()
    lights = Lights.empty(ambient=tuple(ref.ambient))
    rng = np.random.default_rng(11)
    i = 0
    for _ in range(num_dir):
        lights.direction[i] = ref.direction[i]
        lights.strength[i] = ref.strength[i] if i < 2 else (0.3, 0.2, 0.1)
        i += 1
    for k in range(num_point):
        ang = 2 * np.pi * k / max(num_point, 1)
        lights.position[i] = (6.0 * np.cos(ang), 1.0 + k % 3,
                              6.0 * np.sin(ang))
        lights.strength[i] = tuple(0.4 + 0.6 * rng.random(3))
        lights.falloff_start[i] = 1.0
        lights.falloff_end[i] = 9.0
        i += 1
    powers = (8.0, 2.5, 64.0, 1.0)
    for k in range(num_spot):
        lights.position[i] = (3.0 * (k - 1.5), 8.0, 2.0 * (k % 2) - 1.0)
        d = np.array([0.2 * (k - 1.5), -1.0, 0.3], np.float32)
        lights.direction[i] = d / np.linalg.norm(d)
        lights.strength[i] = tuple(0.5 + rng.random(3))
        lights.falloff_start[i] = 2.0
        lights.falloff_end[i] = 20.0
        lights.spot_power[i] = powers[k % len(powers)]
        i += 1
    lights.num_dir, lights.num_point, lights.num_spot = (num_dir, num_point,
                                                         num_spot)
    return lights


def _case(kind: str, device):
    """(scene stand-in with the light tables, consts stand-in with the
    eye, cfg) of a KINDS case on `device`."""
    use_pbr, deferred, nd, npt, ns = KINDS[kind]
    lights = mixed_lights(nd, npt, ns)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    scene = types.SimpleNamespace(
        light_strength=t(lights.strength), light_direction=t(lights.direction),
        light_position=t(lights.position),
        light_falloff_start=t(lights.falloff_start),
        light_falloff_end=t(lights.falloff_end),
        light_spot_power=t(lights.spot_power))
    consts = types.SimpleNamespace(eye_pos=t([0.5, 4.0, -12.0]))
    cfg = dataclasses.replace(RenderConfig(), use_pbr=use_pbr,
                              deferred=deferred, num_dir_lights=nd,
                              num_point_lights=npt, num_spot_lights=ns)
    return scene, consts, cfg


def random_gbuffer(H: int, W: int, seed: int, device="cpu"):
    """K7's (H, W, 16) layout filled from a seed, and its planes as views
    (passes/frame._G_CLEAR's names) with the buffer as "buffer", as
    resolve_gbuffer returns them on the card: positions within +-10 of
    the origin (some within a light's reach, some past it), unnormalized
    normals, every fifth pixel uncovered (the clear values); plus a
    shadow factor in [0, 1]. Returns (g, buffer, shadow factor)."""
    gen = np.random.default_rng(seed)
    buf = gen.random((H, W, resolve.CHANNELS), dtype=np.float32)
    buf[..., 0:3] = gen.uniform(-10.0, 10.0, (H, W, 3))
    buf[..., 1] = gen.uniform(-1.0, 6.0, (H, W))
    buf[..., 3:6] = gen.normal(size=(H, W, 3))
    buf[..., 5] += 1.5
    clear = np.concatenate([np.asarray(v, np.float32)
                            for v in fr._G_CLEAR.values()])
    uncovered = gen.random((H, W)) < 0.2
    buf[uncovered] = clear
    buf = torch.from_numpy(buf).to(device)
    g, o = {}, 0
    for name, vals in fr._G_CLEAR.items():
        g[name] = buf[..., o:o + len(vals)]
        o += len(vals)
    g["valid"] = torch.from_numpy(~uncovered).to(device)
    g["buffer"] = buf
    sf = torch.from_numpy(gen.random((H, W), dtype=np.float32)).to(device)
    return g, buf, sf


def _former_direct_light(scene, consts, cfg, g, shadow_factor=None,
                         in_reach=None):
    """passes/frame.direct_light as it was before K10, verbatim."""
    pos_w = g["pos_w"]
    albedo = g["albedo"]
    roughness = g["roughness"]
    metalness = g["metalness"]
    normal = shading.normalize(g["normal_w"])
    view = shading.normalize(consts.eye_pos - pos_w)
    fresnel_r0 = 0.04 * (1.0 - metalness) + albedo[..., :3] * metalness
    sf = (torch.ones_like(roughness) if shadow_factor is None
          else shadow_factor[..., None])
    lights = fr._LightsView(scene, cfg)
    alpha = (torch.ones_like(roughness) if cfg.deferred
             else g["shininess_alpha"])
    shininess = (1.0 - roughness) * alpha
    if cfg.use_pbr:
        direct = shading.pbr_shading(lights, normal, view, pos_w, albedo,
                                     roughness, metalness, sf)
    else:
        direct = shading.compute_lighting(lights, normal, view, pos_w,
                                          albedo, fresnel_r0, shininess, sf,
                                          in_reach=in_reach)
    return dict(direct=direct, normal=normal, view=view,
                fresnel_r0=fresnel_r0, shininess=shininess)


def _assert_equal(a, b, what):
    assert a.shape == b.shape, (what, tuple(a.shape), tuple(b.shape))
    if not torch.equal(a, b):
        diff = (a - b).abs()
        pytest.fail(f"{what}: {int((a != b).sum())} of {a.numel()} differ, "
                    f"max |diff| {float(diff.nan_to_num().max()):.3g}")


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        _assert_equal(got[k], want[k], k)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shadowed", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_takes_the_plain_version(kind, shadowed, monkeypatch):
    """On CPU tensors direct_light is direct_light_plain, and K10's
    wrapper is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("K10 launched for CPU tensors")

    monkeypatch.setattr(light_kernel, "light", refuse)
    scene, consts, cfg = _case(kind, "cpu")
    g, _, sf = random_gbuffer(12, 20, seed=3)
    sf = sf if shadowed else None
    reach, reach0 = (torch.zeros_like(g["roughness"]) for _ in range(2))
    _assert_same(fr.direct_light(scene, consts, cfg, g, sf, reach),
                 fr.direct_light_plain(scene, consts, cfg, g, sf, reach0))
    _assert_equal(reach, reach0, "in_reach")


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_equals_the_former_stage(kind):
    """direct_light_plain is the former direct_light, key for key, and
    counts the same reach."""
    scene, consts, cfg = _case(kind, "cpu")
    g, _, sf = random_gbuffer(16, 24, seed=5)
    reach, reach0 = (torch.zeros_like(g["roughness"]) for _ in range(2))
    _assert_same(fr.direct_light_plain(scene, consts, cfg, g, sf, reach),
                 _former_direct_light(scene, consts, cfg, g, sf, reach0))
    _assert_equal(reach, reach0, "in_reach")
    if KINDS[kind][3] + KINDS[kind][4]:
        assert 0 < float(reach.sum()) < reach.numel() * (KINDS[kind][3]
                                                         + KINDS[kind][4])


@pytest.mark.parametrize("kind", ["blinn_points", "forward_mixed"])
def test_past_falloff_adds_exactly_zero(kind):
    """A (local light, pixel) pair past the light's falloff_end: its
    contribution is finite, so the mask's 0 makes it add exactly 0, and
    the loop over all lights equals the loop whose pairs past falloff_end
    are dropped (K10's early-out)."""
    scene, consts, cfg = _case(kind, "cpu")
    g, _, sf = random_gbuffer(16, 24, seed=7)
    lights = fr._LightsView(scene, cfg)
    nd, npt, ns = lights.num_dir, lights.num_point, lights.num_spot
    want = fr.direct_light_plain(scene, consts, cfg, g, sf)["direct"]
    # the same loop, each local light's pairs past falloff_end skipped
    normal = shading.normalize(g["normal_w"])
    view = shading.normalize(consts.eye_pos - g["pos_w"])
    metal = g["metalness"]
    r0 = 0.04 * (1.0 - metal) + g["albedo"][..., :3] * metal
    alpha = (torch.ones_like(g["roughness"]) if cfg.deferred
             else g["shininess_alpha"])
    shininess = (1.0 - g["roughness"]) * alpha
    head = dataclasses.replace(cfg, num_point_lights=0, num_spot_lights=0)
    got = shading.compute_lighting(fr._LightsView(scene, head), normal, view,
                                   g["pos_w"], g["albedo"], r0, shininess,
                                   sf[..., None])
    past = 0
    for i in range(nd, nd + npt + ns):
        lvn, strength, in_range = shading._local_light(lights, i, g["pos_w"],
                                                       normal)
        if i >= nd + npt:
            strength = strength * torch.clamp(
                (-lvn * lights.direction[i]).sum(-1, keepdim=True),
                min=0.0) ** lights.spot_power[i]
        contrib = shading._blinn_phong(strength, lvn, normal, view,
                                       g["albedo"][..., :3], r0, shininess)
        lv = lights.position[i] - g["pos_w"]
        d = torch.sqrt((lv * lv).sum(-1, keepdim=True))
        far = d > lights.falloff_end[i]
        assert torch.equal(far, in_range == 0)
        assert bool(torch.isfinite(contrib[far.expand_as(contrib)]).all())
        added = in_range * contrib
        assert bool((added[far.expand_as(added)] == 0).all())
        past += int(far.sum())
        got = torch.where(far, got, got + added)
    assert past > 0
    _assert_equal(got, want, "direct with the early-out")


@pytest.fixture
def launches(monkeypatch):
    """The wrapper with its device check passing CPU tensors and the
    library's launch recording (entry, args, key) instead of launching."""
    calls = []
    monkeypatch.setattr(light_kernel, "_device", lambda t: t.device)
    monkeypatch.setattr(
        light_kernel.LIBRARY, "launch",
        lambda entry, dev, *args, key: calls.append((entry, args, key)))
    return calls


def _kernel_args(kind, device="cpu"):
    """Well-formed keyword arguments of light_kernel.light, and the
    buffer."""
    scene, consts, cfg = _case(kind, device)
    g, buf, sf = random_gbuffer(8, 12, seed=1, device=device)
    return dict(gbuf=buf, eye_pos=consts.eye_pos,
                lights=fr._LightsView(scene, cfg), use_pbr=cfg.use_pbr,
                deferred=cfg.deferred, shadow_factor=sf.t().contiguous().t(),
                in_reach=torch.zeros_like(g["roughness"])), buf


# the channels of K7's record that csrc/light.cu reads: (first, width)
K10_READS = dict(pos_w=(0, 3), normal_w=(3, 3), albedo=(9, 4),
                 roughness=(13, 1), metalness=(14, 1), shininess_alpha=(15, 1))


def test_planes_are_k7s_channels():
    """The channels K10 reads are those planes in _G_CLEAR's order, and
    its outputs are direct_light's keys and widths, the planes of one
    buffer."""
    o = 0
    for name, vals in fr._G_CLEAR.items():
        if name in K10_READS:
            assert K10_READS[name] == (o, len(vals)), name
        o += len(vals)
    assert o == resolve.CHANNELS
    scene, consts, cfg = _case("pbr", "cpu")
    g, _, _ = random_gbuffer(2, 3, seed=0)
    plain = fr.direct_light_plain(scene, consts, cfg, g)
    assert list(light_kernel.OUTPUTS) == list(plain)
    for name, width in light_kernel.OUTPUTS.items():
        assert plain[name].shape[-1] == width, name
    assert sum(light_kernel.OUTPUTS.values()) == light_kernel.CHANNELS


def test_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises; the CPU takes the plain version."""
    kw, _ = _kernel_args("pbr")
    with pytest.raises(ValueError, match="direct_light_plain"):
        light_kernel.light(**kw)


@pytest.mark.parametrize("kind", ["pbr", "forward_mixed"])
def test_wrapper_matches_the_entry(kind, launches):
    """A well-formed call hands its C entry one argument per declared
    type (the stream last), counts under "light" and passes the buffer's
    start, the light counts and the factor's and reach's strides; it
    returns the outputs as contiguous planes, one after another in the
    buffer the kernel writes."""
    kw, buf = _kernel_args(kind)
    out = light_kernel.light(**kw)
    ptr = out["direct"].data_ptr()
    for name, n in light_kernel.OUTPUTS.items():
        plane = out[name]
        assert plane.shape == (8, 12, n) and plane.is_contiguous(), name
        assert plane.data_ptr() == ptr, name
        ptr += 4 * plane.numel()
    ((entry, args, key),) = launches
    assert (entry, key) == ("crychic_light", "light")
    argtypes, _ = light_kernel.LIBRARY.signatures[entry]
    assert len(args) + 1 == len(argtypes)
    use_pbr, deferred, nd, npt, ns = KINDS[kind]
    assert args[0] == buf.data_ptr() and args[1:3] == (8, 12)
    assert args[10:15] == ((nd, 0, 0, 1, 1) if use_pbr
                           else (nd, npt, ns, 0, int(deferred)))
    assert args[16:18] == kw["shadow_factor"].stride() == (1, 8)
    assert args[19:21] == kw["in_reach"].stride()[:2]
    assert args[-1] == out["direct"].data_ptr()


def _malformed(kw, buf, case):
    """light_kernel.light's kwargs with one input made malformed."""
    kw = dict(kw)
    H, W = buf.shape[:2]
    if case == "separate_planes":
        kw["gbuf"] = None  # a plain-resolved G-buffer has no "buffer"
    elif case == "channels_15":
        kw["gbuf"] = buf[..., :15].contiguous()
    elif case == "buffer_f64":
        kw["gbuf"] = buf.double()
    elif case == "buffer_2d":
        kw["gbuf"] = buf[..., 0]
    elif case == "buffer_strided":
        kw["gbuf"] = buf.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "buffer_misaligned":
        flat = torch.zeros(buf.numel() + 4)
        kw["gbuf"] = flat[1:1 + buf.numel()].view(H, W, resolve.CHANNELS)
    elif case == "seventeen_lights":
        lights = kw["lights"]
        kw["lights"] = types.SimpleNamespace(
            **{k: getattr(lights, k) for k in (
                "strength", "direction", "position", "falloff_start",
                "falloff_end", "spot_power")},
            num_dir=2, num_point=11, num_spot=4)
    elif case == "table_15_rows":
        lights = kw["lights"]
        kw["lights"] = types.SimpleNamespace(**vars(lights))
        kw["lights"].position = lights.position[:MAX_LIGHTS - 1]
    elif case == "eye_2d":
        kw["eye_pos"] = kw["eye_pos"][None]
    elif case == "factor_shape":
        kw["shadow_factor"] = kw["shadow_factor"][:-1]
    elif case == "reach_f64":
        kw["in_reach"] = kw["in_reach"].double()
    else:
        raise KeyError(case)
    return kw


@pytest.mark.parametrize("case", [
    "separate_planes", "channels_15", "buffer_f64", "buffer_2d",
    "buffer_strided", "buffer_misaligned", "seventeen_lights",
    "table_15_rows", "eye_2d", "factor_shape", "reach_f64"])
def test_wrapper_refuses_malformed_inputs(launches, case):
    """A G-buffer of separate planes (no buffer), a buffer not in K7's
    contiguous, aligned (H, W, 16) float32 layout, more than 16 lights, a
    short light table, a wrong dtype or shape raise ValueError before any
    launch."""
    kw, buf = _kernel_args("forward_mixed")
    with pytest.raises(ValueError):
        light_kernel.light(**_malformed(kw, buf, case))
    assert launches == []


def test_deferred_reads_no_shininess_alpha():
    """The deferred stage takes shininess alpha 1 (K10 reads no
    shininess_alpha channel there): the plain deferred stage does not
    change with that channel, the forward one does."""
    for kind, deferred in (("blinn_points", True), ("forward_mixed", False)):
        scene, consts, cfg = _case(kind, "cpu")
        assert cfg.deferred == deferred
        outs = []
        for alpha in (0.25, 0.75):
            g, buf, sf = random_gbuffer(8, 12, seed=9)
            buf[..., 15] = alpha
            outs.append(fr.direct_light_plain(scene, consts, cfg, g, sf))
        same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
        assert same == deferred, kind


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def assets(cuda, tmp_path_factory):
    """The full synthetic asset set; configs 3 and 5 read its models."""
    from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa

    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.FULL, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "REF_MODELS", paths["models"])
        yield dict(asset_dir=paths["textures"],
                   sky_cubemap_path=paths["sky_cube"])


@pytest.fixture(scope="module")
def renderers(cuda, assets):
    """Configs 3, 4 and 5 (3 and 5 from the synthetic set) at 1920x1080,
    and config 4's scene forward with mixed lights and shadows, on the
    card."""
    out = {}
    for config, kw in ((3, assets), (4, {}), (5, assets)):
        scene, cfg, lights = sb.CONFIGS[config]()
        out[config] = Renderer(scene, cfg, lights=lights, device=cuda, **kw)
    scene, cfg, _ = sb.CONFIGS[4]()
    nd, npt, ns = KINDS["forward_mixed"][2:]
    cfg = dataclasses.replace(cfg, deferred=False, use_pbr=False,
                              num_dir_lights=nd, num_point_lights=npt,
                              num_spot_lights=ns)
    out["forward"] = Renderer(scene, cfg, lights=mixed_lights(nd, npt, ns),
                              device=cuda)
    yield out
    for r in out.values():
        r.close()


def _gbuffer(r, cfg=None, t=0.0):
    """(consts, K7's G-buffer, light 0's shadow factor or None, depth, tid)
    of r's frame at the reference pose."""
    r.camera = r._default_camera()
    cfg = r.cfg if cfg is None else cfg
    s = r.device_scene
    consts = r.frame_constants(t)
    tris, attr = fr.main_view_tris(s, consts, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(s, consts, cfg, tris, depth, tid, attr)
    sf = None
    if cfg.shadows_enabled:
        maps = fr.render_shadow_maps(s, consts, cfg)
        sf = fr.shadow_factor_pass(consts, cfg, g, maps)
    return consts, g, sf, (tris, attr, depth, tid)


def _both(scene, consts, cfg, g, sf):
    """(K10's, the plain version's) (outputs, reach) on the same inputs;
    K10 launched once."""
    runs = []
    for fn in (fr.direct_light, fr.direct_light_plain):
        reach = None
        if not cfg.use_pbr and cfg.num_point_lights + cfg.num_spot_lights:
            reach = torch.zeros_like(g["roughness"])
        before = tally.snapshot()
        runs.append((fn(scene, consts, cfg, g, sf, reach), reach))
        torch.cuda.synchronize()
        assert tally.since(before) == ({"light": 1} if fn is fr.direct_light
                                       else {})
    return runs


def _assert_runs(runs):
    (got, reach), (want, reach0) = runs
    _assert_same(got, want)
    if reach0 is not None:
        _assert_equal(reach, reach0, "in_reach")


@pytest.mark.cuda
def test_config3_reference_pose(renderers):
    """Config 3: Blinn-Phong over 16 point lights, deferred, unshadowed;
    every output and the reach counts equal, about half the (light,
    covered pixel) pairs in reach."""
    r = renderers[3]
    consts, g, sf, _ = _gbuffer(r)
    assert sf is None and not r.cfg.use_pbr
    runs = _both(r.device_scene, consts, r.cfg, g, sf)
    _assert_runs(runs)
    reach = runs[0][1][..., 0]
    share = float(reach[g["valid"]].sum()) / (16.0 * float(g["valid"].sum()))
    assert 0.3 < share < 0.7, share


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("config", [4, 5])
def test_pbr_configs(renderers, config, soft):
    """Configs 4 and 5: PBR over 3 directional lights with light 0's
    zero-radius factor (the compacted factor, a strided view) or the soft
    disk's (K6)."""
    r = renderers[config]
    cfg = (dataclasses.replace(r.cfg, pcf_radius_texels=2.5) if soft
           else r.cfg)
    consts, g, sf, _ = _gbuffer(r, cfg)
    assert sf is not None and cfg.use_pbr
    _assert_runs(_both(r.device_scene, consts, cfg, g, sf))


@pytest.mark.cuda
def test_forward_mixed_lights(renderers):
    """Config 4's scene forward: Blinn-Phong over 2 directional, 6 point
    and 4 spot lights, light 0 shadowed, the shininess from the
    G-buffer's normal-map alpha."""
    r = renderers["forward"]
    consts, g, sf, _ = _gbuffer(r)
    assert not r.cfg.deferred and sf is not None
    runs = _both(r.device_scene, consts, r.cfg, g, sf)
    _assert_runs(runs)
    assert float(runs[0][1].sum()) > 0


@pytest.mark.cuda
def test_band_of_rows(renderers):
    """A band of rows 270..539 (K7 at row offset 270 with its halo row
    trimmed): K10 equals the plain version on the band, and the band's
    rows equal the whole frame's."""
    r = renderers["forward"]
    consts, g_full, sf, (tris, attr, depth, tid) = _gbuffer(r)
    y0, rows = 270, 270
    dense = dataclasses.replace(r.cfg, shade_tile_capacity=None)
    g = fr.resolve_gbuffer(r.device_scene, consts, dense, tris,
                           depth[y0:y0 + rows + 1], tid[y0:y0 + rows + 1],
                           attr, row_offset=y0, out_rows=rows)
    band_sf = sf[y0:y0 + rows]
    runs = _both(r.device_scene, consts, r.cfg, g, band_sf)
    _assert_runs(runs)
    whole = fr.direct_light(r.device_scene, consts, r.cfg, g_full, sf)
    for k, v in runs[0][0].items():
        _assert_equal(v, whole[k][y0:y0 + rows], f"band {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_random_gbuffers(cuda, kind):
    """Random 333x517 G-buffers in K7's layout, with and without a
    shadow factor: every output and the reach counts equal."""
    scene, consts, cfg = _case(kind, cuda)
    for seed, shadowed in ((21, True), (22, False)):
        g, _, sf = random_gbuffer(333, 517, seed, cuda)
        _assert_runs(_both(scene, consts, cfg, g, sf if shadowed else None))


@pytest.mark.cuda
def test_traced_frame_counts(renderers):
    """Config 3's frame with the trace's hook: light_reach_pairs and
    covered_pixels equal the frame's with the plain stage."""
    r = renderers[3]
    r.camera = r._default_camera()
    counts = []
    for fn in (fr.direct_light, fr.direct_light_plain):
        stats = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fr, "direct_light", fn)
            img = fr.render_frame(r.device_scene, r.frame_constants(0.0),
                                  r.cfg, stats=stats, mark=lambda _: None)
        counts.append((img, stats["light_reach_pairs"],
                       stats["covered_pixels"]))
    (img, pairs, covered), (img0, pairs0, covered0) = counts
    _assert_equal(img, img0, "image")
    assert int(pairs) == int(pairs0) > 0
    assert int(covered) == int(covered0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", [3, 4])
def test_compiled_frame_goes_through_k10(cuda, assets, monkeypatch, config):
    """Configs 3 and 4 at 1080p: the replay launches K10 once and equals
    the frame rendered eagerly with the plain stage."""
    scene, cfg, lights = sb.CONFIGS[config]()
    kw = assets if config == 3 else {}
    r = Renderer(scene, cfg, lights=lights, device=cuda, **kw)
    r.render(0.0)
    before = tally.snapshot()
    img = r.render(0.0)
    torch.cuda.synchronize()
    assert r.compiled_frame.launches["light"] == 1
    assert tally.since(before)["light"] == 1
    monkeypatch.setattr(fr, "direct_light", fr.direct_light_plain)
    want = fr.render_frame(r.device_scene, r.frame_constants(0.0), r.cfg)
    _assert_equal(img, want, "frame")
    r.close()


@pytest.mark.cuda
@pytest.mark.parametrize("config", [3, 4])
def test_stage_dispatches_no_torch_compute(renderers, config):
    """On the card the stage is K10 alone: under a TorchDispatchMode it
    dispatches only its output's allocation and views of it, where the
    plain stage dispatches hundreds of ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    r = renderers[config]
    consts, g, sf, _ = _gbuffer(r)
    seen = {}
    for fn in (fr.direct_light, fr.direct_light_plain):
        with Ops() as mode:
            fn(r.device_scene, consts, r.cfg, g, sf)
        seen[fn.__name__] = mode.ops
    assert set(seen["direct_light"]) <= {"empty", "slice", "view"}, \
        seen["direct_light"]
    assert len(seen["direct_light_plain"]) > 100
