"""The port's config-4 frame against the JAX package's, end to end.

Both render BASELINE config 4 at 1/8 size (240x135, 256^2 cascades) from
an identical device scene and identical frame constants: the JAX frame
jitted and forced onto the Pallas kernel in interpret mode (as
tests/test_fuzz_parity.py does), the port through its own Renderer on the
CPU (rasterize_plain). Bound: the per-pixel max-RGB |diff| exceeds 0.02 on
at most 0.5% of pixels (app/compare.py's parity bound). Measured: 0.012%
of pixels (4 of 32400), max 0.038, mean 4.8e-5. The jitted JAX frame
contracts the depth-plane sums into FMAs (see test_torch_raster.py), so
its depths differ from the port's by up to ~4e-4 while every triangle id
agrees.

Also here: the guards of the port's package — it never imports jax and
it pins f32 matmuls — and the settings it once refused now render.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu.ops import raster_pallas as rp
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import raster
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIX_BOUND = 0.005  # share of pixels whose max-RGB |diff| exceeds 0.02


def _small(cfg):
    return dataclasses.replace(cfg, width=cfg.width // 8,
                               height=cfg.height // 8, shadow_map_size=256)


def _leaves(obj):
    """A JAX container as a mapping of numpy leaves (nested for draws)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _leaves(v)
        elif v is None or isinstance(v, int):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def frames():
    scene, cfg, lights = JCONFIGS[4]()
    rj = JRenderer(scene, _small(cfg), lights=lights)
    # the JAX Renderer drops to its XLA raster on CPU backends; force the
    # Pallas kernel (interpret mode), re-autosize, rebind the jitted frame
    rj.cfg = dataclasses.replace(rj.cfg, use_pallas=True,
                                 pallas_interpret=True)
    rj._autosize_capacity()
    rj.rebind_frame_fn()
    ref = rj.render_np(0.0)

    tscene, tcfg, tlights = CONFIGS[4]()
    rt = Renderer(tscene, _small(tcfg), lights=tlights, device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    got = rt.render_np(0.0)
    return rj, rt, ref, got


def _intermediates(rj, rt):
    """Mismatch summary of the frame's stages, for the failure message."""
    cj, ct = rj.frame_constants(0.0), rt.frame_constants(0.0)
    jc, tc = rj.cfg, rt.cfg

    def jmain(s, c):
        tris, attr = jfr.main_view_tris(s, c, jc)
        d, t = rp.rasterize_pallas(tris, jc.width, jc.height,
                                   jc.pair_capacity, interpret=True)
        g = jfr.resolve_gbuffer(s, c, jc, tris, d, t, attr)
        acc = jfr.ssao_pass(s, c, jc, g["normal_v"], d, valid=t >= 0)
        atlas = jfr.render_shadow_atlas(s, c.shadow_visibility,
                                        c.cascade_view_projs, jc)
        return d, t, g["albedo"], g["normal_w"], acc, atlas

    d_j, t_j, alb_j, nrm_j, acc_j, atl_j = map(
        np.asarray, jax.jit(jmain)(rj.device_scene, cj))
    s = rt.device_scene
    tris, attr = fr.main_view_tris(s, ct, tc)
    d_t, t_t, _ = raster.rasterize(tris, tc.width, tc.height,
                                   tc.pair_capacity)
    g = fr.resolve_gbuffer(s, ct, tc, tris, d_t, t_t, attr)
    acc_t = fr.ssao_pass(s, ct, tc, g["normal_v"], d_t).numpy()
    atl_t = fr.render_shadow_atlas(s, ct.shadow_visibility,
                                   ct.cascade_view_projs, tc).numpy()
    same = t_j == t_t.numpy()
    gdiff = np.maximum(np.abs(alb_j - g["albedo"].numpy()).max(-1),
                       np.abs(nrm_j - g["normal_w"].numpy()).max(-1))
    return (f"main raster: {1 - same.mean():.4%} tids differ, max |dz| "
            f"{np.abs(d_j - d_t.numpy())[same].max():.3g} where they agree; "
            f"atlas: max |dz| {np.abs(atl_j - atl_t).max():.3g}; "
            f"G-buffer: {(gdiff > 0.02).mean():.4%} pixels >0.02 in albedo "
            f"or normal; SSAO access: max {np.abs(acc_j - acc_t).max():.3g}"
            f" mean {np.abs(acc_j - acc_t).mean():.3g}")


def test_frame_matches_jax(frames):
    rj, rt, ref, got = frames
    assert got.shape == ref.shape == (135, 240, 4)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    if frac > PIX_BOUND:
        pytest.fail(f"{frac:.4%} of pixels >0.02 (bound {PIX_BOUND:.1%}); "
                    f"max {diff.max():.4f} mean {diff.mean():.3g}; "
                    + _intermediates(rj, rt))
    rt.check_overflow()  # no capacity overflowed in the frame


def test_frame_intermediates_summary(frames):
    """The stage-by-stage summary the frame test reports on failure runs
    and finds every triangle id equal."""
    rj, rt, _, _ = frames
    summary = _intermediates(rj, rt)
    assert summary.startswith("main raster: 0.0000% tids differ"), summary


def test_check_overflow_raises_after_an_overflowing_frame(frames):
    _, rt, _, _ = frames
    rt.check_overflow()
    cfg = rt.cfg
    rt.cfg = dataclasses.replace(cfg, shadow_pair_capacity=128)
    try:
        rt.render(0.0)
        with pytest.raises(RuntimeError, match="shadow"):
            rt.check_overflow()
        rt.check_overflow()  # the flag was cleared by the read
    finally:
        rt.cfg = cfg


def test_atlas_capacity_counts_the_binned_pairs(frames):
    """The shadow capacity counts what the atlas binning expands, which
    can exceed the JAX package's per-cascade count (frame.py:1394-1404)."""
    _, rt, _, _ = frames
    consts = rt.frame_constants(0.0)
    req = fr.capacity_requirements(rt.device_scene, consts, rt.cfg)
    tris, xr = fr.shadow_atlas_tris(rt.device_scene,
                                    consts.shadow_visibility,
                                    consts.cascade_view_projs, rt.cfg)
    S = rt.cfg.shadow_map_size
    bins = fr.rz.bin_triangles(tris, 4 * S, S, 1 << 20, tile_h=8)
    assert int(req["shadow_pairs"]) == int(bins.num_valid)
    assert int(bins.num_valid) <= rt.cfg.shadow_pair_capacity


# ---------------------------------------------------------------------------
# Package guards
# ---------------------------------------------------------------------------

def _run(code):
    # the child's torch gets this worker's share of the cores
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_renders_without_jax():
    code = (
        "import dataclasses, sys\n"
        "import numpy as np\n"
        "from crychic_renderer_tpu_torch.app.renderer import Renderer\n"
        "from crychic_renderer_tpu_torch.models.scenes_baseline import "
        "CONFIGS\n"
        "scene, cfg, lights = CONFIGS[4]()\n"
        "cfg = dataclasses.replace(cfg, width=240, height=135, "
        "shadow_map_size=256)\n"
        "img = Renderer(scene, cfg, lights=lights, device='cpu')"
        ".render_np(0.0)\n"
        "assert img.shape == (135, 240, 4) and np.isfinite(img).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'crychic_renderer_tpu.')) "
        "or m == 'crychic_renderer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    p = _run(code)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]


def test_port_sources_do_not_import_jax():
    pkg = os.path.join(REPO, "crychic_renderer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax",
                                                 "import crychic_renderer_tpu",
                                                 "from crychic_renderer_tpu ",
                                                 "from crychic_renderer_tpu.")),\
                            f"{name}: {s}"


def test_import_pins_f32_matmul():
    p = _run(
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.set_float32_matmul_precision('medium')\n"
        "import crychic_renderer_tpu_torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n")
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]


@pytest.mark.parametrize("field,value", [
    ("deferred", False), ("use_pbr", False), ("alpha_test_enabled", True)])
def test_unported_setting_raises(frames, field, value):
    """The settings render_frame used to refuse with NotImplementedError
    (the name is kept) now render the 1/8 config-4 frame: the forward path
    and Blinn-Phong change the image (tests/test_torch_forward.py holds
    them against the JAX frame); alpha_test_enabled without an alpha draw
    in the scene counts as off, as in the JAX package."""
    _, rt, _, _ = frames
    consts = rt.frame_constants(0.0)
    base = fr.render_frame(rt.device_scene, consts, rt.cfg)
    img = fr.render_frame(rt.device_scene, consts,
                          dataclasses.replace(rt.cfg, **{field: value}))
    assert img.shape == base.shape and bool(img.isfinite().all())
    assert torch.equal(img, base) == (field == "alpha_test_enabled")
