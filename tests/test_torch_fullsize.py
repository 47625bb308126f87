"""The port's full-size frame against the JAX package's, on the CPU.

BASELINE config 4 at its published 1920x1080 with 2048^2 cascades: the
JAX Renderer renders one frame at t = 0 (its CPU backend takes the XLA
raster), and the port renders the same frame on the CPU from the JAX
device scene's leaves (as tests/test_torch_frame.py does), once with
``use_pallas=False`` (the pure-tensor binned raster) and once with
``use_pallas=True`` (the kernels' plain versions, ``rasterize_plain``).
Bound: the per-pixel max-RGB |diff| exceeds 0.02 on at most 0.5% of
pixels (app/compare.py's parity bound; the measure of
tests/test_torch_frame.py, over RGB). Measured on an 8-core CPU: 0.0647%
of pixels (max 0.483, mean 1.09e-4) with ``use_pallas=False`` and
0.0664% (max 0.545, mean 1.11e-4) with ``use_pallas=True``. The file
takes ~140 s on one xdist worker of six (torch on one thread): the JAX
frame ~58 s, the port's frames ~51 s and ~27 s.

Together with chip_smoke.py phase 28, which holds the card's 1920x1080
frame against the port's CPU path under the same bound, this gives card
~ CPU path ~ JAX at full size.

The ``slow`` cases make the same comparison for the soft disk
(``pcf_radius_texels=2.5``) on config 4, for config 1, and for configs
2, 3 and 5 built from the full-size synthetic asset set
(crychic_renderer_tpu_torch/experiments/synthetic_assets.py, with both
packages' scenes_baseline.REF_MODELS pointed at it), each at its own
published size; each costs a JAX frame of ~50-90 s.
"""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves
from torch_threads import cap_torch_threads

cap_torch_threads()


def jax_frame(config, options, **kw):
    """(the JAX device scene's leaves, its frame at t = 0) of BASELINE
    `config` with the cfg fields `options`."""
    scene, cfg, lights = jsb.CONFIGS[config]()
    rj = jren.Renderer(scene, dataclasses.replace(cfg, **options),
                       lights=lights, **kw)
    return _leaves(rj.device_scene), rj.render_np(0.0)


def port_frame(config, options, leaves, use_pallas, **kw):
    """The port's CPU frame at t = 0 of the same config, on the JAX device
    scene's leaves."""
    scene, cfg, lights = tsb.CONFIGS[config]()
    rt = tren.Renderer(scene, dataclasses.replace(
        cfg, use_pallas=use_pallas, **options), lights=lights, device="cpu",
        **kw)
    rt.device_scene = fr.DeviceScene.from_numpy(leaves, "cpu")
    img = rt.render_np(0.0)
    rt.check_overflow()
    return img


def assert_within_bound(ref, got, what):
    assert got.shape == ref.shape
    assert np.isfinite(got).all(), f"{what}: non-finite pixels"
    diff = np.abs(ref[..., :3] - got[..., :3]).max(axis=-1)
    frac = float((diff > 0.02).mean())
    print(f"{what}: {frac:.4%} of pixels >0.02 (max {diff.max():.3f}, "
          f"mean {diff.mean():.3g})")  # shown with pytest -rP
    assert frac <= PIX_BOUND, (f"{what}: {frac:.4%} of pixels >0.02 (max "
                               f"{diff.max():.3f}, mean {diff.mean():.3g})")


@pytest.fixture(scope="module")
def config4():
    leaves, ref = jax_frame(4, {})
    assert ref.shape == (1080, 1920, 4)
    return leaves, ref


@pytest.mark.parametrize("use_pallas", [False, True])
def test_full_size_frame_matches_jax(config4, use_pallas):
    leaves, ref = config4
    got = port_frame(4, {}, leaves, use_pallas)
    assert_within_bound(ref, got, f"config 4 use_pallas={use_pallas}")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    paths = sa.write_asset_set(str(tmp_path_factory.mktemp("assets")),
                               sa.FULL, seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsb, "REF_MODELS", paths["models"])
    mp.setattr(tsb, "REF_MODELS", paths["models"])
    try:
        yield paths
    finally:
        mp.undo()


# case -> (config, cfg fields, whether it reads the synthetic set)
SLOW_CASES = {
    "config4_soft": (4, dict(pcf_radius_texels=2.5), False),
    "config1": (1, {}, False),
    "config2": (2, {}, True),
    "config3": (3, {}, True),
    "config5": (5, {}, True),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(SLOW_CASES))
def test_full_size_case_matches_jax(request, case):
    config, options, files = SLOW_CASES[case]
    kw = {}
    if files:
        paths = request.getfixturevalue("assets")
        kw = dict(asset_dir=paths["textures"])
        if config == 5:
            kw["sky_cubemap_path"] = paths["sky_cube"]
    leaves, ref = jax_frame(config, options, **kw)
    for use_pallas in (False, True):
        got = port_frame(config, options, leaves, use_pallas, **kw)
        assert_within_bound(ref, got, f"{case} use_pallas={use_pallas}")
