"""The port's config-4 frames with the soft PCF disk and with the soft
disk + fast preset against the JAX package's, end to end.

Full frames (1/8 size, 240x135, 256^2 cascades), as tests/test_torch_frame.py
renders them: the JAX frame jitted on the interpret-mode Pallas raster,
the port through its Renderer on the CPU, from identical scene leaves and
frame constants. Bound: <= 0.5% of pixels with max-RGB |diff| > 0.02.
The soft disk's rotation hash amplifies rounding (test_torch_options.py's
test_soft_disk_noise_floor: 0.025% of the soft disk's pixels move by
more than 0.02 under a one-ulp change of the world positions). The port
differs from the jitted JAX frame by more than an ulp in places (XLA
contracts the projections into FMAs, and its sin differs by an ulp on
~4% of angles, see test_torch_pcf.py). Measured here: soft 0.127% (41 of
32,400 pixels, max 0.038), soft + fast 0% (max 0.018).
"""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu.app.renderer import Renderer as JRenderer
from crychic_renderer_tpu.models.scenes_baseline import CONFIGS as JCONFIGS
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _leaves, _small
from torch_threads import cap_torch_threads

cap_torch_threads()

SOFT = 2.5


FRAME_OPTIONS = {
    "soft": lambda c: dataclasses.replace(c, pcf_radius_texels=SOFT),
    "soft_fast": lambda c: dataclasses.replace(c.fast_preset(),
                                               pcf_radius_texels=SOFT),
}


@pytest.mark.parametrize("name", sorted(FRAME_OPTIONS))
def test_frame_matches_jax(name):
    option = FRAME_OPTIONS[name]
    scene, cfg, lights = JCONFIGS[4]()
    rj = JRenderer(scene, option(_small(cfg)), lights=lights)
    rj.cfg = dataclasses.replace(rj.cfg, use_pallas=True,
                                 pallas_interpret=True)
    rj._autosize_capacity()
    rj.rebind_frame_fn()
    ref = rj.render_np(0.0)

    tscene, tcfg, tlights = CONFIGS[4]()
    rt = tren.Renderer(tscene, option(_small(tcfg)), lights=tlights,
                       device="cpu")
    rt.device_scene = fr.DeviceScene.from_numpy(_leaves(rj.device_scene),
                                                "cpu")
    got = rt.render_np(0.0)
    assert got.shape == ref.shape == (135, 240, 4)
    assert np.isfinite(got).all()
    diff = np.abs(ref - got).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, (f"{name}: {frac:.4%} of pixels >0.02 "
                               f"(max {diff.max():.4f})")
    rt.check_overflow()
