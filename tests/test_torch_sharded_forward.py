"""The band-sharded frame (parallel/sharded.py) of the forward path and
of the alpha-tested layer, on 2 gloo CPU ranks, against the port's
render_frame of the same inputs.

One job of 2 ranks renders two frames: config 4 at 1/8 size with
deferred=False, use_pbr=False (Blinn-Phong, the forward cascade blend,
the ShadowDebug quad drawn at global row phase) and the fence scene at
160x90 with the synthetic wire grid (each rank peels its band at global
rows plus the halo row; the 4 shadow punch windows split 2 and 2 across
the ranks and all-gathered). Bound: max |diff| <= 1e-5 and at most 1e-3
of pixels above 0.02 (tests/test_multichip.py's bound, as
test_torch_sharded.py holds the deferred frame); measured max 0.0 in
both.
"""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.parallel import launch
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_fence import SMALL, fence_chains
from test_torch_frame import _small
from torch_threads import cap_torch_threads

cap_torch_threads()

SHARD_MAX = 1e-5
SHARD_FRAC = 1e-3


@pytest.fixture(scope="module")
def sharded_runs():
    """The two frames on 2 gloo CPU ranks, and the port's render_frame of
    each."""
    scene, cfg, lights = tsb.config4_shadow_pipeline()
    fwd = tren.Renderer(scene, dataclasses.replace(
        _small(cfg), deferred=False, use_pbr=False), lights=lights,
        device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tren, "load_texture_chains", fence_chains)
    try:
        scene, cfg, lights = tsb.fence_scene(alpha_test=True)
        fence = tren.Renderer(scene, dataclasses.replace(cfg, **SMALL),
                              lights=lights, device="cpu")
    finally:
        mp.undo()
    rs = {"forward": fwd, "fence": fence}
    consts = {k: r.frame_constants(0.0) for k, r in rs.items()}
    names = sorted(rs)
    runs = launch.render_sharded(
        [rs[k].device_scene for k in names], [consts[k] for k in names],
        [(rs[k].cfg, i, (i,)) for i, k in enumerate(names)], 2, "gloo",
        "cpu")
    single = {k: fr.render_frame(rs[k].device_scene, consts[k],
                                 rs[k].cfg).numpy() for k in names}
    return {k: ([runs[rank][i] for rank in range(2)], single[k], rs[k].cfg)
            for i, k in enumerate(names)}


@pytest.mark.parametrize("name", ["forward", "fence"])
def test_sharded_frame_matches_port(sharded_runs, name):
    """Both ranks return the same full frame, equal to render_frame's
    within the bound, with no overflow and no CUDA launch."""
    outs, ref, _ = sharded_runs[name]
    img = outs[0]["img"]
    for rank, out in enumerate(outs):
        assert np.array_equal(out["img"], img), rank
        assert not out["overflowed"] and not any(out["launches"].values())
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert diff.max() <= SHARD_MAX and frac <= SHARD_FRAC, (
        f"{name}: max {diff.max():.3g}, {frac:.4%} of pixels > 0.02")


@pytest.mark.parametrize("field,value", [
    ("deferred", False), ("use_pbr", False), ("alpha_test_enabled", True)])
def test_sharded_unported_setting_raises(sharded_runs, field, value):
    """The settings the band-sharded frame used to refuse with
    NotImplementedError (the name is kept) now render: the run whose
    config carries the setting gives render_frame's image on 2 ranks."""
    name = "fence" if field == "alpha_test_enabled" else "forward"
    outs, ref, cfg = sharded_runs[name]
    assert getattr(cfg, field) == value
    assert np.abs(outs[0]["img"] - ref).max() <= SHARD_MAX
