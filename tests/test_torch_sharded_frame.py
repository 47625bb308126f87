"""The port's band-sharded frame (render_frame_sharded) over gloo groups
of 2 and 4 CPU ranks, against the port's render_frame and the JAX
package's, on the CPU.

Inputs as in test_torch_sharded.py: BASELINE config 4 at 1/8 size, the
port's scene made from the JAX scene's leaves. Tolerances: against the
port's render_frame max |diff| <= 1e-5 and at most 1e-3 of pixels above
0.02 (tests/test_multichip.py's bound); against the JAX package's
render_frame on the interpret-mode kernel at most 0.5% of pixels above
0.02 (the port's frame bound, test_torch_frame.py).
"""
import copy

import numpy as np
import pytest

from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.parallel import launch, sharded
from crychic_renderer_tpu_torch.passes import frame as fr
from test_torch_frame import PIX_BOUND, _small
from test_torch_sharded import renderers
from torch_threads import cap_torch_threads

cap_torch_threads()

SHARD_MAX = 1e-5   # sharded frame vs the port's render_frame, max |diff|
SHARD_FRAC = 1e-3  # ... share of pixels above 0.02


# ---------------------------------------------------------------------------
# The sharded frame over gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned():
    """One gloo job of 4 CPU ranks: the frame over all 4 ranks, the fast
    preset over all 4, and two frames in flight on 2 x 2 replica groups
    (ranks 0-1 the frame, at the band capacities autosized for 2 ranks;
    ranks 2-3 the same with the camera moved), beside the port's
    single-device frames of the same inputs and the JAX package's."""
    rj, rt = renderers()
    scene, c0 = rt.device_scene, rt.frame_constants(0.0)
    cam = copy.deepcopy(rt.camera)
    rt.camera.walk(2.0)
    rt.camera.rotate_y(0.1)
    c1 = rt.frame_constants(0.5)
    rt.camera = cam
    tscene, tcfg, tlights = CONFIGS[4]()
    fast = Renderer(tscene, _small(tcfg).fast_preset(), lights=tlights,
                    device="cpu")
    cfg2 = sharded.autosize_band_capacities(scene, c0, rt.cfg, 2)
    assert cfg2.band_pair_capacity < rt.cfg.pair_capacity
    runs = launch.render_sharded(
        [scene, fast.device_scene], [c0, c1, fast.frame_constants(0.0)],
        [(rt.cfg, 0, (0,)), (fast.cfg, 1, (2,)), (cfg2, 0, (0, 1))],
        4, "gloo", "cpu")
    single = {
        "frame": fr.render_frame(scene, c0, rt.cfg).numpy(),
        "moved": fr.render_frame(scene, c1, rt.cfg).numpy(),
        "fast": fr.render_frame(fast.device_scene,
                                fast.frame_constants(0.0),
                                fast.cfg).numpy()}
    return dict(runs=runs, single=single, jax=rj.render_np(0.0))


def _vs_single(img, ref, what):
    assert img.shape == ref.shape and np.isfinite(img).all(), what
    diff = np.abs(img - ref).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert diff.max() <= SHARD_MAX and frac <= SHARD_FRAC, (
        f"{what}: max {diff.max():.3g}, {frac:.4%} of pixels > 0.02")


def _sharded(spawned, n):
    """(frame of the group of n ranks from rank 0, its other ranks)."""
    run = 0 if n == 4 else 2  # n == 2: replica 0's group, ranks 0-1
    return [spawned["runs"][rank][run] for rank in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_port(spawned, n):
    """Every rank of the group returns the same full frame, equal to
    render_frame's within the bound, with no overflow and no CUDA launch
    (CPU ranks run the kernels' plain versions)."""
    outs = _sharded(spawned, n)
    img = outs[0]["img"]
    for rank, out in enumerate(outs):
        assert np.array_equal(out["img"], img), rank
        assert not out["overflowed"] and not any(out["launches"].values())
    _vs_single(img, spawned["single"]["frame"], f"n={n}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_jax(spawned, n):
    img = _sharded(spawned, n)[0]["img"]
    diff = np.abs(np.clip(img, 0.0, 1.0) - spawned["jax"]).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac <= PIX_BOUND, f"n={n}: {frac:.4%} of pixels > 0.02"


def test_sharded_fast_preset_matches_port(spawned):
    """The fast preset at n=4: quarter-res SSAO bands of 34 rows and the
    half-res PCF factor gathered across bands."""
    _vs_single(spawned["runs"][0][1]["img"], spawned["single"]["fast"],
               "fast preset")


def test_replicated_frames_match_port(spawned):
    """2 x 2: ranks 0-1 render the first camera, ranks 2-3 the moved one,
    each pair band-sharded over its own group."""
    single = spawned["single"]
    assert not np.allclose(single["frame"], single["moved"])
    for rank, want in ((0, "frame"), (1, "frame"), (2, "moved"),
                       (3, "moved")):
        _vs_single(spawned["runs"][rank][2]["img"], single[want],
                   f"rank {rank}")


def test_spawn_ranks_reports_a_failing_rank():
    """A rank that raises ends the job: the launcher raises with that
    rank's traceback (make_mesh2 refuses 3 x 1 groups in a job of 2) and
    leaves no process behind."""
    with pytest.raises(RuntimeError, match="3 x 1 ranks in a job of 2"):
        launch.spawn_ranks(sharded.make_mesh2, 2, "gloo", "cpu",
                           args=(3, 1), timeout=120)
