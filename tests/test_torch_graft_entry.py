"""The port's graft entry points (crychic_renderer_tpu_torch.graft_entry)
against the repository's ``__graft_entry__.py``, on the CPU.

- ``entry("cpu")``: the cfg bound into the frame function equal to the
  JAX ``entry()``'s field by field, every device-scene leaf and frame
  constant equal bit for bit, and the frame within the parity bound of
  the jitted JAX frame (at most 0.5% of pixels whose max-RGB |diff|
  exceeds 0.02; both on the pure-tensor raster, use_pallas=False).
  Measured: 0.1282% of pixels (max |diff| 0.237; the jitted JAX frame
  contracts the raster's plane sums into FMAs, test_torch_raster.py).
- ``dryrun_multichip(4, "gloo", "cpu", cpu_check=True)``: all three legs
  on 4 spawned CPU ranks, each held against render_frame under the JAX
  dryrun's bound (below 1e-3 of pixels > 0.02), the 1080-row leg
  included, which the JAX dryrun checks for its shape only, and (the
  card's check, here CPU against CPU) against render_frame rebuilt on
  the CPU. Measured: max |diff| 0 in every leg (~22 s with the 4 ranks'
  spawn on one worker's threads).
"""
import dataclasses
import re

import jax
import numpy as np
import pytest

import __graft_entry__ as jge
from crychic_renderer_tpu_torch import graft_entry as ge
from crychic_renderer_tpu_torch.parallel import launch
from test_torch_frame import PIX_BOUND, _leaves
from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def entries():
    return jge.entry(), ge.entry("cpu")


def _equal_leaves(jax_leaves, port_leaves, what):
    assert sorted(jax_leaves) == sorted(port_leaves), what
    for k, jv in jax_leaves.items():
        tv = port_leaves[k]
        if isinstance(jv, dict):
            _equal_leaves(jv, tv, f"{what}.{k}")
        elif jv is None or isinstance(jv, int):
            assert jv == tv, f"{what}.{k}"
        else:
            tv = np.asarray(tv)
            if jv.dtype == np.uint32 and tv.dtype == np.int32:
                tv = tv.view(np.uint32)
            assert jv.dtype == tv.dtype, f"{what}.{k}: {jv.dtype} {tv.dtype}"
            np.testing.assert_array_equal(jv, tv, err_msg=f"{what}.{k}")


def test_entry_cfg_scene_and_constants_equal_jax(entries):
    (jfn, (jscene, jconsts)), (fn, (scene, consts)) = entries
    assert (dataclasses.asdict(jfn.keywords["cfg"])
            == dataclasses.asdict(fn.keywords["cfg"]))
    assert not fn.keywords["cfg"].use_pallas
    _equal_leaves(_leaves(jscene), launch.host_leaves(scene), "scene")
    _equal_leaves(_leaves(jconsts), launch.host_leaves(consts), "consts")


def test_entry_frame_matches_jax(entries):
    (jfn, jargs), (fn, args) = entries
    ref = np.clip(np.asarray(jax.jit(jfn)(*jargs)), 0.0, 1.0)
    img = np.clip(fn(*args).numpy(), 0.0, 1.0)
    assert img.shape == ref.shape == (128, 256, 4)
    diff = np.abs(img - ref).max(axis=-1)
    frac = (diff > 0.02).mean()
    print(f"entry vs JAX: {frac:.4%} of pixels > 0.02, max {diff.max():.3g}")
    assert frac <= PIX_BOUND, f"{frac:.4%} of pixels > 0.02"


def test_dryrun_multichip_four_gloo_ranks(capsys):
    out = ge.dryrun_multichip(4, "gloo", "cpu", cpu_check=True)
    printed = capsys.readouterr().out
    for leg in ("xla 1080-row ok, image (1080, 128, 4)", "pallas band ok",
                "replica axis ok (2 x 2 mesh)"):
        assert f"dryrun_multichip(4): {leg}" in printed, printed
    assert printed.count("vs the CPU path") == 4, printed
    for leg in ("xla_1080", "pallas_band", "replica_0", "replica_1"):
        diff, frac = out[leg]
        assert frac < ge.SHARD_FRAC, (leg, frac)
        assert out[f"{leg}_cpu"] == out[leg], leg  # the CPU is the device
    # CPU ranks run the kernels' plain versions: no launch anywhere
    assert not any(out["launches"].values()), out["launches"]
    assert re.search(r"band_h 270, max diff", printed), printed
