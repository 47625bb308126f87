"""The port's host side (numpy) against the JAX package's: the config-4
scene, the texture pair pool, the SSAO tables, the device-scene leaves and
the per-frame constants must be EQUAL, bit for bit — they are the same
numpy code with jax removed (the SSAO random texture replicates the JAX
package's native helper in numpy)."""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu.ops import ssao as jssao
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.ops import ssao as tssao
from torch_threads import cap_torch_threads

cap_torch_threads()


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def configs():
    return jsb.CONFIGS[4](), tsb.CONFIGS[4]()


def assert_configs_equal(jax_config, port_config):
    """The (scene, cfg, lights) that each package's function of one
    BASELINE config returns: equal config, texture names and every scene
    and light leaf."""
    (js, jc, jl), (ts, tc, tl) = jax_config, port_config
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert js.texture_names == ts.texture_names
    for layer in ("opaque", "shadow"):
        jd, td = getattr(js, layer), getattr(ts, layer)
        for f in dataclasses.fields(jd):
            _eq(getattr(jd, f.name), getattr(td, f.name), f"{layer}.{f.name}")
    for f in dataclasses.fields(js.material_bank):
        _eq(getattr(js.material_bank, f.name),
            getattr(ts.material_bank, f.name), f"material_bank.{f.name}")
    for f in dataclasses.fields(jl):
        _eq(getattr(jl, f.name), getattr(tl, f.name), f"lights.{f.name}")


@pytest.mark.parametrize("cfg_id", [1, 4])
def test_scene_and_config_equal(cfg_id):
    assert_configs_equal(jsb.CONFIGS[cfg_id](), tsb.CONFIGS[cfg_id]())


def test_pair_pool_equal(configs):
    (js, _, _), (ts, _, _) = configs
    jpool, jmat, jspecs = jren.build_pair_pool(js, dual=True)
    tpool, tmat, tspecs = tren.build_pair_pool(ts, dual=True)
    _eq(jpool.data, tpool.data, "pair pool")
    assert jpool.n_big == tpool.n_big and jpool.dual == tpool.dual
    _eq(jmat, tmat, "mat_pair")
    assert jspecs == tspecs


def test_ssao_tables_equal():
    _eq(jssao.build_offset_vectors(), tssao.build_offset_vectors(),
        "offset vectors")
    jtex = jssao.build_random_vector_texture()
    ttex = tssao.build_random_vector_texture()
    _eq(jtex, ttex, "random vector texture")
    for h, w in ((540, 960), (67, 120)):
        _eq(jssao.build_random_field(jtex, h, w),
            tssao.build_random_field(ttex, h, w), f"random field {h}x{w}")
    _eq(jssao.calc_gauss_weights(2.5), tssao.calc_gauss_weights(2.5),
        "gauss weights")


def test_device_scene_leaves_and_frame_constants_equal(configs):
    """Every leaf the device scene is built from, and every per-frame
    constant, equal at config 4's full 1080p settings."""
    (js, jc, jl), (ts, tc, tl) = configs
    jr = jren.Renderer(js, jc, lights=jl, auto_capacity=False)
    tr = tren.Renderer(ts, tc, lights=tl, auto_capacity=False,
                       device="cpu")
    jd, td = jr.device_scene, tr.device_scene
    for f in dataclasses.fields(jd):
        jv, tv = getattr(jd, f.name), getattr(td, f.name)
        if f.name in ("opaque", "shadow"):
            for g in ("positions", "normals", "tangents", "uvs",
                      "vertex_instance", "indices", "worlds",
                      "tex_transforms", "material_indices"):
                _eq(getattr(jv, g), getattr(tv, g).numpy(), f"{f.name}.{g}")
        elif f.name == "n_big_pairs":
            assert jv == tv
        elif jv is None:
            assert tv is None
        else:
            _eq(jv, tv.numpy(), f.name)
    jconst = jr.frame_constants_np(0.25)
    tconst = tr.frame_constants_np(0.25)
    for f in dataclasses.fields(jconst):
        jv, tv = getattr(jconst, f.name), tconst[f.name]
        if jv is None:
            assert tv is None, f.name
        else:
            _eq(jv, tv, f.name)
