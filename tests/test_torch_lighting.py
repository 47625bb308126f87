"""The port's Blinn-Phong lighting and alpha-layer pieces against the JAX
package's, on the same seeded numpy inputs, with the JAX side run
eagerly (op by op; its peel's triangle loop is a traced fori_loop).

Tolerances, with the measured values:

- compute_lighting (directional, point and spot lights, the light index
  running on across the three loops): max |diff| <= 2e-5; measured
  2.4e-7 with 16 point lights, <= 6e-8 for the others (the pow of the
  specular lobe and sqrt are library calls on both sides).
- uv_derivatives: bit equal.
- _alpha_peel and alpha_punch_window: triangle ids equal (the port
  evaluates chunks of triangles as dense tensors; ties go to the earliest
  triangle as in the JAX loop), depth within 1e-6 where they agree;
  measured: ids equal, depth 2.4e-7 (XLA fuses the loop's plane
  evaluation into FMAs); the window origin equal, the merged map within
  1.2e-7.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.ops import rasterizer as jrz
from crychic_renderer_tpu.ops import sampling as jsamp
from crychic_renderer_tpu.ops import shading as jshade
from crychic_renderer_tpu.passes import frame as jfr
from crychic_renderer_tpu_torch.config import RenderConfig
from crychic_renderer_tpu_torch.models.scenes_baseline import wire_fence_chain
from crychic_renderer_tpu_torch.ops import rasterizer as rz
from crychic_renderer_tpu_torch.ops import sampling, shading
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

LIGHT_ATOL = 2e-5
DZ = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Blinn-Phong
# ---------------------------------------------------------------------------

# (num_dir, num_point, num_spot): the forward 3-light rig (config 2),
# config 3's 16 point lights, and spot lights no config has
RIGS = {"dir3": (3, 0, 0), "point16": (0, 16, 0), "spot2": (1, 0, 2),
        "mixed": (1, 3, 2)}


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_compute_lighting_matches_jax(rig):
    nd, npt, ns = RIGS[rig]
    rng = np.random.default_rng(sorted(RIGS).index(rig))
    shape = (24, 40)

    def unit(*s):
        v = rng.normal(size=s + (3,)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    n = 16
    lights = dict(
        strength=rng.uniform(0.2, 1.0, (n, 3)),
        direction=unit(n),
        position=rng.uniform(-6, 6, (n, 3)),
        falloff_start=rng.uniform(0.5, 2.0, n),
        falloff_end=rng.uniform(4.0, 10.0, n),
        spot_power=rng.uniform(1.0, 64.0, n))
    lights = {k: v.astype(np.float32) for k, v in lights.items()}
    counts = dict(num_dir=nd, num_point=npt, num_spot=ns)
    pix = dict(
        normal=unit(*shape), to_eye=unit(*shape),
        pos_w=rng.uniform(-8, 8, shape + (3,)),
        diffuse_albedo=rng.random(shape + (4,)),
        fresnel_r0=rng.uniform(0.02, 0.9, shape + (3,)),
        shininess=rng.random(shape + (1,)),
        shadow_factor=rng.random(shape + (1,)))
    pix = {k: v.astype(np.float32) for k, v in pix.items()}
    ref = jshade.compute_lighting(
        types.SimpleNamespace(**{k: jnp.asarray(v)
                                 for k, v in lights.items()}, **counts),
        **{k: jnp.asarray(v) for k, v in pix.items()})
    got = shading.compute_lighting(
        types.SimpleNamespace(**{k: _t(v) for k, v in lights.items()},
                              **counts),
        **{k: _t(v) for k, v in pix.items()})
    ref = np.asarray(ref)
    assert ref.shape == got.shape == shape + (3,)
    assert ref.max() > 0.1  # the lights reach the pixels
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LIGHT_ATOL)


def test_uv_derivatives_bit_equal():
    rng = np.random.default_rng(11)
    uv = rng.normal(0, 3, (17, 23, 2)).astype(np.float32)
    for ref, got in zip(jsamp.uv_derivatives(jnp.asarray(uv)),
                        sampling.uv_derivatives(_t(uv))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# The alpha peel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alpha_scene():
    """A two-material scene for the peel, in both packages: material 0
    samples the synthetic wire-fence chain (alpha holes), material 1 a
    white texture; (JAX scene, port scene)."""
    white = [np.full((1, 1, 4), 255, np.uint8)]
    normal = [np.full((1, 1, 4), 128, np.uint8)]
    host = sampling.PairPool.build(
        [(wire_fence_chain(3), normal), (white, normal)], 2, dual=True)
    albedo = np.array([[1, 1, 1, 1], [0.9, 0.8, 0.7, 1]], np.float32)
    mat_pair = np.array([0, 1], np.int32)
    jscene = types.SimpleNamespace(
        pair_pool=jsamp.PairPool(jnp.asarray(host.data), 2, dual=True),
        mat_pair=jnp.asarray(mat_pair), mat_albedo=jnp.asarray(albedo))
    tscene = types.SimpleNamespace(
        pair_pool=sampling.PairPool(_t(host.data.view(np.int32)), 2,
                                    dual=True),
        mat_pair=_t(mat_pair), mat_albedo=_t(albedo))
    return jscene, tscene


def _random_tris(rng, T, W, H):
    """Front-facing screen triangles over (and past) a W x H screen, with
    some invalid, some sharing a depth plane (ties), uv within a third of
    the texture and material 0 (the wire fence) or 1."""
    c = rng.uniform([-4, -4], [W + 4, H + 4], (T, 1, 2))
    xy = c + rng.normal(0, 9, (T, 3, 2))
    a = xy[:, 1] - xy[:, 0]
    b = xy[:, 2] - xy[:, 0]
    back = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0] < 0
    xy[back] = xy[back][:, ::-1]
    # depth varies slowly over a triangle, as on a fence quad: XLA fuses
    # the JAX loop's plane evaluation into FMAs, which differ from the
    # rounded products by an ulp of the largest term, not of z
    z = np.clip(rng.uniform(0.05, 0.95, (T, 1))
                + rng.normal(0, 0.02, (T, 3)), 0.0, 1.0)
    z[T // 2:T // 2 + 4] = z[T // 2]  # equal depth planes: ties
    xy[T // 2 + 1:T // 2 + 4] = xy[T // 2]
    tris = dict(xy=np.round(xy * 256) / 256, z=z,
                inv_w=rng.uniform(0.2, 2.0, (T, 3)),
                valid=rng.random(T) > 0.1)
    # a third of a texture repeat per triangle: the wire grid's holes
    # survive the mip the peel samples
    uv = rng.uniform(-1, 2, (T, 1, 2)) + rng.uniform(0, 0.3, (T, 3, 2))
    mat = (rng.random(T) < 0.3).astype(np.int32)
    return ({k: v.astype(np.float32) if v.dtype.kind == "f" else v
             for k, v in tris.items()}, uv.astype(np.float32), mat)


@pytest.mark.parametrize("peels", [1, 2, 3])
def test_alpha_peel_matches_jax(alpha_scene, peels):
    jscene, tscene = alpha_scene
    W, H = 48, 40
    tris, uv, mat = _random_tris(np.random.default_rng(21), 40, W, H)
    px = np.arange(W, dtype=np.float32)[None, :] + 0.5
    py = np.arange(H, dtype=np.float32)[:, None] + 0.5
    z_j, id_j = jfr._alpha_peel(
        jrz.ScreenTris(**{k: jnp.asarray(v) for k, v in tris.items()}),
        jnp.asarray(uv), jnp.asarray(mat), jscene, jnp.asarray(px),
        jnp.asarray(py), peels, 0.1)
    z_t, id_t = fr._alpha_peel(
        rz.ScreenTris(**{k: _t(v) for k, v in tris.items()}), _t(uv),
        _t(mat), tscene, _t(px), _t(py), peels, 0.1)
    id_j, z_j = np.asarray(id_j), np.asarray(z_j)
    np.testing.assert_array_equal(id_t.numpy(), id_j)
    hit = id_j >= 0
    assert 0.2 < hit.mean() < 1.0
    assert np.abs(z_t.numpy()[hit] - z_j[hit]).max() <= DZ
    assert np.isinf(z_t.numpy()[~hit]).all()


def test_alpha_peel_chunks_agree(alpha_scene, monkeypatch):
    """Chunks of 1, 3 and all triangles give the same ids and depths: the
    earliest triangle wins a tie across chunks as within one."""
    _, tscene = alpha_scene
    W, H = 48, 40
    tris, uv, mat = _random_tris(np.random.default_rng(22), 40, W, H)
    args = (rz.ScreenTris(**{k: _t(v) for k, v in tris.items()}), _t(uv),
            _t(mat), tscene,
            torch.arange(W, dtype=torch.float32)[None, :] + 0.5,
            torch.arange(H, dtype=torch.float32)[:, None] + 0.5, 2, 0.1)
    outs = []
    for chunk in (1, 3, 40):
        monkeypatch.setattr(fr, "PEEL_CHUNK_ELEMS", chunk * W * H)
        outs.append(fr._alpha_peel(*args))
    for z, ids in outs[1:]:
        assert torch.equal(ids, outs[0][1]) and torch.equal(z, outs[0][0])
    # the holes are exercised: a second peel finds fragments behind them
    one = fr._alpha_peel(*args[:-2], 1, 0.1)[1]
    assert int((one >= 0).sum()) < int((outs[0][1] >= 0).sum())


def test_alpha_punch_window_matches_jax(alpha_scene):
    """One cascade's punch window: world triangles through an orthographic
    light transform into a 64^2 map, peeled inside a 32^2 window placed
    over their bounding box."""
    jscene, tscene = alpha_scene
    rng = np.random.default_rng(23)
    T = 30
    c = rng.uniform(-2, 4, (T, 1, 3))
    world = np.concatenate([c + rng.normal(0, 1.5, (T, 3, 3)),
                            np.ones((T, 3, 1))], -1).astype(np.float32)
    uv = rng.uniform(0, 2, (T, 3, 2)).astype(np.float32)
    mat = (rng.random(T) < 0.7).astype(np.int32) ^ 1
    vp = np.diag([0.1, 0.1, 0.05, 1.0]).astype(np.float32)
    vp[3, 2] = 0.5  # z in [0, 1]
    cfg = RenderConfig(shadow_map_size=64, alpha_shadow_window=32)
    ref = jfr.alpha_punch_window(jscene, cfg, jnp.asarray(world),
                                 jnp.asarray(uv), jnp.asarray(mat),
                                 jnp.asarray(vp))
    got = fr.alpha_punch_window(tscene, cfg, _t(world), _t(uv), _t(mat),
                                _t(vp))
    az_j, aid_j, oy_j, ox_j = map(np.asarray, ref)
    az_t, aid_t, oy_t, ox_t = got
    assert (int(oy_t), int(ox_t)) == (int(oy_j), int(ox_j)) != (0, 0)
    np.testing.assert_array_equal(aid_t.numpy(), aid_j)
    hit = aid_j >= 0
    assert 0.05 < hit.mean() < 1.0
    assert np.abs(az_t.numpy()[hit] - az_j[hit]).max() <= DZ
    maps = np.random.default_rng(24).uniform(0.5, 1, (64, 64))
    maps = maps.astype(np.float32)
    merged = fr.alpha_apply_punch(_t(maps), *got).numpy()
    np.testing.assert_allclose(
        merged, np.asarray(jfr.alpha_apply_punch(jnp.asarray(maps),
                                                 *map(jnp.asarray, ref))),
        rtol=0, atol=DZ)
    assert (merged < maps).any() and (merged <= maps).all()
