"""The port's ops/gbuffer (torch) against the reference's GBuffer.hlsl
through tests/hlsl_oracle.py and against the JAX package's ops.gbuffer:
encode/decode at tests/test_hlsl_oracle.py's 200 random pixels (the same
generator and seed), and from_resolve on a small config-4 resolve. The
encode is concatenation, so every channel is EQUAL to the JAX package's
and the oracle's; the decode's renormalized normal is held to rtol 1e-6
against JAX and to the oracle test's rtol 1e-5 / atol 1e-6 against the
oracle.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hlsl_oracle as ho
from crychic_renderer_tpu.ops import gbuffer as jgb
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import gbuffer, raster
from crychic_renderer_tpu_torch.passes import frame as fr
from torch_threads import cap_torch_threads

cap_torch_threads()

KEYS = ("pos_w", "metalness", "albedo", "roughness", "normal_w",
        "shininess_alpha")


@pytest.fixture(scope="module")
def pixels():
    """tests/test_hlsl_oracle.py::test_gbuffer_codec_matches_oracle's
    inputs: 200 pixels, unnormalized normals."""
    rng = np.random.RandomState(37)
    N = 200
    pos = rng.uniform(-50, 50, (1, N, 3)).astype(np.float32)
    met = rng.uniform(0, 1, (1, N, 1)).astype(np.float32)
    alb = rng.uniform(0, 1, (1, N, 4)).astype(np.float32)
    rough = rng.uniform(0, 1, (1, N, 1)).astype(np.float32)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    nrm = (v * rng.uniform(0.5, 2.0, (N, 1))).astype(np.float32)[None]
    return pos, met, alb, rough, nrm


def test_codec_matches_oracle(pixels):
    gbs = [g.numpy() for g in gbuffer.encode(*map(torch.from_numpy,
                                                  pixels))]
    dec = {k: v.numpy() for k, v in gbuffer.decode(
        *map(torch.from_numpy, gbs)).items()}
    pos, met, alb, rough, nrm = pixels
    for i in range(pos.shape[1]):
        want_gb = ho.EncodePBRToGBuffer(pos[0, i], met[0, i, 0],
                                        alb[0, i, :3], rough[0, i, 0],
                                        nrm[0, i])
        for k in range(4):
            np.testing.assert_array_equal(gbs[k][0, i], want_gb[k])
        want = ho.DecodeGBuffer(*want_gb)
        np.testing.assert_array_equal(dec["pos_w"][0, i], want["pos"])
        np.testing.assert_array_equal(dec["metalness"][0, i, 0],
                                      want["metalness"])
        np.testing.assert_array_equal(dec["albedo"][0, i], want["albedo"])
        np.testing.assert_array_equal(dec["roughness"][0, i, 0],
                                      want["roughness"])
        np.testing.assert_allclose(dec["normal_w"][0, i], want["normal"],
                                   rtol=1e-5, atol=1e-6)


def test_codec_matches_jax(pixels):
    got = gbuffer.encode(*map(torch.from_numpy, pixels))
    ref = jgb.encode(*map(jnp.asarray, pixels))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    dec = gbuffer.decode(*got)
    jdec = jgb.decode(*ref)
    assert tuple(dec) == tuple(jdec) == KEYS
    for k in KEYS:
        if k == "normal_w":
            np.testing.assert_allclose(dec[k].numpy(), np.asarray(jdec[k]),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(dec[k].numpy(), np.asarray(jdec[k]))


def test_from_resolve_packs_the_frame_resolve():
    """from_resolve of a 120x68 config-4 resolve (the port's CPU path)
    equals the JAX package's from_resolve of the same channels, and its
    decode gives the resolve's channels back (the normal renormalized)."""
    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(cfg, width=120, height=68, shadow_map_size=128)
    r = Renderer(scene, cfg, lights=lights, device="cpu")
    cfg = r.cfg
    c = r.frame_constants(0.0)
    tris, attr = fr.main_view_tris(r.device_scene, c, cfg)
    depth, tid, _ = raster.rasterize(tris, cfg.width, cfg.height,
                                     cfg.pair_capacity)
    g = fr.resolve_gbuffer(r.device_scene, c, cfg, tris, depth, tid, attr)
    assert bool((tid >= 0).any())
    gbs = gbuffer.from_resolve(g)
    ref = jgb.from_resolve({k: jnp.asarray(g[k].numpy()) for k in
                            ("pos_w", "metalness", "albedo", "roughness",
                             "normal_w")})
    for k, (a, b) in enumerate(zip(gbs, ref)):
        assert a.shape == (cfg.height, cfg.width, 4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), f"GB{k}")
    dec = gbuffer.decode(*gbs)
    for k in ("pos_w", "metalness", "roughness"):
        torch.testing.assert_close(dec[k], g[k], rtol=0, atol=0)
    torch.testing.assert_close(dec["albedo"], g["albedo"][..., :3], rtol=0,
                               atol=0)
    # the resolve's normal is not unit length; decode renormalizes it
    n = g["normal_w"][g["valid"]]
    torch.testing.assert_close(dec["normal_w"][g["valid"]],
                               n / n.norm(dim=-1, keepdim=True),
                               rtol=1e-6, atol=1e-6)
