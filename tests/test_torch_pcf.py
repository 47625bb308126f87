"""The port's soft-disk PCF (ops/pcf.py, the plain version of csrc/pcf.cu)
against the JAX package: the Pallas kernel K6 in interpret mode,
``poisson_pcf_windowed`` and ``cascade_shadow_factor`` with
``soft_radius_texels=2.5``. Inputs are made with numpy from seeds.

Tolerances, and why:

- Against K6 (``experiments/pcf_probe.py:46``): 1e-6. K6 is handed the
  port's own parameters (cos and sin included) and its windows in K6's
  block-quad layout, so only the order of the <= 64 tent-weight sums
  differs. Measured max 2.4e-7.
- Against ``poisson_pcf_windowed`` and ``cascade_shadow_factor`` with the
  rotation hash shared: 1e-6. The JAX side runs eagerly (op by op, as
  torch rounds), with its ``nrand`` replaced for the call by the port's
  on the same values; what is left are XLA's and torch's cos and sin of
  the same angle (an ulp) and the sum order. Measured max 3.0e-7.
- With each side's own hash: the hash is fract(sin(...) * 43758.5), so an
  ulp of difference between XLA's and torch's sin moves the angle by an
  ulp of the product (up to 3.9e-3), and where the product sits that
  close to an integer, fract wraps and the angle jumps by ~1. The angles
  differ by more than 1e-5 on 3.6% of these uv (bound 10%, and 2e-2 at
  most after wraps are folded). The factors move by more than 1e-5 on
  1.25% of receivers (bound 10%) and by at most 5.4e-4; a wrap would move
  one by up to ~0.1, so the share above 1e-3 is bounded by 1% (measured
  0).
"""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crychic_renderer_tpu.ops import shadows as jshadows
from crychic_renderer_tpu_torch.ops import pcf, shadows
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, C = 256, 4
STRICT = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _maps(seed):
    """Smooth, patchy depth maps: each receiver below sits near its map's
    depth, so most of them fall in a penumbra."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    ph = rng.uniform(0, 6, (C, 2))
    return np.stack([
        0.5 + 0.3 * np.sin(xx / (7.0 + c) + ph[c, 0])
        * np.cos(yy / (5.0 + c) + ph[c, 1]) for c in range(C)]).astype(
            np.float32)


def _receivers(seed, maps, n, lo, hi, homogeneous=False):
    """(n, 4) shadow-space positions with u, v in [lo, hi], depths within
    0.05 of the map's, and (n,) cascades."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(lo, hi, n).astype(np.float32)
    v = rng.uniform(lo, hi, n).astype(np.float32)
    casc = rng.integers(0, C, n)
    ix = np.clip((u * S).astype(int), 0, S - 1)
    iy = np.clip((v * S).astype(int), 0, S - 1)
    z = (maps[casc, iy, ix] + rng.uniform(-0.05, 0.05, n)).astype(np.float32)
    w = (rng.uniform(0.5, 2.0, n) if homogeneous
         else np.ones(n)).astype(np.float32)
    pos = np.stack([u * w, v * w, z * w, w], -1).astype(np.float32)
    return pos, casc


def _port_pcf(maps, pos, casc):
    params = pcf.receiver_params(_t(pos), _t(casc), S)
    return pcf.soft_pcf(pcf.quantize_map(_t(maps)), params, 2.5), params


@pytest.fixture
def shared_hash(monkeypatch):
    """Run the JAX package's soft PCF with the port's rotation hash on the
    same (eager) values."""
    def port_nrand(uv):
        return jnp.asarray(pcf.nrand(_t(np.asarray(uv))).numpy())

    monkeypatch.setattr(jshadows, "nrand", port_nrand)


def test_disk_and_taps_match_jax_and_the_kernel_source():
    np.testing.assert_array_equal(pcf.POISSON_DISK, jshadows.POISSON_DISK)
    assert pcf.N_SAMPLE == jshadows.N_SAMPLE == 16
    assert pcf.OUTER_TAPS == (1, 7, 13)
    with open(os.path.join(REPO, "crychic_renderer_tpu_torch", "csrc",
                           "pcf.cu")) as f:
        src = f.read()
    for axis, name in ((0, "kDiskX"), (1, "kDiskY")):
        body = re.search(name + r"\[N_SAMPLE\] = \{(.*?)\};", src, re.S)
        vals = [float.fromhex(v.strip().rstrip("f"))
                for v in body.group(1).split(",")]
        np.testing.assert_array_equal(
            np.array(vals, np.float32), pcf.POISSON_DISK[:, axis], name)
    mask = re.search(r"OUTER_TAPS = (.*?);", src).group(1)
    assert sorted(int(b) for b in re.findall(r"1u << (\d+)", mask)) \
        == list(pcf.OUTER_TAPS)


def test_quantized_map_is_the_jax_u16_depth():
    maps = _maps(1)
    maps[0, :4] = 1.5  # clipped
    maps[1, :4] = -0.25
    got = pcf.quantize_map(_t(maps)).numpy().view(np.uint16)[:, :S, :S]
    packed = np.asarray(jshadows.pack_depth_rows_u16(jnp.asarray(maps)))
    np.testing.assert_array_equal(got[..., 0::2], packed & 0xFFFF)
    np.testing.assert_array_equal(got[..., 1::2], packed >> 16)


def _k6_interpret(params, qmap, layout):
    """K6 (experiments/pcf_probe.py make_kernel("v0_cond")) in interpret
    mode on the port's parameters, with the windows in K6's block-quad
    layout (texel f = q*64 + (wy%8)*8 + wx%8, q = (wy//8)*2 + wx//8) or in
    the row-major layout f = wy*16 + wx that superwindow_maps_u16 builds
    now and the probe's main() hands K6; two texels per u32 lane. The
    windows are cut from the port's window-ready buffer at the kernel's
    address, rows 8*qy0 + wy and columns 8*qx0 + wx."""
    spec = importlib.util.spec_from_file_location(
        "pcf_probe", os.path.join(REPO, "experiments", "pcf_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    q = qmap.numpy().view(np.uint16)
    cx, cy, dq, c, s, casc = params.numpy()
    casc = casc.astype(np.int64)
    nb = S // 8
    qx0 = np.clip((np.floor(cx).astype(np.int64) - 3) >> 3, 0, nb - 1)
    qy0 = np.clip((np.floor(cy).astype(np.int64) - 3) >> 3, 0, nb - 1)
    w = np.arange(16)
    rows = qy0[:, None] * 8 + w
    cols = qx0[:, None] * 8 + w
    win = q[casc[:, None, None], rows[:, :, None],
            cols[:, None, :]].astype(np.uint32)  # (M, 16, 16) row-major
    f = np.arange(256)
    if layout == "block_quad":
        quad, inner = f // 64, f % 64
        bq = win[:, (quad // 2) * 8 + inner // 8, (quad % 2) * 8 + inner % 8]
    else:
        bq = win.reshape(-1, 256)
    m = len(cx)
    G = probe._PCF_GROUP
    n_pad = -(-m // G) * G
    win_flat = np.zeros((n_pad, 128), np.uint32)
    win_flat[:m] = bq[:, 0::2] | (bq[:, 1::2] << 16)
    par_flat = np.full((n_pad, 8), -1.0, np.float32)
    par_flat[:m, :5] = np.stack(
        [dq, cx - 8 * qx0, cy - 8 * qy0, c, s], -1)
    progs = n_pad // G
    out = pl.pallas_call(
        probe.make_kernel("v0_cond"), grid=(progs,),
        in_specs=[pl.BlockSpec((G, 128), lambda i: (i, 0)),
                  pl.BlockSpec((G, 8), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, G // 8), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((progs * 8, G // 8), jnp.float32),
        interpret=True)(jnp.asarray(win_flat), jnp.asarray(par_flat))
    out = np.asarray(out).reshape(progs, 8, G // 8).transpose(0, 2, 1)
    return out.reshape(-1)[:m]


@pytest.mark.parametrize("layout", ["block_quad", "row_major"])
def test_plain_matches_k6_interpret(layout):
    """Interior receivers, where K6's 16-row evaluation of every tap and
    the port's 8-row evaluation of the inner taps cover the same texels.
    In its own layout K6 agrees to 1e-6; handed the row-major windows, as
    its probe's main() does, it disagrees (the probe's stale layout, see
    ROADMAP.md; measured max |diff| 0.66, mean 0.17)."""
    maps = _maps(2)
    pos, casc = _receivers(3, maps, 2048, 0.05, 0.95)
    got, params = _port_pcf(maps, pos, casc)
    got = got.numpy()
    assert 0.2 < ((got > 0) & (got < 1)).mean()  # penumbrae
    ref = _k6_interpret(params, pcf.quantize_map(_t(maps)), layout)
    if layout == "block_quad":
        np.testing.assert_allclose(got, ref, rtol=0, atol=STRICT)
    else:
        assert np.abs(got - ref).max() > 0.1


@pytest.mark.parametrize("where", ["interior", "edges"])
def test_plain_matches_poisson_pcf_windowed(shared_hash, where):
    """Edges: u, v in [-0.03, 1.03] with w != 1, so windows clamp at the
    map's border rows and columns and the 8-row extraction clamps too."""
    maps = _maps(4)
    lo, hi = (0.05, 0.95) if where == "interior" else (-0.03, 1.03)
    pos, casc = _receivers(5, maps, 3000, lo, hi,
                           homogeneous=where == "edges")
    got, params = _port_pcf(maps, pos, casc)
    if where == "edges":
        cx, cy = params[0].numpy(), params[1].numpy()
        edge = (cx < 4) | (cx > S - 5) | (cy < 4) | (cy > S - 5)
        assert edge.mean() > 0.05
    ref = jshadows.poisson_pcf_windowed(
        jnp.asarray(maps), jnp.asarray(casc.astype(np.int32)),
        jnp.asarray(pos), S, soft_radius_texels=2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=STRICT)


def test_nrand_matches_jax_up_to_the_hash_amplification():
    rng = np.random.default_rng(6)
    uv = rng.uniform(-0.1, 1.1, (20000, 2)).astype(np.float32)
    got = pcf.nrand(_t(uv)).numpy()
    ref = np.asarray(jshadows.nrand(jnp.asarray(uv)))
    d = np.abs(got - ref)
    d = np.minimum(d, 1.0 - d)  # fract wraps: 0.999 and 0.001 are neighbours
    assert (d > 1e-5).mean() < 0.10, (d > 1e-5).mean()
    assert d.max() < 2e-2, d.max()  # a few ulps of the 43758.5 product


def _cascade_inputs(seed):
    """test_torch_ops.py's recipe: power-of-two shadow transforms make
    every projection exact, so both sides hash the same uv."""
    rng = np.random.default_rng(seed)
    maps = _maps(seed)
    tr = np.zeros((4, 4, 4), np.float32)
    for c in range(4):
        tr[c] = np.diag([1 / 256, 1 / 256, 1 / 256, 1.0])
        tr[c, 3, :3] = (0.5 + c / 64, 0.5 - c / 64, 0.5)
    shape = (40, 50)
    x = rng.uniform(-115, 115, shape)
    y = rng.uniform(-115, 115, shape)
    u = np.clip(x / 256 + 0.5, 0, 0.999)
    v = np.clip(y / 256 + 0.5, 0, 0.999)
    d = maps[0, (v * S).astype(int), (u * S).astype(int)] \
        + rng.uniform(-0.05, 0.05, shape)
    z = (d.astype(np.float32) - np.float32(0.5)) * np.float32(256)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    dead = rng.random(shape) < 0.1
    return maps, tr, pos, np.zeros(3, np.float32), dead


def _cascade_pair(seed, quirk):
    maps, tr, pos, eye, dead = _cascade_inputs(seed)
    ref = jshadows.cascade_shadow_factor(
        jnp.asarray(maps), jnp.asarray(tr), jnp.asarray(pos),
        jnp.asarray(eye), S, deferred_blend_quirk=quirk,
        soft_radius_texels=2.5, dead=jnp.asarray(dead))
    got = shadows.cascade_shadow_factor(
        _t(maps), _t(tr), _t(pos), _t(eye), S, deferred_blend_quirk=quirk,
        soft_radius_texels=2.5, dead=_t(dead))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("quirk", [True, False])
def test_cascade_shadow_factor_soft_matches_jax(shared_hash, quirk):
    ref, got = _cascade_pair(7, quirk)
    soft = (got > 0) & (got < 1)
    assert soft.mean() > 0.2, soft.mean()
    np.testing.assert_allclose(got, ref, rtol=0, atol=STRICT)


def test_cascade_shadow_factor_soft_own_hashes():
    ref, got = _cascade_pair(8, True)
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() <= 0.10, (d > 1e-5).mean()
    assert (d > 1e-3).mean() <= 0.01, (d > 1e-3).mean()


def test_soft_pcf_wrapper_refuses():
    """Another device, and a disk wider than the window holds, are refused,
    never evaluated some other way."""
    q = torch.empty((4, 64, 64), dtype=torch.int16, device="meta")
    p = torch.empty((6, 10), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pcf.soft_pcf(q, p, 2.5)
    with pytest.raises(ValueError, match="window"):
        pcf.soft_pcf(torch.zeros((4, 64, 64), dtype=torch.int16),
                     torch.zeros((6, 10)), 3.0)
