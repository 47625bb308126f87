"""The soft PCF's window-ready map (ops/pcf.py quantize_map, OwnedMaps)
against the JAX package's superwindow tables, and the plain version that
reads it against ``poisson_pcf_windowed``. Inputs are made with numpy
from seeds, at S = 136 and 520 (an S whose 2*S-byte rows are off the
H100's 32-byte texture pitch alignment, which the padded pitch fixes).

- Windows: bit equal. For every block (qy0, qx0), the buffer's 16x16
  rectangle at rows 8*qy0 .. + 15 and columns 8*qx0 .. + 15 is the JAX
  package's ``superwindow_maps_u16`` window, unpacked; the padding past
  the map repeats its last block where the JAX window clamps
  min(q + 1, S/8 - 1).
- The plain version against ``poisson_pcf_windowed`` with the rotation
  hash shared (tests/test_torch_pcf.py's fixture and its 1e-6, for the
  same reasons: an ulp of cos and sin, and the order of the sums).
  Receivers whose coordinate is NaN are the one difference: the JAX
  tent max(1 - |w - NaN|, 0) is NaN, the port's masks count no texel of
  a NaN tap (csrc/pcf.cu), so the port gives 0.0 there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crychic_renderer_tpu.ops import shadows as jshadows
from crychic_renderer_tpu_torch.ops import pcf
from torch_threads import cap_torch_threads

cap_torch_threads()

C = 4
STRICT = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _maps(seed, S):
    """Smooth, patchy depth maps with texels past [0, 1] (clipped), so
    most receivers near them fall in a penumbra."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    ph = rng.uniform(0, 6, (C, 2))
    maps = np.stack([
        0.5 + 0.3 * np.sin(xx / (7.0 + c) + ph[c, 0])
        * np.cos(yy / (5.0 + c) + ph[c, 1]) for c in range(C)])
    maps[0, :3] = 1.25
    maps[1, :, -3:] = -0.1
    return maps.astype(np.float32)


def _windows(qmap, S):
    """(C, S/8, S/8, 16, 16) uint16: every block's 16x16 rectangle of the
    window-ready buffer, at the kernel's address."""
    q = np.ascontiguousarray(qmap.numpy()).view(np.uint16)
    nb = S // 8
    s0, s1, s2 = q.strides
    return np.lib.stride_tricks.as_strided(
        q, (q.shape[0], nb, nb, 16, 16), (s0, 8 * s1, 8 * s2, s1, s2))


def _jax_windows(maps):
    """superwindow_maps_u16 unpacked: (C, S/8, S/8, 16, 16) uint16."""
    sw = np.asarray(jshadows.superwindow_maps_u16(jnp.asarray(maps)))
    lo = (sw & 0xFFFF).astype(np.uint16)
    hi = (sw >> 16).astype(np.uint16)
    win = np.stack([lo, hi], -1).reshape(sw.shape[:3] + (256,))
    return win.reshape(sw.shape[:3] + (16, 16))


@pytest.mark.parametrize("S", [136, 520])
@pytest.mark.parametrize("source", ["f32", "int16"])
def test_windows_equal_jax_superwindows(S, source):
    """f32 depths, or their int16 bits as the band frame's packed atlas
    hands them, give the same buffer, whose every window is JAX's."""
    maps = _maps(S, S)
    src = _t(maps) if source == "f32" else pcf.quantize_bits(_t(maps))
    q = pcf.quantize_map(src)
    assert tuple(q.shape) == (C, S + 8, pcf.window_pitch(S))
    assert q.dtype == torch.int16 and q.is_contiguous()
    assert q.shape[2] % pcf.PITCH_TEXELS == 0 and q.shape[2] > S + 8
    np.testing.assert_array_equal(_windows(q, S), _jax_windows(maps))
    assert not q[..., S + 8:].any()  # the pitch's tail stays zero
    if source == "int16":
        assert torch.equal(q, pcf.quantize_map(_t(maps)))


def _receivers(seed, maps, n, lo, hi):
    """(n, 4) homogeneous shadow-space positions, u, v in [lo, hi], w in
    [0.5, 2], depths within 0.05 of the map's, and (n,) cascades."""
    S = maps.shape[1]
    rng = np.random.default_rng(seed)
    u = rng.uniform(lo, hi, n).astype(np.float32)
    v = rng.uniform(lo, hi, n).astype(np.float32)
    casc = rng.integers(0, C, n)
    ix = np.clip((u * S).astype(int), 0, S - 1)
    iy = np.clip((v * S).astype(int), 0, S - 1)
    z = (np.clip(maps[casc, iy, ix], 0, 1)
         + rng.uniform(-0.05, 0.05, n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    pos = np.stack([u * w, v * w, z * w, w], -1).astype(np.float32)
    return pos, casc


@pytest.fixture
def shared_hash(monkeypatch):
    """The JAX package's soft PCF with the port's rotation hash on the
    same (eager) values."""
    def port_nrand(uv):
        return jnp.asarray(pcf.nrand(_t(np.asarray(uv))).numpy())

    monkeypatch.setattr(jshadows, "nrand", port_nrand)


@pytest.mark.parametrize("S", [136, 520])
@pytest.mark.parametrize("where", ["interior", "edges"])
def test_plain_on_the_buffer_matches_poisson_pcf_windowed(shared_hash, S,
                                                          where):
    """Edges: u, v in [-0.03, 1.03], so windows sit on the last block
    (read from the padding) and clamp at the first; a few receivers get a
    NaN or a +-1e30 coordinate."""
    maps = _maps(S + 1, S)
    lo, hi = (0.05, 0.95) if where == "interior" else (-0.03, 1.03)
    pos, casc = _receivers(S + 2, maps, 3000, lo, hi)
    nan_rows = []
    if where == "edges":
        extreme = [np.nan, 1e30, -1e30]
        for i in range(12):  # each of x, y, z, w by turns
            pos[i, i % 4] = extreme[i % 3]
            if i % 3 == 0 and i % 4 != 2:  # a NaN u or v (a NaN z: 0.0)
                nan_rows.append(i)
    params = pcf.receiver_params(_t(pos), _t(casc), S)
    got = pcf.soft_pcf_plain(pcf.quantize_map(_t(maps)), params, 2.5).numpy()
    nb = S // 8
    corner = np.clip(np.nan_to_num(params[:2].numpy()), -2.0 ** 30,
                     2.0 ** 30)
    q = np.clip((np.floor(corner) - 3).astype(np.int64) >> 3, 0, nb - 1)
    last = (q == nb - 1).any(axis=0).mean()
    if where == "edges":
        assert last > 0.05, last  # windows that read the padding
    soft = ((got > 0) & (got < 1)).mean()
    assert soft > 0.2, soft
    ref = np.asarray(jshadows.poisson_pcf_windowed(
        jnp.asarray(maps), jnp.asarray(casc.astype(np.int32)),
        jnp.asarray(pos), S, soft_radius_texels=2.5))
    keep = np.ones(len(got), bool)
    keep[nan_rows] = False
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=STRICT)
    assert np.isnan(ref[nan_rows]).all() and (got[nan_rows] == 0.0).all()


def test_owned_maps_take_writes_the_window_ready_buffer():
    """OwnedMaps.take writes the same buffer as the eager quantize_map, in
    the same tensor every frame, from f32 and from int16 bits."""
    rng = np.random.default_rng(9)
    maps = _t(rng.uniform(-0.1, 1.1, (2, 72, 72)).astype(np.float32))
    owned = pcf.OwnedMaps()
    ptrs = []
    for src in (maps, pcf.quantize_bits(maps)):
        with pcf.owned_maps(owned):
            q = pcf.quantize_map(src)
        ptrs.append(q.data_ptr())
        assert tuple(q.shape) == pcf.window_shape(2, 72)
        assert torch.equal(q, pcf.quantize_map(maps))
        assert pcf.map_size(q) == 72 and owned.texture(q) == (0, 0)
    assert ptrs[0] == ptrs[1]
    with pcf.owned_maps(owned), pytest.raises(RuntimeError, match="shape"):
        pcf.quantize_map(maps[:, :64, :64])
    owned.release()


@pytest.mark.parametrize("bad", ["unpadded", "unpadded_multiple_of_16",
                                 "pitch", "rows", "non_contiguous",
                                 "dtype"])
def test_wrapper_refuses_maps_that_are_not_window_ready(bad):
    """soft_pcf and its plain version refuse every map but the buffer of
    quantize_map: an unpadded (C, S, S) map (also where S + 8 rounds to
    S, which a pitch of S + 8 rounded up would take for a buffer of S -
    8), a pitch off window_pitch, other rows, a view, another dtype."""
    S = 64 if bad != "unpadded_multiple_of_16" else 128
    good = pcf.quantize_map(torch.rand((C, S, S)))
    maps = {
        "unpadded": lambda: good[:, :S, :S].contiguous(),
        "unpadded_multiple_of_16": lambda: good[:, :S, :S].contiguous(),
        "pitch": lambda: torch.zeros((C, S + 8, S + 8), dtype=torch.int16),
        "rows": lambda: torch.zeros((C, S + 16, pcf.window_pitch(S)),
                                    dtype=torch.int16),
        "non_contiguous": lambda: good.transpose(0, 1).contiguous()
        .transpose(0, 1),
        "dtype": lambda: good.to(torch.int32),
    }
    qmap = maps[bad]()
    params = pcf.receiver_params(torch.rand((10, 4)) + 0.5,
                                 torch.zeros(10, dtype=torch.long), S)
    for fn in (pcf.soft_pcf, pcf.soft_pcf_plain):
        with pytest.raises(ValueError, match="window-ready"):
            fn(qmap, params, 2.5)
    assert pcf.soft_pcf(good, params, 2.5).shape == (10,)


def test_quantize_map_refuses_maps_off_the_block_grid():
    with pytest.raises(ValueError, match="multiple of 8"):
        pcf.quantize_map(torch.zeros((C, 60, 60)))
    with pytest.raises(ValueError, match="square"):
        pcf.quantize_map(torch.zeros((C, 64, 72)))


def test_window_pitch_rule():
    """The least multiple of 16 texels above S + 8, for every S a
    multiple of 8 up to 16,384: 32-byte rows, at most 16 texels of tail."""
    for S in range(8, 16385, 8):
        P = pcf.window_pitch(S)
        assert P % pcf.PITCH_TEXELS == 0 and S + 8 < P <= S + 8 + 16
    assert pcf.window_pitch(520) == 544 and pcf.window_pitch(2048) == 2064
