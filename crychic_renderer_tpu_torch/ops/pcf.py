"""The soft-disk shadow PCF: the 16-tap rotated-Poisson filter with a
2.5-texel disk (``RenderConfig.pcf_radius_texels``), its CUDA kernel and
its plain PyTorch version.

The JAX package evaluates this function as ``poisson_pcf_windowed``'s soft
branch (``crychic_renderer_tpu/ops/shadows.py:319``) and as the Pallas
probe kernel K6 (``experiments/pcf_probe.py:46``), both over per-receiver
16x16 "superwindow" gather tables (``superwindow_maps_u16``). The port
reads one window-ready copy of the 16-bit quantized maps instead, in which
every receiver's superwindow is a 16x16 rectangle; the quantization does
change pixels and is kept.

- ``quantize_map`` makes the window-ready (C, S + 8, P) buffer of 16-bit
  depths round(clip(d, 0, 1) * 65535), held as int16 BITS (torch.uint16
  has few ops): a value above 32767 is stored as value - 65536, and
  readers mask with 0xFFFF (the kernel reads the same bits as unsigned
  short). Rows and columns S..S+7 repeat the map's last 8, which is the
  JAX package's superwindow clamp; P is ``window_pitch(S)``.
- ``receiver_params`` computes in PyTorch what the kernel takes as
  parameters, so the kernel and the plain version share every input,
  cos and sin of the rotation hash included.
- ``soft_pcf`` is the kernel's wrapper: CPU tensors take
  ``soft_pcf_plain``; CUDA tensors launch ``csrc/pcf.cu`` or raise.
- ``OwnedMaps`` / ``owned_maps``: the window-ready buffers of a compiled
  frame (app/graphs.py) and their texture objects, made before its CUDA
  graph is captured and destroyed with it. Inside the block
  ``quantize_map`` writes into the frame's own buffers and ``soft_pcf``
  launches with their objects; outside it the kernel's texture cache
  serves the eager path.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .build import KernelLibrary

# Poisson disk (Common.hlsl:173-183).
POISSON_DISK = np.array(
    [
        [-0.94201624, -0.39906216], [0.94558609, -0.76890725],
        [-0.094184101, -0.92938870], [0.34495938, 0.29387760],
        [-0.91588581, 0.45771432], [-0.81544232, -0.87912464],
        [-0.38277543, 0.27676845], [0.97484398, 0.75648379],
        [0.44323325, -0.97511554], [0.53742981, -0.47373420],
        [-0.26496911, -0.41893023], [0.79197514, 0.19090188],
        [-0.24188840, 0.99706507], [-0.81409955, 0.91437590],
        [0.19984126, 0.78641367], [0.14383161, -0.14100790],
    ],
    dtype=np.float32,
)
N_SAMPLE = 16
# Taps whose tent reaches past the 8 window rows around the receiver
# (|p| >= 1.2 of the reference's not-unit-norm disk): (1, 7, 13).
OUTER_TAPS = tuple(i for i in range(N_SAMPLE)
                   if float(np.hypot(*POISSON_DISK[i])) >= 1.2)
# The window bounds hold for a disk of at most this radius.
MAX_RADIUS_TEXELS = 2.5
# f32 operations per (receiver, cascade) that the function needs: 28 per
# tap (offsets 8, positions 2, floors 2, the bilinear weights frac and
# 1 - frac in x and y 4, and per texel of 4 a product, a compare and an
# add) + 12 for the window set-up.
OPS_PER_RECEIVER = N_SAMPLE * 28 + 12
PARAMS = 6  # cx, cy, dq, cos, sin, cascade
# The window-ready buffer: WINDOW_PAD rows and columns past the map repeat
# its last 8-texel block; rows are padded to a multiple of PITCH_TEXELS
# (32 bytes, the H100's texture pitch alignment; the kernel checks it
# against the card's at launch).
WINDOW_PAD = 8
PITCH_TEXELS = 16

# The OwnedMaps of the compiled frame being run or captured (owned_maps).
_OWNED = None


def nrand(uv: torch.Tensor) -> torch.Tensor:
    """Common.hlsl:167-171 hash (the float2 collapses to one scalar)."""
    s = torch.sin(uv[..., 0] * (12.9898 * 2.0) + uv[..., 1] * (78.233 * 2.0))
    v = s * 43758.5453
    return torch.abs(v - torch.floor(v))


def _quantize(depth: torch.Tensor) -> torch.Tensor:
    """f32 depth -> int32 holding the int16 bits of quantize_bits."""
    q = torch.round(torch.clamp(depth, 0.0, 1.0) * 65535.0).to(torch.int32)
    return torch.where(q > 32767, q - 65536, q)


def quantize_bits(depth: torch.Tensor) -> torch.Tensor:
    """f32 depth -> int16 bits of the 16-bit UNORM depth
    round(clip(d, 0, 1) * 65535), elementwise."""
    return _quantize(depth).to(torch.int16)


def window_pitch(size: int) -> int:
    """P, the row pitch in texels of an S = size map's window-ready
    buffer: the least multiple of PITCH_TEXELS above S + WINDOW_PAD. Rows
    are then always longer than the buffer's S + 8 rows per cascade, so
    an unpadded (C, S, S) map never passes for a buffer."""
    return ((size + WINDOW_PAD) // PITCH_TEXELS + 1) * PITCH_TEXELS


def window_shape(num_cascades: int, size: int) -> tuple:
    """(C, S + 8, P): the shape of an S = size map's window-ready buffer.
    It holds (S + 8) * P / S^2 - 1 more bytes than the map: 1.2% at S =
    2048, 6.2% at S = 520."""
    return (num_cascades, size + WINDOW_PAD, window_pitch(size))


def map_size(qmap: torch.Tensor) -> int:
    """S of a window-ready buffer; raises on any other tensor (an
    unpadded (C, S, S) map, a pitch off window_pitch, another dtype or a
    non-contiguous view), which the kernel would misread."""
    size = qmap.shape[1] - WINDOW_PAD if qmap.dim() == 3 else -1
    if (qmap.dtype != torch.int16 or size < 8 or size % 8
            or tuple(qmap.shape) != window_shape(qmap.shape[0], size)
            or not qmap.is_contiguous()):
        raise ValueError(
            "the map must be a contiguous window-ready (C, S + 8, "
            "window_pitch(S)) int16 buffer of quantize_map, S a multiple "
            f"of 8; got {tuple(qmap.shape)} {qmap.dtype}")
    return size


def _new_window_buffer(num_cascades: int, size: int,
                      device) -> torch.Tensor:
    """An unfilled window-ready buffer, its columns past S + 8 zero."""
    buf = torch.empty(window_shape(num_cascades, size), dtype=torch.int16,
                      device=device)
    buf[..., size + WINDOW_PAD:].zero_()
    return buf


def _write_windows(buf: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The (C, S, S) int16 bits q (int32 or int16) into the window-ready
    buffer `buf`: the map, then its last 8 columns, rows, and the corner
    block again past it (superwindow_from_packed's min(q + 1, S/8 - 1)).
    Returns buf."""
    S = q.shape[1]
    lo, hi = S - WINDOW_PAD, S + WINDOW_PAD
    buf[:, :S, :S].copy_(q)
    buf[:, :S, S:hi].copy_(q[:, :, lo:])
    buf[:, S:hi, :S].copy_(q[:, lo:])
    buf[:, S:hi, S:hi].copy_(q[:, lo:, lo:])
    return buf


def quantize_map(shadow_maps: torch.Tensor) -> torch.Tensor:
    """(C, S, S) f32 depth -> the window-ready (C, S + 8, window_pitch(S))
    int16 buffer of its 16-bit UNORM depths (quantize_bits). Maps that
    are int16 bits already (the band frame's u16-packed atlas,
    parallel/sharded.py) go into the same buffer as they are. Inside
    owned_maps the buffer is the compiled frame's own (OwnedMaps.take)."""
    C, S, S2 = shadow_maps.shape
    if S != S2 or S % 8:
        raise ValueError(f"shadow maps {tuple(shadow_maps.shape)}: square, "
                         "with S a multiple of 8")
    q = (shadow_maps if shadow_maps.dtype == torch.int16
         else _quantize(shadow_maps))
    if _OWNED is not None:
        return _OWNED.take(q)
    return _write_windows(_new_window_buffer(C, S, q.device), q)


def receiver_params(shadow_pos: torch.Tensor, cascade: torch.Tensor,
                    smap_size: int) -> torch.Tensor:
    """(M, 4) homogeneous shadow-space positions and (M,) cascade indices
    -> (6, M) f32 kernel parameters [cx, cy, dq, cos, sin, cascade]:
    cx = u*S - 0.5, cy = v*S - 0.5, dq = z*65535 - 0.5 (the receiver in
    16-bit steps), and the rotation hash's cos and sin."""
    S = smap_size
    inv_w = 1.0 / torch.clamp(shadow_pos[..., 3], min=1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    theta = nrand(uvz[..., :2])
    return torch.stack([uvz[..., 0] * S - 0.5, uvz[..., 1] * S - 0.5,
                        uvz[..., 2] * 65535.0 - 0.5, torch.cos(theta),
                        torch.sin(theta), cascade.to(torch.float32)])


def _floor_sat(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, saturated at +-2^30 as the kernel saturates (an
    out-of-range float -> int cast is undefined), NaN to -2^30 as the
    kernel's fmaxf takes it."""
    lim = 2.0 ** 30
    return torch.clamp(torch.floor(x).nan_to_num(nan=-lim), -lim, lim).long()


def _tent(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(w - t), min=0.0)


def soft_pcf_plain(qmap: torch.Tensor, params: torch.Tensor,
                   radius_texels: float) -> torch.Tensor:
    """What the kernel computes, in plain tensor ops: (M,) lit factors
    against the window-ready buffer qmap. Tap by tap and texel by texel in
    the kernel's order (see csrc/pcf.cu for the window and the taps), with
    one gather of M texels per (tap, texel) at the kernel's address:
    window texel (wy, wx) is buffer texel (8*qy0 + wy, 8*qx0 + wx)."""
    S = map_size(qmap)
    C, rows, P = qmap.shape
    nb = S // 8
    cx, cy, dq, c, s, casc = params
    table = (qmap.reshape(-1).to(torch.int32) & 0xFFFF).to(torch.float32)
    x_lo = _floor_sat(cx) - 3
    y_lo = _floor_sat(cy) - 3
    qx0 = torch.clamp(x_lo >> 3, 0, nb - 1)
    qy0 = torch.clamp(y_lo >> 3, 0, nb - 1)
    oy = torch.clamp(y_lo - 8 * qy0, 0, 7)
    # buffer texel of window texel (0, 0)
    corner = (torch.clamp(casc.long(), 0, C - 1) * rows + 8 * qy0) * P \
        + 8 * qx0
    fx = cx - (8 * qx0).to(torch.float32)
    fy = cy - (8 * qy0).to(torch.float32)
    fy_rel = fy - oy.to(torch.float32)
    zero = torch.zeros_like(cx)
    acc = zero
    for t in range(N_SAMPLE):
        outer = t in OUTER_TAPS
        px, py = (float(v) for v in POISSON_DISK[t])
        dx = (px * c - py * s) * radius_texels
        dy = (px * s + py * c) * radius_texels
        tx = fx + dx
        ty = (fy if outer else fy_rel) + dy
        nrows = 16.0 if outer else 8.0
        row0 = 0 if outer else oy
        x0 = torch.floor(tx)
        y0 = torch.floor(ty)
        for ky in (0.0, 1.0):
            wyf = y0 + ky
            in_y = (wyf >= 0.0) & (wyf < nrows)
            wy = _tent(wyf, ty)
            # window row (a tap outside the window reads row 0 for nothing)
            wr = torch.where(in_y, wyf, zero).long() + row0
            for kx in (0.0, 1.0):
                wxf = x0 + kx
                inside = in_y & (wxf >= 0.0) & (wxf < 16.0)
                wc = torch.where(inside, wxf, zero).long()
                texel = table[corner + wr * P + wc]
                w = wy * _tent(wxf, tx)
                acc = acc + torch.where(inside & (dq <= texel), w, zero)
    return acc * (1.0 / N_SAMPLE)


_vp, _ci = ctypes.c_void_p, ctypes.c_int
_u64 = ctypes.c_ulonglong
LIBRARY = KernelLibrary("pcf.cu", "crychic_pcf", {
    "crychic_soft_pcf": ([_vp, _vp, _ci, _ci, _ci, _ci, ctypes.c_float, _vp,
                          _vp], _ci),
    "crychic_soft_pcf_cache_fills": ([], _ci),
    "crychic_soft_pcf_limits": ([ctypes.POINTER(_ci)], _ci),
    "crychic_soft_pcf_texture": ([_vp, _ci, _ci, _ci, ctypes.POINTER(_u64),
                                  ctypes.POINTER(_ci)], _ci),
    "crychic_soft_pcf_texture_destroy": ([_u64], _ci),
    "crychic_soft_pcf_owned": ([_u64, _ci, _vp, _vp, _ci, _ci, _ci, _ci,
                                ctypes.c_float, _vp, _vp], _ci),
}, error="crychic_soft_pcf_error")


def texture_limits(device) -> dict:
    """The CUDA device's texture alignments (bytes) and its limits for a
    pitch-linear 2D texture (width and height in texels, pitch in bytes),
    as the kernel reads them. A buffer with C * (S + 8) rows above
    max_height (or S + 8 above max_width, 2 * P above max_pitch) takes
    the kernel's scalar path."""
    out = (_ci * 5)()
    with torch.cuda.device(device):
        LIBRARY.call("crychic_soft_pcf_limits", out)
    return dict(zip(("pitch_align", "base_align", "max_width", "max_height",
                     "max_pitch"), out))


def make_texture(qmap: torch.Tensor):
    """A texture object over the CUDA window-ready buffer qmap that the
    caller owns and destroys (destroy_texture): (handle, has_tex); has_tex
    0 (handle 0) past the card's texture limits. Raises where the buffer's
    pitch or address is off the card's texture alignment, or CUDA
    refuses."""
    S = map_size(qmap)
    tex, has_tex = _u64(0), _ci(0)
    with torch.cuda.device(qmap.device):
        LIBRARY.call("crychic_soft_pcf_texture", qmap.data_ptr(),
                     qmap.shape[0], S, qmap.shape[2], ctypes.byref(tex),
                     ctypes.byref(has_tex))
    return tex.value, has_tex.value


def destroy_texture(tex: int):
    LIBRARY.call("crychic_soft_pcf_texture_destroy", tex)


class OwnedMaps:
    """The window-ready buffers of one compiled frame and their texture
    objects. The k-th quantize_map of a frame run inside owned_maps(self)
    writes into buffer k, made (with its texture object, on the card) the
    first time, which must be the eager frame that precedes the capture:
    a CUDA graph captured afterwards reads the same buffers through the
    same objects on every replay. The eager path's texture cache never
    holds them, so its reset cannot destroy an object a graph reads, and
    no object is made during a capture. release() destroys them; the
    caller first ends every graph that reads them."""

    def __init__(self):
        self._maps = []  # [(buffer, texture handle, has_tex)]
        self._next = 0

    def take(self, q: torch.Tensor) -> torch.Tensor:
        """The (C, S, S) int16 bits q (int32 or int16) written into the
        frame's next window-ready buffer (_write_windows)."""
        k = self._next
        self._next += 1
        C, S, _ = q.shape
        if k == len(self._maps):
            if q.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a compiled frame met a shadow map during its capture "
                    "that its eager frame did not make")
            buf = _new_window_buffer(C, S, q.device)
            tex, has_tex = make_texture(buf) if q.is_cuda else (0, 0)
            self._maps.append((buf, tex, has_tex))
        buf = self._maps[k][0]
        if buf.shape != window_shape(C, S) or buf.device != q.device:
            raise RuntimeError(f"the frame's shadow map {k} changed shape: "
                               f"{tuple(q.shape)} vs {tuple(buf.shape)}")
        return _write_windows(buf, q)

    def texture(self, qmap: torch.Tensor):
        """(handle, has_tex) of an owned buffer, or None."""
        for buf, tex, has_tex in self._maps:
            if buf.data_ptr() == qmap.data_ptr() and buf.shape == qmap.shape:
                return tex, has_tex
        return None

    def held(self) -> bool:
        return bool(self._maps)

    def release(self):
        for _, tex, has_tex in self._maps:
            if has_tex:
                destroy_texture(tex)
        self._maps = []


@contextlib.contextmanager
def owned_maps(maps: OwnedMaps):
    """Inside the block, the frame's quantize_map and soft_pcf use the
    maps and texture objects of `maps` (one frame per block)."""
    global _OWNED
    saved, _OWNED = _OWNED, maps
    maps._next = 0
    try:
        yield maps
    finally:
        _OWNED = saved


def soft_pcf(qmap: torch.Tensor, params: torch.Tensor,
             radius_texels: float) -> torch.Tensor:
    """The kernel's wrapper: (M,) f32 lit factors of the (6, M)
    receiver-cascade parameters against the window-ready buffer of
    quantize_map (map_size raises on any other map). CPU tensors take
    soft_pcf_plain; CUDA tensors launch the kernel of csrc/pcf.cu on the
    current stream, or raise. The kernel reads the buffer through one
    texture object, every receiver with one gather per tap; the buffer's
    2*P-byte pitch and its address must meet the card's texture
    alignment, or the launch raises. Only a buffer past the card's
    pitch-linear texture limits (texture_limits) takes the kernel's
    scalar path, with the same result: on the H100, C * (S + 8) > 65,000
    rows, which four cascades reach from S = 16,248. Inside owned_maps
    the map must be one of the compiled frame's buffers, read through its
    own texture object; outside it, a CUDA graph capture raises (an
    object of the cache cannot outlive the cache's reset)."""
    if not 0.0 <= radius_texels <= MAX_RADIUS_TEXELS:
        raise ValueError(f"radius {radius_texels} texels: the window bounds "
                         f"hold up to {MAX_RADIUS_TEXELS}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"soft_pcf: unsupported device {params.device}")
    size = map_size(qmap)
    if qmap.device != params.device:
        raise ValueError(f"the map is on {qmap.device}, the receivers on "
                         f"{params.device}")
    if params.device.type == "cpu":
        return soft_pcf_plain(qmap, params, radius_texels)
    if (params.dtype != torch.float32 or params.dim() != 2
            or params.shape[0] != PARAMS or not params.is_contiguous()):
        raise ValueError(f"params must be a contiguous ({PARAMS}, M) float32 "
                         "tensor")
    m = params.shape[1]
    out = torch.empty((m,), dtype=torch.float32, device=params.device)
    if m == 0:
        return out
    owned = None if _OWNED is None else _OWNED.texture(qmap)
    if owned is None and (_OWNED is not None
                          or torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("soft_pcf in a compiled frame reads only the "
                           "maps the frame owns (quantize_map inside "
                           "owned_maps); the texture cache cannot be "
                           "captured")
    LIBRARY.launch(
        "crychic_soft_pcf" if owned is None else "crychic_soft_pcf_owned",
        params.device, *(owned or ()), qmap.data_ptr(), params.data_ptr(), m,
        qmap.shape[0], size, qmap.shape[2], float(radius_texels),
        out.data_ptr(), key="pcf")
    return out


def cache_fills() -> int:
    """How often the kernel's texture-object cache (64 maps) was full
    since its library was loaded in this process. Each fill synchronizes
    the device, out of sight of torch.cuda.set_sync_debug_mode, so a
    queued frame loop must keep this at 0. Builds the library if needed."""
    return LIBRARY.load().crychic_soft_pcf_cache_fills()
