"""The soft-disk shadow PCF: the 16-tap rotated-Poisson filter with a
2.5-texel disk (``RenderConfig.pcf_radius_texels``), its CUDA kernel and
its plain PyTorch version.

The JAX package evaluates this function as ``poisson_pcf_windowed``'s soft
branch (``crychic_renderer_tpu/ops/shadows.py:319``) and as the Pallas
probe kernel K6 (``experiments/pcf_probe.py:46``), both over per-receiver
16x16 "superwindow" gather tables. Those tables are a TPU layout that does
not change the image, so the port reads the 16-bit quantized maps
directly; the quantization does change pixels and is kept.

- ``quantize_map`` makes the (C, S, S) map of 16-bit depths
  round(clip(d, 0, 1) * 65535), held as int16 BITS (torch.uint16 has few
  ops): a value above 32767 is stored as value - 65536, and readers mask
  with 0xFFFF (the kernel reads the same bits as unsigned short).
- ``receiver_params`` computes in PyTorch what the kernel takes as
  parameters, so the kernel and the plain version share every input,
  cos and sin of the rotation hash included.
- ``soft_pcf`` is the kernel's wrapper: CPU tensors take
  ``soft_pcf_plain``; CUDA tensors launch ``csrc/pcf.cu`` or raise.
- ``OwnedMaps`` / ``owned_maps``: the quantized maps of a compiled frame
  (app/graphs.py) and their texture objects, made before its CUDA graph
  is captured and destroyed with it. Inside the block ``quantize_map``
  writes into the frame's own buffers and ``soft_pcf`` launches with
  their objects; outside it the kernel's texture cache serves the eager
  path.
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

# Launches of the CUDA kernel since import (or since a caller reset it).
# Incremented by soft_pcf where it launches, and by add_launches for each
# replay of a CUDA graph that holds its launches (app/graphs.py).
LAUNCHES = 0
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


def quantize_map(shadow_maps: torch.Tensor) -> torch.Tensor:
    """(C, S, S) f32 depth -> (C, S, S) int16 bits of the 16-bit UNORM
    depth (quantize_bits). Maps that are int16 bits already (the band
    frame's u16-packed atlas, parallel/sharded.py) are taken as they are.
    Inside owned_maps the bits are written into the compiled frame's own
    buffer (OwnedMaps.take)."""
    q = (shadow_maps if shadow_maps.dtype == torch.int16
         else _quantize(shadow_maps))
    if _OWNED is not None:
        return _OWNED.take(q)
    return q.to(torch.int16).contiguous()


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
    out-of-range float -> int cast is undefined)."""
    return torch.clamp(torch.floor(x), -2.0 ** 30, 2.0 ** 30).long()


def _tent(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(w - t), min=0.0)


def soft_pcf_plain(qmap: torch.Tensor, params: torch.Tensor,
                   radius_texels: float) -> torch.Tensor:
    """What the kernel computes, in plain tensor ops: (M,) lit factors.
    Tap by tap and texel by texel in the kernel's order (see
    csrc/pcf.cu for the window and the taps), with one gather of M texels
    per (tap, texel)."""
    C, S, _ = qmap.shape
    nb = S // 8
    cx, cy, dq, c, s, casc = params
    table = (qmap.reshape(-1).to(torch.int32) & 0xFFFF).to(torch.float32)
    base = torch.clamp(casc.long(), 0, C - 1) * (S * S)
    x_lo = _floor_sat(cx) - 3
    y_lo = _floor_sat(cy) - 3
    qx0 = torch.clamp(x_lo >> 3, 0, nb - 1)
    qy0 = torch.clamp(y_lo >> 3, 0, nb - 1)
    oy = torch.clamp(y_lo - 8 * qy0, 0, 7)
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
        rows = 16.0 if outer else 8.0
        row0 = 0 if outer else oy
        x0 = torch.floor(tx)
        y0 = torch.floor(ty)
        for ky in (0.0, 1.0):
            wyf = y0 + ky
            in_y = (wyf >= 0.0) & (wyf < rows)
            wy = _tent(wyf, ty)
            # window row (a tap outside the window reads row 0 for nothing)
            wr = torch.where(in_y, wyf, zero).long() + row0
            mrow = torch.clamp(qy0 + (wr >> 3), max=nb - 1) * 8 + (wr & 7)
            for kx in (0.0, 1.0):
                wxf = x0 + kx
                inside = in_y & (wxf >= 0.0) & (wxf < 16.0)
                wc = torch.where(inside, wxf, zero).long()
                mcol = torch.clamp(qx0 + (wc >> 3), max=nb - 1) * 8 \
                    + (wc & 7)
                texel = table[base + mrow * S + mcol]
                w = wy * _tent(wxf, tx)
                acc = acc + torch.where(inside & (dq <= texel), w, zero)
    return acc * (1.0 / N_SAMPLE)


_vp, _ci = ctypes.c_void_p, ctypes.c_int
_u64 = ctypes.c_ulonglong
LIBRARY = KernelLibrary("pcf.cu", "crychic_pcf", {
    "crychic_soft_pcf": ([_vp, _vp, _ci, _ci, _ci, ctypes.c_float, _vp,
                          _vp], _ci),
    "crychic_soft_pcf_error": ([_ci], ctypes.c_char_p),
    "crychic_soft_pcf_cache_fills": ([], _ci),
    "crychic_soft_pcf_texture": ([_vp, _ci, _ci, ctypes.POINTER(_u64),
                                  ctypes.POINTER(_ci)], _ci),
    "crychic_soft_pcf_texture_destroy": ([_u64], _ci),
    "crychic_soft_pcf_owned": ([_u64, _ci, _vp, _vp, _ci, _ci, _ci,
                                ctypes.c_float, _vp, _vp], _ci),
})


def _check(lib, rc: int, what: str):
    """Raise with CUDA's message where the C entry returned an error."""
    if rc != 0:
        raise RuntimeError(f"{what}: "
                           + lib.crychic_soft_pcf_error(rc).decode())


def make_texture(qmap: torch.Tensor):
    """A texture object over the CUDA map qmap that the caller owns and
    destroys (destroy_texture): (handle, has_tex); has_tex 0 (handle 0)
    where the card cannot texture the map. Raises where CUDA refuses."""
    lib = LIBRARY.load()
    tex, has_tex = _u64(0), _ci(0)
    with torch.cuda.device(qmap.device):
        rc = lib.crychic_soft_pcf_texture(qmap.data_ptr(), qmap.shape[0],
                                          qmap.shape[1], ctypes.byref(tex),
                                          ctypes.byref(has_tex))
    _check(lib, rc, "soft PCF texture object")
    return tex.value, has_tex.value


def destroy_texture(tex: int):
    lib = LIBRARY.load()
    _check(lib, lib.crychic_soft_pcf_texture_destroy(tex),
           "soft PCF texture object")


class OwnedMaps:
    """The quantized maps of one compiled frame and their texture
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
        """The int16 bits q (int32 or int16) in the frame's next buffer."""
        k = self._next
        self._next += 1
        if k == len(self._maps):
            if q.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a compiled frame met a shadow map during its capture "
                    "that its eager frame did not make")
            buf = torch.empty(q.shape, dtype=torch.int16, device=q.device)
            tex, has_tex = make_texture(buf) if q.is_cuda else (0, 0)
            self._maps.append((buf, tex, has_tex))
        buf = self._maps[k][0]
        if buf.shape != q.shape or buf.device != q.device:
            raise RuntimeError(f"the frame's shadow map {k} changed shape: "
                               f"{tuple(q.shape)} vs {tuple(buf.shape)}")
        return buf.copy_(q)

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
    receiver-cascade parameters against the (C, S, S) int16-bit map. CPU
    tensors take soft_pcf_plain; CUDA tensors launch the kernel of
    csrc/pcf.cu on the current stream, or raise. The kernel reads the map
    through a texture object where the map's address and its 2*S-byte
    rows meet the card's texture alignment (S a multiple of 16 on the
    H100); a map that does not (S = 520, say) launches without one, and
    every receiver takes the kernel's scalar path, with the same result.
    Inside owned_maps the map must be one of the compiled frame's buffers,
    read through its own texture object; outside it, a CUDA graph capture
    raises (an object of the cache cannot outlive the cache's reset)."""
    if not 0.0 <= radius_texels <= MAX_RADIUS_TEXELS:
        raise ValueError(f"radius {radius_texels} texels: the window bounds "
                         f"hold up to {MAX_RADIUS_TEXELS}")
    if params.device.type == "cpu":
        return soft_pcf_plain(qmap, params, radius_texels)
    if params.device.type != "cuda":
        raise ValueError(f"soft_pcf: unsupported device {params.device}")
    global LAUNCHES
    if (qmap.dtype != torch.int16 or qmap.dim() != 3
            or qmap.shape[1] != qmap.shape[2] or qmap.shape[1] % 8
            or not qmap.is_contiguous() or qmap.device != params.device):
        raise ValueError("the map must be a contiguous (C, S, S) int16 "
                         f"tensor with S a multiple of 8 on {params.device}")
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
    lib = LIBRARY.load()
    args = (qmap.data_ptr(), params.data_ptr(), m, qmap.shape[0],
            qmap.shape[1], float(radius_texels), out.data_ptr())
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        if owned is None:
            rc = lib.crychic_soft_pcf(*args, stream)
        else:
            rc = lib.crychic_soft_pcf_owned(*owned, *args, stream)
    _check(lib, rc, "soft PCF kernel launch failed")
    LAUNCHES += 1
    return out


def cache_fills() -> int:
    """How often the kernel's texture-object cache (64 maps) was full
    since its library was loaded in this process. Each fill synchronizes
    the device, out of sight of torch.cuda.set_sync_debug_mode, so a
    queued frame loop must keep this at 0. Builds the library if needed."""
    return LIBRARY.load().crychic_soft_pcf_cache_fills()


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def add_launches(n: int):
    """Count n launches made without the wrapper: a CUDA graph's replay
    of the launches it captured."""
    global LAUNCHES
    LAUNCHES += n
