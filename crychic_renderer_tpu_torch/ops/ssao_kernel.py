"""The SSAO kernel K9 (``csrc/ssao.cu``): its two wrappers. Their launches
count in the tally (ops/tally.py) under "ssao.occlusion" (one a frame)
and "ssao.blur" (one a blur iteration).

``occlusion`` computes ops/ssao.ssao_occlusion over the (8, 32) SSAO
tiles that passes/frame.py's compaction keeps (or over every pixel, at a
row offset for a band) in one launch and writes the (h, w) access map;
``blur`` runs one iteration of passes/frame.ssao_blur, the horizontal and
the vertical bilateral pass, in one launch. Their plain version is that
PyTorch code (``passes/frame.ssao_pass_plain`` and ``ssao_blur_plain``):
``passes/frame.ssao_pass`` and ``ssao_blur`` take it for CPU tensors and
launch these for CUDA tensors. Neither reads the host, so both run
inside the compiled frame's capture.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary

# the SSAO tiles of passes/frame.py's compaction (SSAO_TILE_H, _W)
TILE_H = 8
TILE_W = 32
TAPS = 14
# the blur's radius-5 Gaussian (ops/ssao.calc_gauss_weights(2.5))
BLUR_TAPS = 11

_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary("ssao.cu", "crychic_ssao", {
    "crychic_ssao_occlusion": ([_vp, _ci, _vp, _cl, _cl, _cl, _vp, _vp, _vp,
                                _ci, _ci, _vp, _vp, _ci, _ci, _vp, _ci, _ci,
                                _ci, _ci, _ci, _ci, _vp, _vp], _ci),
    "crychic_ssao_blur": ([_vp, _vp, _cl, _cl, _cl, _vp, _vp, _vp, _ci, _ci,
                           _ci, _ci, _vp, _vp], _ci),
}, error="crychic_ssao_error")


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device,
           contiguous: bool = True):
    if (t.dtype != dtype or t.device != device or tuple(t.shape) != shape
            or (contiguous and not t.is_contiguous())):
        kind = "a contiguous" if contiguous else "a"
        raise ValueError(f"{name} must be {kind} {shape} {dtype} tensor on "
                         f"{device}; got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def _device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError("K9 runs on CUDA tensors; the CPU takes "
                         "passes/frame.ssao_pass_plain")
    return t.device


def occlusion(normal_v: torch.Tensor, depth_ndc: torch.Tensor,
              proj: torch.Tensor, inv_proj: torch.Tensor,
              offsets: torch.Tensor, random_field: torch.Tensor,
              tap_depth: torch.Tensor, row_offset: int = 0,
              full_height: int = None, inv: torch.Tensor = None,
              capacity: int = 0) -> torch.Tensor:
    """Launch K9's occlusion: the (h, w) access map.

    normal_v: (h, w, 3) f32 view-space normals, any strides; depth_ndc:
    (h, w) f32 half-res NDC depth; proj, inv_proj: (4, 4) f32; offsets:
    (14, 3) f32; random_field: (h, w, 3) f32; tap_depth: the (H, W) f32
    full-res NDC depth the taps sample. row_offset, full_height: the
    map's rows in the screen (ops/ssao.ssao_occlusion's band arguments;
    a padded band's last rows may lie past full_height).
    inv: None (every pixel) or _compact's (NT,) int64 tile -> slot table
    over the map's (8, 32) tiles, capacity its slot count (a tile whose
    slot is capacity writes 1.0). Raises ValueError for anything else, CPU
    tensors included, and RuntimeError for a refused launch."""
    dev = _device(depth_ndc)
    if depth_ndc.dim() != 2:
        raise ValueError(f"depth_ndc must be (h, w); got "
                         f"{tuple(depth_ndc.shape)}")
    h, w = depth_ndc.shape
    f32 = torch.float32
    _check("depth_ndc", depth_ndc, (h, w), f32, dev)
    _check("normal_v", normal_v, (h, w, 3), f32, dev, contiguous=False)
    _check("random_field", random_field, (h, w, 3), f32, dev)
    _check("offsets", offsets, (TAPS, 3), f32, dev)
    if tap_depth.dim() != 2:
        raise ValueError(f"tap_depth must be (H, W); got "
                         f"{tuple(tap_depth.shape)}")
    _check("tap_depth", tap_depth, tuple(tap_depth.shape), f32, dev)
    for name, m in (("proj", proj), ("inv_proj", inv_proj)):
        _check(name, m, (4, 4), f32, dev, contiguous=False)
    full_height = h if full_height is None else int(full_height)
    if row_offset < 0 or full_height <= 0:
        raise ValueError(f"row_offset {row_offset} and full_height "
                         f"{full_height} must be >= 0 and > 0")
    if inv is None:
        inv_ptr, capacity = None, 0
    else:
        tiles = -(-h // TILE_H) * -(-w // TILE_W)
        _check("inv", inv, (tiles,), torch.int64, dev)
        inv_ptr = inv.data_ptr()
    out = torch.empty((h, w), dtype=f32, device=dev)
    LIBRARY.launch(
        "crychic_ssao_occlusion", dev, inv_ptr, int(capacity),
        normal_v.data_ptr(), *normal_v.stride(), depth_ndc.data_ptr(),
        random_field.data_ptr(), tap_depth.data_ptr(), *tap_depth.shape,
        offsets.data_ptr(), proj.data_ptr(), *proj.stride(),
        inv_proj.data_ptr(), *inv_proj.stride(), h, w, int(row_offset),
        full_height, out.data_ptr(), key="ssao.occlusion")
    return out


def blur(access: torch.Tensor, normal_v: torch.Tensor,
         depth_ndc: torch.Tensor, weights: torch.Tensor,
         proj: torch.Tensor) -> torch.Tensor:
    """Launch one K9 blur iteration (the horizontal bilateral pass, then
    the vertical one): a new (h, w) access map.

    access: (h, w) f32; normal_v: (h, w, 3) f32, any strides; depth_ndc:
    (h, w) f32 NDC depth (the kernel takes its view depth through proj);
    weights: (11,) f32; proj: (4, 4) f32. Raises like occlusion."""
    dev = _device(access)
    if access.dim() != 2:
        raise ValueError(f"access must be (h, w); got {tuple(access.shape)}")
    h, w = access.shape
    f32 = torch.float32
    _check("access", access, (h, w), f32, dev)
    _check("normal_v", normal_v, (h, w, 3), f32, dev, contiguous=False)
    _check("depth_ndc", depth_ndc, (h, w), f32, dev)
    _check("weights", weights, (BLUR_TAPS,), f32, dev)
    _check("proj", proj, (4, 4), f32, dev, contiguous=False)
    out = torch.empty_like(access)
    LIBRARY.launch(
        "crychic_ssao_blur", dev, access.data_ptr(), normal_v.data_ptr(),
        *normal_v.stride(), depth_ndc.data_ptr(), weights.data_ptr(),
        proj.data_ptr(), *proj.stride(), h, w, out.data_ptr(),
        key="ssao.blur")
    return out
