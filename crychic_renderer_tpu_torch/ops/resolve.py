"""The G-buffer resolve kernel K7 (``csrc/resolve.cu``): its wrapper and
the record table it reads. Its launches count in the tally
(ops/tally.py) under "resolve".

The kernel computes passes/frame.py's per-pixel resolve (``_resolve_core``
over the shade tiles ``_resolve_compacted`` keeps, or over every pixel) in
one launch and writes the (rows, W, 16) G-buffer in its final layout. Its
plain version is that PyTorch code (``passes/frame.resolve_gbuffer_plain``):
``passes/frame.resolve_gbuffer`` takes it for CPU tensors and launches the
kernel through ``resolve`` for CUDA tensors. The sampler mode comes from
the config's anisotropy and probe count (``sampler_mode``), the pool
layout from the pool's row width.
"""
from __future__ import annotations

import ctypes

import torch

from . import sampling
from .build import KernelLibrary

# _build_resolve_records' 43 floats and one zero pad: 11 float4 loads
RECORD_FLOATS = 44
# the G-buffer's channels: pos_w 3, normal_w 3, normal_v 3, albedo 4,
# roughness, metalness, shininess_alpha
CHANNELS = 16
# the shade tiles of passes/frame.py's compaction (SHADE_TILE_H, _W)
TILE_H = 8
TILE_W = 128
# the kernel's sampler modes (csrc/resolve.cu)
TRILINEAR, ANISO, ANISO_REF = 0, 1, 2

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("resolve.cu", "crychic_resolve", {
    "crychic_resolve": ([_vp, _vp, _ci, _vp, _vp, _ci, _ci, _vp, _vp, _vp,
                         _vp, _ci, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _ci,
                         _ci, _vp, _vp], _ci),
}, error="crychic_resolve_error")


def sampler_mode(anisotropy: int, aniso_probes: int) -> int:
    """The kernel's sampler for _resolve_core's branch: trilinear at
    anisotropy 1, the probe schedule of aniso_probes probes above it, the
    reference-quality probes with aniso_probes 0."""
    if anisotropy > 1:
        return ANISO_REF if aniso_probes == 0 else ANISO
    return TRILINEAR


def _check(name: str, t: torch.Tensor, dtype, device, dim: int = None):
    if (t.dtype != dtype or t.device != device or not t.is_contiguous()
            or (dim is not None and t.dim() != dim)):
        dims = "" if dim is None else f" with {dim} dims"
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}{dims}; got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def resolve(rec: torch.Tensor, tid: torch.Tensor, rows: int,
            row_offset: int, inv, capacity: int, pool_data: torch.Tensor,
            n_big: int, mat_albedo: torch.Tensor, mat_roughness: torch.Tensor,
            mat_metalness: torch.Tensor, mat_pair: torch.Tensor,
            view: torch.Tensor, anisotropy: int,
            aniso_probes: int) -> torch.Tensor:
    """Launch K7: the (rows, W, 16) G-buffer of tid's first rows.

    rec: (T, RECORD_FLOATS) f32 records; tid: (H, W) int32; inv: None (the
    dense resolve) or _compact's (NT,) int64 tile -> slot table over tid's
    shade tiles, capacity its slot count (a tile whose slot is capacity
    takes the clear values); pool_data: (rows, 8 | 16) int32; the material
    tables (M, 4), (M,), (M,) f32 and (M,) int32; view: the (4, 4) f32
    view matrix. Raises ValueError for anything else, CPU tensors
    included (the CPU takes the plain version), and RuntimeError for a
    refused launch."""
    dev = tid.device
    if dev.type != "cuda":
        raise ValueError("K7 runs on CUDA tensors; the CPU takes "
                         "passes/frame.resolve_gbuffer_plain")
    _check("tid", tid, torch.int32, dev, 2)
    H, W = tid.shape
    if not 0 < rows <= H:
        raise ValueError(f"rows {rows} outside (0, {H}]")
    _check("rec", rec, torch.float32, dev, 2)
    if rec.shape[1] != RECORD_FLOATS or rec.data_ptr() % 16:
        raise ValueError(f"rec must be a 16-byte aligned (T, {RECORD_FLOATS})"
                         f" table; got {tuple(rec.shape)}")
    _check("pool_data", pool_data, torch.int32, dev, 2)
    lanes = pool_data.shape[1]
    if (lanes not in (sampling.PAIR_ROW, sampling.PAIR_ROW_DUAL)
            or pool_data.data_ptr() % 16):
        raise ValueError(f"pool_data must be 16-byte aligned (rows, 8 | 16)"
                         f"; got {tuple(pool_data.shape)}")
    n_mat = mat_albedo.shape[0]
    for name, t, dtype, shape in (
            ("mat_albedo", mat_albedo, torch.float32, (n_mat, 4)),
            ("mat_roughness", mat_roughness, torch.float32, (n_mat,)),
            ("mat_metalness", mat_metalness, torch.float32, (n_mat,)),
            ("mat_pair", mat_pair, torch.int32, (n_mat,))):
        _check(name, t, dtype, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    if (view.dtype != torch.float32 or view.device != dev
            or tuple(view.shape) != (4, 4)):
        raise ValueError("view must be a (4, 4) float32 tensor on the frame's"
                         " device")
    if inv is None:
        inv_ptr, capacity = None, 0
    else:
        _check("inv", inv, torch.int64, dev, 1)
        tiles = -(-H // TILE_H) * -(-W // TILE_W)
        if inv.shape[0] != tiles:
            raise ValueError(f"inv must hold the {tiles} shade tiles of a "
                             f"{H}x{W} frame; got {inv.shape[0]}")
        inv_ptr = inv.data_ptr()
    mode = sampler_mode(anisotropy, aniso_probes)
    out = torch.empty((rows, W, CHANNELS), dtype=torch.float32, device=dev)
    LIBRARY.launch(
        "crychic_resolve", dev, tid.data_ptr(), inv_ptr, int(capacity),
        rec.data_ptr(), pool_data.data_ptr(), lanes, int(n_big),
        mat_albedo.data_ptr(), mat_roughness.data_ptr(),
        mat_metalness.data_ptr(), mat_pair.data_ptr(), n_mat,
        view.data_ptr(), view.stride(0), view.stride(1), W, rows,
        int(row_offset), mode, int(anisotropy), int(aniso_probes),
        out.data_ptr(), key="resolve")
    return out
