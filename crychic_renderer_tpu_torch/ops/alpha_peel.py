"""The alpha-tested layer's depth-peel kernel K8 (``csrc/alpha_peel.cu``):
its wrapper and the per-triangle table it reads. Its launches count in
the tally (ops/tally.py) under "alpha_peel", two a peel round.

The kernel runs the peel rounds of passes/frame.py's ``_alpha_peel``, two
launches a round (the search for each pixel's nearest fragment above its
floor, then the alpha test, which reads the neighbours' uv from the same
round), over any grid of pixels: the main view, a band of it or a
cascade's punch window. Its plain version is that PyTorch code:
``passes/frame.depth_peel`` takes it (``depth_peel_plain``) for CPU
tensors and launches the kernel through ``peel`` for CUDA tensors. The per-triangle set-up stays
torch ops (``passes/frame._peel_setup``), packed here into one table; the
pool layout comes from the pool's row width.
"""
from __future__ import annotations

import ctypes

import torch

from . import sampling
from .build import KernelLibrary

# a table row: the 16 coefficient floats the search stages in shared
# memory (A 3, B 3, C 3, zA, zB, zC, top-left 3, valid), then the peel's
# 16-float record (xy 6, 1/w 3, uv 6, material)
COEFS = 16
TABLE_FLOATS = 32

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("alpha_peel.cu", "crychic_alpha_peel", {
    "crychic_alpha_peel": ([_vp, _ci, _vp, _ci, _ci, _vp, _vp, _ci, _ci, _ci,
                            _ci, _ci, _vp, _vp, _ci, ctypes.c_float, _vp,
                            _vp, _vp, _vp, _vp, _vp], _ci),
}, error="crychic_alpha_peel_error")


def peel_table(setup, valid) -> torch.Tensor:
    """The (T, TABLE_FLOATS) f32 table K8 reads, from the peel's set-up
    (passes/frame._peel_setup: the edge coefficients A, B, C (T, 3), the
    top-left flags (T, 3) bool, the depth plane zA, zB, zC (T,) and the
    (T, 16) record) and the valid flags (T,) bool."""
    A, B, C, top_left, zA, zB, zC, rec = setup
    f32 = torch.float32
    return torch.cat([A, B, C, torch.stack([zA, zB, zC], dim=-1),
                      top_left.to(f32), valid.to(f32)[:, None], rec],
                     dim=-1).contiguous()


def _origin(o, name: str, dev):
    """(host int, device pointer or None) of a grid origin given as an
    int or a 0-d int64 tensor on the device."""
    if isinstance(o, torch.Tensor):
        if (o.dtype != torch.int64 or o.device != dev or o.dim() != 0):
            raise ValueError(f"{name} must be an int or a 0-d int64 tensor "
                             f"on {dev}; got {tuple(o.shape)} {o.dtype} on "
                             f"{o.device}")
        return 0, o.data_ptr()
    return int(o), None


def peel(table: torch.Tensor, rows: int, cols: int, oy, ox,
         pool_data: torch.Tensor, n_big: int, mat_albedo: torch.Tensor,
         mat_pair: torch.Tensor, n_peels: int, clip_thr: float,
         counted: bool = False):
    """Launch K8 on the rows x cols grid whose first pixel is (oy, ox)
    (ints, or 0-d int64 tensors on the device: no host read). Returns (z
    (rows, cols) f32, +inf where no fragment passes; id (rows, cols)
    int32, -1 there; with counted, the (n_peels,) int64 count per peel
    of the pixels it found a fragment in that stay unresolved, else
    None).

    table: peel_table's (T, 32) f32, T >= 1; pool_data: (rows, 8 | 16)
    int32; mat_albedo (M, 4) f32, mat_pair (M,) int32. Raises ValueError
    for anything else, CPU tensors included (the CPU takes the plain
    version), and RuntimeError for a refused launch."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("K8 runs on CUDA tensors; the CPU takes "
                         "passes/frame._alpha_peel")
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or table.dim() != 2 or table.shape[1] != TABLE_FLOATS
            or table.shape[0] < 1 or table.data_ptr() % 16):
        raise ValueError(f"table must be a contiguous, 16-byte aligned (T >="
                         f" 1, {TABLE_FLOATS}) float32 tensor; got "
                         f"{tuple(table.shape)} {table.dtype}")
    if rows < 2 or cols < 2:
        raise ValueError(f"the grid must be at least 2x2 (the uv "
                         f"derivatives' differences); got {rows}x{cols}")
    if n_peels < 1:
        raise ValueError(f"n_peels must be at least 1; got {n_peels}")
    lanes = pool_data.shape[-1]
    if (pool_data.dtype != torch.int32 or pool_data.device != dev
            or pool_data.dim() != 2 or not pool_data.is_contiguous()
            or lanes not in (sampling.PAIR_ROW, sampling.PAIR_ROW_DUAL)
            or pool_data.data_ptr() % 16):
        raise ValueError(f"pool_data must be a contiguous, 16-byte aligned "
                         f"(rows, 8 | 16) int32 tensor on {dev}; got "
                         f"{tuple(pool_data.shape)} {pool_data.dtype}")
    n_mat = mat_albedo.shape[0]
    for name, t, dtype, shape in (
            ("mat_albedo", mat_albedo, torch.float32, (n_mat, 4)),
            ("mat_pair", mat_pair, torch.int32, (n_mat,))):
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"{shape} on {dev}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    oy0, oy_ptr = _origin(oy, "oy", dev)
    ox0, ox_ptr = _origin(ox, "ox", dev)
    res_z = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    res_id = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    zfloor = torch.empty_like(res_z)
    found = torch.empty((rows, cols, 4), dtype=torch.float32, device=dev)
    counts = (torch.empty((n_peels,), dtype=torch.int64, device=dev)
              if counted else None)
    LIBRARY.launch(
        "crychic_alpha_peel", dev, table.data_ptr(), table.shape[0],
        pool_data.data_ptr(), lanes, int(n_big), mat_albedo.data_ptr(),
        mat_pair.data_ptr(), n_mat, rows, cols, oy0, ox0, oy_ptr, ox_ptr,
        n_peels, float(clip_thr), res_z.data_ptr(), res_id.data_ptr(),
        zfloor.data_ptr(), found.data_ptr(),
        None if counts is None else counts.data_ptr(), key="alpha_peel",
        n=2 * n_peels)
    return res_z, res_id, counts
