"""The least time a kernel could take on what these inputs need, against
the card's published peaks: the larger of the bytes over the memory
bandwidth and the operations over the float32 rate (NVIDIA H100 SXM data
sheet: 3.35 TB/s of HBM3, 67 TFLOP/s float32 outside the tensor cores,
at the full 700 W). The counts are of the work the inputs need, whatever
implements the kernel: each input byte read once, each output byte
written once, and a fixed count of operations per unit of work.

K2, the shadow atlas raster: the shadow triangles' light-space vertices
(3 x (x, y, z) float32 per triangle and cascade) in, the C x S^2 float32
depth atlas out; 17 operations per covered (triangle, texel) fragment:
three edge functions (a*x + b*y + c, 4 each), the depth plane (4) and the
depth test (1).

K6, the soft PCF: the float32 depth atlas read once, each receiver's
light-space position (3 float32) read once and its factor (1 float32)
written once; per receiver (a pixel not sky) 16 Poisson taps of 20
operations: the rotated offset (4), the tap's texel and fractions (4),
the two bilinear weights (2), four depth compares (4), four weighted
adds (4) and the tap's sum (2).
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
K2_OPS_PER_FRAGMENT = 17
K6_TAPS = 16
K6_OPS_PER_TAP = 20


def k2_least_s(w: dict) -> float:
    """Least seconds of the shadow atlas raster for one frame's counts
    (``reference.render.ReferenceFrame.work``)."""
    C, S = w["cascades"], w["map_size"]
    nbytes = C * w["shadow_triangles"] * 36 + C * S * S * 4
    ops = w["atlas_fragments"] * K2_OPS_PER_FRAGMENT
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def k6_least_s(w: dict) -> float:
    """Least seconds of the soft PCF for one frame's counts."""
    C, S = w["cascades"], w["map_size"]
    nbytes = C * S * S * 4 + w["receivers"] * 16
    ops = w["receivers"] * K6_TAPS * K6_OPS_PER_TAP
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)


def roofline_pct(least_s: list, kernel_s: float, launches: int):
    """100 x the mean least time per frame over the kernel's measured
    seconds per launch (one launch per frame), or None where the trace
    holds no launch of it."""
    if not launches or kernel_s <= 0.0 or not least_s:
        return None
    return 100.0 * (sum(least_s) / len(least_s)) / (kernel_s / launches)
