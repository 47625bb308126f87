// Soft-disk shadow PCF kernel for Hopper (sm_90a): the 16-tap rotated
// Poisson filter with a 2.5-texel disk, RenderConfig.pcf_radius_texels.
//
// What it replaces. The JAX package evaluates this function in XLA as
// poisson_pcf_windowed's soft branch (crychic_renderer_tpu/ops/shadows.py
// :319, tap loop :423-457) and as the Pallas kernel make_kernel(mode).kern
// (experiments/pcf_probe.py:46, launched by run_kernel :117). Both read
// 16x16-texel "superwindows", a per-receiver gather table laid out for
// the TPU; this kernel reads the 16-bit quantized shadow maps directly
// and computes each window texel's address itself, which gives the same
// texels.
//
// What it computes, per (receiver, cascade) i, from the parameters
// params[k * m + i] that ops/pcf.py receiver_params prepares in PyTorch
// (k = 0..5: cx = u*S - 0.5, cy = v*S - 0.5, dq = z*65535 - 0.5, cos and
// sin of the rotation hash, the cascade index):
//   - the window: x_lo = floor(cx) - 3, qx0 = clip(x_lo >> 3, 0, S/8 - 1)
//     (the same for y). Window texel (wy, wx), wy and wx in [0, 16), is
//     map row min(qy0 + wy/8, S/8 - 1)*8 + wy%8 and column likewise: the
//     block past the map's edge is clamped, as superwindow_from_packed
//     clamps it. fx = cx - 8*qx0, fy = cy - 8*qy0.
//   - tap t of the disk sits at (fx + (px*c - py*s)*r, fy + (px*s +
//     py*c)*r). It adds relu(1 - |wx - tx|) * relu(1 - |wy - ty|) for each
//     of the <= 4 window texels under its tent whose 16-bit depth passes
//     dq <= texel. The 13 inner taps (|p| < 1.2) count only window rows
//     oy .. oy+7, oy = clip(y_lo - 8*qy0, 0, 7), with ty taken relative to
//     row oy (fy - oy + dy), as the JAX package's 8-row extraction does;
//     the 3 outer taps (1, 7 and 13) count all 16 rows.
//   - out[i] = sum / 16.
// Each weight is evaluated with every operation rounded on its own (the
// file is built with -fmad=false) and summed tap by tap, texel by texel,
// in the order of the plain version (ops/pcf.py soft_pcf_plain), so the
// two agree to the last bit on the card.
//
// What bounds it. Per (receiver, cascade): 24 bytes of parameters in, 4
// bytes out, and the 28 f32 operations per tap that the function needs
// (two tap offsets and positions, two floors, the four bilinear weights,
// then per texel a product, a compare and an add), 460 with the window
// set-up (ops/pcf.py OPS_PER_RECEIVER). At 1080p that is 4.15M
// receiver-cascades, 116 MB of parameters and output plus the 32 MB map,
// against 1.9e9 operations: bound by memory (~45 us at 3.35 TB/s) more
// than by f32 throughput (~29 us at 67 TFLOP/s). This kernel does more
// arithmetic than that: it evaluates each texel's weight as a product of
// two tents (the column tent once per row). The design is the simple
// one: a thread per (receiver, cascade), texels through the read-only
// cache (a receiver's 64 texel reads fall in one 16x16 window, and
// neighbouring receivers share windows). Skipping dead receivers, and
// sharing the tap offsets between the two cascades of a receiver, are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_SAMPLE = 16;
// taps whose |p| >= 1.2 reach 10 window rows and use all 16
constexpr unsigned OUTER_TAPS = (1u << 1) | (1u << 7) | (1u << 13);

// The Poisson disk of Common.hlsl:173-183 as the float32 values of
// ops/pcf.py POISSON_DISK (exact hex; tests/test_torch_pcf.py holds them
// equal).
__constant__ float kDiskX[N_SAMPLE] = {
    -0x1.e24ff4p-1f, 0x1.e423dcp-1f,  -0x1.81c73p-4f,  0x1.613d08p-2f,
    -0x1.d4eefcp-1f, -0x1.a181a8p-1f, -0x1.87f648p-2f, 0x1.f31ecp-1f,
    0x1.c5defp-2f,   0x1.132ap-1f,    -0x1.0f541p-2f,  0x1.957dc4p-1f,
    -0x1.ef633p-3f,  -0x1.a0d1a8p-1f, 0x1.99466p-3f,   0x1.26913p-3f};
__constant__ float kDiskY[N_SAMPLE] = {
    -0x1.98a3cp-2f,  -0x1.89ae36p-1f, -0x1.dbd8d6p-1f, 0x1.2cee4p-2f,
    0x1.d4b31p-2f,   -0x1.c21ca0p-1f, 0x1.1b693p-2f,   0x1.8351d8p-1f,
    -0x1.f34258p-1f, -0x1.e51a94p-2f, -0x1.acfc0cp-2f, 0x1.86f79p-3f,
    0x1.fe7f5p-1f,   0x1.d42914p-1f,  0x1.92a4dp-1f,   -0x1.20c8cp-3f};

__device__ __forceinline__ float tent(float w, float t) {
  return fmaxf(1.0f - fabsf(w - t), 0.0f);
}

// floor(x) as int, saturated at +-2^30 (as the plain version clamps
// before its cast); such receivers' windows clamp to the map's edge.
__device__ __forceinline__ int floor_sat(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), -1073741824.0f),
                                1073741824.0f));
}

__global__ void __launch_bounds__(THREADS)
soft_pcf_kernel(const unsigned short* __restrict__ map,
                const float* __restrict__ params, int m, int num_cascades,
                int size, float radius, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const size_t mm = static_cast<size_t>(m);
  const float cx = params[i];
  const float cy = params[mm + i];
  const float dq = params[2 * mm + i];
  const float c = params[3 * mm + i];
  const float s = params[4 * mm + i];
  const int cascade =
      min(max(static_cast<int>(params[5 * mm + i]), 0), num_cascades - 1);

  const int nb = size >> 3;
  const int x_lo = floor_sat(cx) - 3;
  const int y_lo = floor_sat(cy) - 3;
  const int qx0 = min(max(x_lo >> 3, 0), nb - 1);
  const int qy0 = min(max(y_lo >> 3, 0), nb - 1);
  const int oy = min(max(y_lo - 8 * qy0, 0), 7);
  const float fx = cx - static_cast<float>(8 * qx0);
  const float fy = cy - static_cast<float>(8 * qy0);
  const float fy_rel = fy - static_cast<float>(oy);
  const unsigned short* cmap =
      map + static_cast<size_t>(cascade) * size * size;

  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < N_SAMPLE; ++t) {
    const bool outer = (OUTER_TAPS >> t) & 1u;
    const float px = kDiskX[t];
    const float py = kDiskY[t];
    const float dx = (px * c - py * s) * radius;
    const float dy = (px * s + py * c) * radius;
    const float tx = fx + dx;
    const float ty = (outer ? fy : fy_rel) + dy;
    const float rows = outer ? 16.0f : 8.0f;
    const int row0 = outer ? 0 : oy;
    const float x0 = floorf(tx);
    const float y0 = floorf(ty);
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const float wyf = y0 + static_cast<float>(ky);
      if (!(wyf >= 0.0f && wyf < rows)) continue;  // NaN-safe
      const float wy = tent(wyf, ty);
      const int wr = static_cast<int>(wyf) + row0;  // window row, [0, 16)
      const int mrow = min(qy0 + (wr >> 3), nb - 1) * 8 + (wr & 7);
      const unsigned short* row = cmap + static_cast<size_t>(mrow) * size;
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
        const float wxf = x0 + static_cast<float>(kx);
        if (!(wxf >= 0.0f && wxf < 16.0f)) continue;
        const int wc = static_cast<int>(wxf);
        const int mcol = min(qx0 + (wc >> 3), nb - 1) * 8 + (wc & 7);
        const float texel = static_cast<float>(__ldg(row + mcol));
        if (dq <= texel) acc += wy * tent(wxf, tx);
      }
    }
  }
  out[i] = acc * (1.0f / N_SAMPLE);
}

}  // namespace

// Plain C entry point bound with ctypes (ops/pcf.py). map: (C, S, S)
// 16-bit depths; params: (6, m) f32; out: (m,) f32. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int crychic_soft_pcf(const void* map, const void* params, int m,
                                int num_cascades, int size, float radius,
                                void* out, void* stream) {
  const int blocks = (m + THREADS - 1) / THREADS;
  soft_pcf_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(map),
      static_cast<const float*>(params), m, num_cascades, size, radius,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_soft_pcf_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
