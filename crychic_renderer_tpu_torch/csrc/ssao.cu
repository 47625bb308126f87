// SSAO kernel K9 for Hopper (sm_90a): the half-resolution occlusion of
// passes/frame.py's SSAO stage in one launch, and each of its bilateral
// blur iterations (the horizontal and the vertical pass) in one launch.
//
// What it replaces. No TPU kernel: the JAX package runs SSAO with XLA ops
// (crychic_renderer_tpu/ops/ssao.py ssao_occlusion, bilateral_blur), and
// the port ran the same functions as some 3,400 PyTorch ops a frame, each
// writing its (slots, 256) or (h, w) result to device memory: the
// occlusion's 14 taps over a packed table of the kept tiles, gathered
// back and untiled, and six blur passes of shifted copies. The plain
// version stays that PyTorch code (passes/frame.py ssao_pass_plain,
// ssao_blur_plain); the CPU takes it, and the card tests hold this kernel
// against it.
//
// Occlusion (crychic_ssao_occlusion). Inputs: the (h, w, 3) half-res
// view-space normals (any strides), the (h, w) half-res NDC depth, the
// (h, w, 3) random-vector field, the (TH, TW) full-res NDC depth the
// taps sample, the (14, 3) offsets, proj and inv_proj; inv (NT,) int64,
// _compact's tile -> slot table of the (8, 32) SSAO tiles, or null for
// every tile. Per pixel (x, y) of a tile whose slot is below cb (every
// pixel without inv): ops/ssao.ssao_occlusion at uv ((x + 0.5) / w,
// (y + row_offset + 0.5) / full_height): the view ray through inv_proj,
// the view position from the depth, the normalized normal, and per
// offset the reflection about the random vector, the flip to the
// normal's side, the projection, the bilinear border-white tap of the
// full-res depth (_tap_depth_bilinear_white's clamps and far test), the
// linear falloff; then pow(clamp(1 - sum / 14, 0, 1), 6). A pixel of a
// tile past the capacity or without a covered neighbour writes 1.0, the
// plain version's fill. The (h, w) access map is written directly.
//
// Blur (crychic_ssao_blur). One iteration of passes/frame.ssao_blur: the
// horizontal ops/ssao.bilateral_blur pass, then the vertical one, over
// the access map, the half-res normals and the view depth B / (d - A).
// A block stages its 32 x 32 output tile with a 5-texel halo of the
// three maps in shared memory (edge-clamped, as pointClamp reads the
// access map and the normals), runs the horizontal pass over the tile's
// columns for every row the vertical pass reads, keeps it in shared
// memory, then runs the vertical pass and writes the tile. A depth tap
// past the map's edge reads the far plane's view depth B / (1 - A)
// (gsamDepthMap's white border), as the plain version's border does.
//
// Same bits. Every operation is the plain version's, in its order and
// association, each rounded on its own (the file is built with
// -fmad=false): divisions as divisions, the clamps passing NaN through
// as torch's do, sqrtf and floorf as torch calls them, torch.sign's
// (0 < a) - (a < 0), and the Python constants as torch rounds them to
// f32. Where PyTorch's own CUDA kernels evaluate a function other than
// as written, this file follows them:
//   - a sum over a last dimension of 3 (the dot products, the squared
//     lengths): two threads split the three elements, so torch adds
//     (e0 + e2) + e1 from +0;
//   - shading.rowmat's sum over dimension -2 of 4: one thread in order,
//     ((e0 + e1) + e2) + e3 from +0;
//   - a tensor divided by a Python number is multiplied by the f32
//     reciprocal of that number: (i + 0.5) / w, sum / 14 and
//     (fade_end - dist_z) / fade_len;
//   - x ** 6 is the scalar-exponent pow kernel's powf(x, 6.0f).
// So the access map equals the plain version's bit for bit on the card.
//
// What bounds it. At 960x540 half-res (the 1080p frame): the occlusion
// reads per kept pixel its depth, normal and random vector (28 B), plus
// the full-res depth its taps read (8.3 MB) and the whole map it writes
// (2.1 MB): ~18 MB, ~0.005 ms at 3.35 TB/s for config 4's 272,640 kept
// pixels. Its arithmetic, ~2,000 f32 operations a pixel (14 taps of
// ~137, each rounded on its own, a division counted once), is ~0.016 ms
// at 33.5 T/s, so the operations bound it. A blur iteration reads the
// map, the normals and the depth and writes the map (12.4 MB, ~0.004
// ms) and needs ~306 operations a pixel (~0.005 ms). The launches are
// short; what they cost is the latency of the taps' scattered depth
// reads and the divisions, and the blur's serial 10-tap chains.
#include <cuda_runtime.h>

namespace {

// passes/frame.py SSAO_TILE_H, SSAO_TILE_W: one block per tile
constexpr int TILE_H = 8;
constexpr int TILE_W = 32;
constexpr int TAPS = 14;
// the blur: radius ceil(2 * 2.5) (ops/ssao.calc_gauss_weights) and the
// output tile of a block
constexpr int RADIUS = 5;
constexpr int BLUR_W = 32;
constexpr int BLUR_H = 32;
constexpr int WIN_W = BLUR_W + 2 * RADIUS;
constexpr int WIN_H = BLUR_H + 2 * RADIUS;
constexpr int BLUR_THREADS = 256;

// ops/ssao.ssao_occlusion's defaults as torch rounds them to f32
constexpr float OCC_RADIUS = 0.5f;
constexpr float FADE_END = 1.0f;
constexpr float SURFACE_EPS = static_cast<float>(0.05);
constexpr float FADE_LEN = static_cast<float>(1.0 - 0.2);
constexpr float EPS = static_cast<float>(1e-8);
constexpr float FLOOR_LIMIT = 1073741824.0f;  // 2 ** 30
// bilateral_blur's edge stops
constexpr float NORMAL_STOP = static_cast<float>(0.8);
constexpr float DEPTH_STOP = static_cast<float>(0.2);

struct OcclusionParams {
  const long long* inv;
  const float* normal;
  long long ns0, ns1, ns2;
  const float* depth;
  const float* field;
  const float* tap;
  const float* offsets;
  const float* proj;
  const float* inv_proj;
  float* out;
  int h, w, tap_h, tap_w, ntx, cb, row_offset, full_height;
  int proj_s0, proj_s1, inv_s0, inv_s1;
};

struct BlurParams {
  const float* access;
  const float* normal;
  long long ns0, ns1, ns2;
  const float* depth;
  const float* weights;
  const float* proj;
  float* out;
  int h, w, proj_s0, proj_s1;
};

// torch.clamp / clamp_min: a NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// x.sum(-1) over a last dimension of 3, as torch's CUDA reduction adds it
__device__ __forceinline__ float sum3_last(float a, float b, float c) {
  return ((a + c) + b) + 0.0f;
}

// shading.rowmat's (v[..., :, None] * M).sum(dim=-2) of a 4-vector
__device__ __forceinline__ float sum4_rows(float a, float b, float c,
                                           float d) {
  return (((a + b) + c) + d) + 0.0f;
}

// torch.sign
__device__ __forceinline__ float sign_of(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// ops/ssao.ndc_depth_to_view
__device__ __forceinline__ float to_view(float z, float A, float B) {
  return B / (z - A);
}

// row-vector v (4) times the (4, 4) matrix M with strides s0, s1
__device__ __forceinline__ void rowmat4(const float v[4], const float* M,
                                        int s0, int s1, float out[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* col = M + c * s1;
    out[c] = sum4_rows(v[0] * col[0], v[1] * col[s0], v[2] * col[2 * s0],
                       v[3] * col[3 * s0]);
  }
}

// the padded border-white map of _pad_border_white at (yy, xx)
__device__ __forceinline__ float padded(const OcclusionParams& p,
                                        long long yy, long long xx) {
  return (yy >= 1 && yy <= p.tap_h && xx >= 1 && xx <= p.tap_w)
             ? __ldg(p.tap + (yy - 1) * p.tap_w + (xx - 1))
             : 1.0f;
}

// ops/ssao._tap_depth_bilinear_white at texture-space (u, v)
__device__ __forceinline__ float tap_depth(const OcclusionParams& p, float u,
                                           float v) {
  const float x = u * static_cast<float>(p.tap_w) - 0.5f;
  const float y = v * static_cast<float>(p.tap_h) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const long long x0i = static_cast<long long>(
      clamp_nan(x0, -FLOOR_LIMIT, FLOOR_LIMIT));
  const long long y0i = static_cast<long long>(
      clamp_nan(y0, -FLOOR_LIMIT, FLOOR_LIMIT));
  const long long xq =
      min(max(x0i + 1, 0LL), static_cast<long long>(p.tap_w) + 1);
  const long long yq =
      min(max(y0i + 1, 0LL), static_cast<long long>(p.tap_h) + 1);
  const float q00 = padded(p, yq, xq);
  const float q10 = padded(p, yq, xq + 1);
  const float q01 = padded(p, yq + 1, xq);
  const float q11 = padded(p, yq + 1, xq + 1);
  const float top = q00 * (1.0f - fx) + q10 * fx;
  const float bot = q01 * (1.0f - fx) + q11 * fx;
  const float d = top * (1.0f - fy) + bot * fy;
  const bool far = x0i < -1 || x0i > p.tap_w || y0i < -1 || y0i > p.tap_h;
  return far ? 1.0f : d;
}

// ops/ssao.ssao_occlusion at pixel (x, y)
__device__ float occlusion(const OcclusionParams& p, int x, int y) {
  const float A = p.proj[2 * p.proj_s0 + 2 * p.proj_s1];
  const float B = p.proj[3 * p.proj_s0 + 2 * p.proj_s1];
  const float U = (static_cast<float>(x) + 0.5f) *
                  (1.0f / static_cast<float>(p.w));
  const float V = (static_cast<float>(y + p.row_offset) + 0.5f) *
                  (1.0f / static_cast<float>(p.full_height));
  const float ndc[4] = {U * 2.0f - 1.0f, 1.0f - V * 2.0f, 0.0f, 1.0f};
  float ph[4];
  rowmat4(ndc, p.inv_proj, p.inv_s0, p.inv_s1, ph);
  float ray[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ray[c] = ph[c] / ph[3];

  const long long px = static_cast<long long>(y) * p.w + x;
  const float pz = to_view(__ldg(p.depth + px), A, B);
  const float s = pz / ray[2];
  float P[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) P[c] = s * ray[c];

  const float* nrm = p.normal + y * p.ns0 + x * p.ns1;
  float N[3] = {__ldg(nrm), __ldg(nrm + p.ns2), __ldg(nrm + 2 * p.ns2)};
  const float nlen = clamp_min(
      sqrtf(sum3_last(N[0] * N[0], N[1] * N[1], N[2] * N[2])), EPS);
#pragma unroll
  for (int c = 0; c < 3; ++c) N[c] = N[c] / nlen;
  const float rv[3] = {__ldg(p.field + 3 * px), __ldg(p.field + 3 * px + 1),
                       __ldg(p.field + 3 * px + 2)};

  const float inv_fade = 1.0f / FADE_LEN;
  float occlusion_sum = 0.0f;
  for (int i = 0; i < TAPS; ++i) {
    const float off[3] = {__ldg(p.offsets + 3 * i),
                          __ldg(p.offsets + 3 * i + 1),
                          __ldg(p.offsets + 3 * i + 2)};
    // reflect(offset, randVec) = off - 2 * dot(off, rv) * rv
    const float t =
        sum3_last(rv[0] * off[0], rv[1] * off[1], rv[2] * off[2]) * 2.0f;
    float refl[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) refl[c] = off[c] - t * rv[c];
    const float flip =
        sign_of(sum3_last(refl[0] * N[0], refl[1] * N[1], refl[2] * N[2]));
    const float fr = flip * OCC_RADIUS;
    float q[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = P[c] + fr * refl[c];
    q[3] = 1.0f;
    float qh[4];
    rowmat4(q, p.proj, p.proj_s0, p.proj_s1, qh);
    const float qw = clamp_min(qh[3], EPS);
    const float qu = (qh[0] / qw) * 0.5f + 0.5f;
    const float qv = (-(qh[1] / qw)) * 0.5f + 0.5f;
    const float rz = to_view(tap_depth(p, qu, qv), A, B);
    const float sr = rz / (q[2] == 0.0f ? EPS : q[2]);
    float r[3], rp[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = sr * q[c];
      rp[c] = r[c] - P[c];
    }
    const float dist_z = P[2] - r[2];
    const float rlen = clamp_min(
        sqrtf(sum3_last(rp[0] * rp[0], rp[1] * rp[1], rp[2] * rp[2])), EPS);
    const float dp = clamp_min(
        sum3_last(N[0] * rp[0], N[1] * rp[1], N[2] * rp[2]) / rlen, 0.0f);
    const float occ = dist_z > SURFACE_EPS
                          ? clamp_nan((FADE_END - dist_z) * inv_fade, 0.0f,
                                      1.0f)
                          : 0.0f;
    occlusion_sum = occlusion_sum + dp * occ;
  }
  const float access =
      1.0f - occlusion_sum * (1.0f / static_cast<float>(TAPS));
  return powf(clamp_nan(access, 0.0f, 1.0f), 6.0f);
}

// One block per (8, 32) tile, one thread per pixel.
__global__ void __launch_bounds__(TILE_H * TILE_W)
    occlusion_kernel(OcclusionParams p) {
  const int tile = blockIdx.x;
  const int x = (tile % p.ntx) * TILE_W + threadIdx.x;
  const int y = (tile / p.ntx) * TILE_H + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  float* o = p.out + static_cast<long long>(y) * p.w + x;
  if (p.inv != nullptr && p.inv[tile] >= p.cb) {
    *o = 1.0f;
    return;
  }
  *o = occlusion(p, x, y);
}

// one bilateral_blur tap: the weight it adds (0 where an edge stops it)
__device__ __forceinline__ float blur_weight(const float* n_n,
                                             const float* n_c, float d_n,
                                             float d_c, float w) {
  const bool ok =
      sum3_last(n_n[0] * n_c[0], n_n[1] * n_c[1], n_n[2] * n_c[2]) >=
          NORMAL_STOP &&
      fabsf(d_n - d_c) <= DEPTH_STOP;
  return w * (ok ? 1.0f : 0.0f);
}

// One block per (32, 32) output tile: the horizontal pass into shared
// memory over the tile's columns and every row the vertical pass reads,
// then the vertical pass.
__global__ void __launch_bounds__(BLUR_THREADS) blur_kernel(BlurParams p) {
  __shared__ float s_a[WIN_H][WIN_W];
  __shared__ float s_n[WIN_H][WIN_W][3];
  __shared__ float s_d[WIN_H][WIN_W];
  __shared__ float s_h[WIN_H][BLUR_W];
  __shared__ float s_w[2 * RADIUS + 1];

  const int x0 = blockIdx.x * BLUR_W;
  const int y0 = blockIdx.y * BLUR_H;
  const float A = p.proj[2 * p.proj_s0 + 2 * p.proj_s1];
  const float B = p.proj[3 * p.proj_s0 + 2 * p.proj_s1];
  const float border = B / (1.0f - A);

  if (threadIdx.x < 2 * RADIUS + 1) s_w[threadIdx.x] = p.weights[threadIdx.x];
  for (int i = threadIdx.x; i < WIN_H * WIN_W; i += BLUR_THREADS) {
    const int wy = i / WIN_W;
    const int wx = i % WIN_W;
    const int r = min(max(y0 - RADIUS + wy, 0), p.h - 1);
    const int c = min(max(x0 - RADIUS + wx, 0), p.w - 1);
    const long long px = static_cast<long long>(r) * p.w + c;
    s_a[wy][wx] = __ldg(p.access + px);
    s_d[wy][wx] = to_view(__ldg(p.depth + px), A, B);
    const float* nrm = p.normal + r * p.ns0 + c * p.ns1;
    s_n[wy][wx][0] = __ldg(nrm);
    s_n[wy][wx][1] = __ldg(nrm + p.ns2);
    s_n[wy][wx][2] = __ldg(nrm + 2 * p.ns2);
  }
  __syncthreads();

  const float w_c = s_w[RADIUS];
  // horizontal: rows y0 - RADIUS .. y0 + BLUR_H + RADIUS - 1 on the map
  for (int i = threadIdx.x; i < WIN_H * BLUR_W; i += BLUR_THREADS) {
    const int wy = i / BLUR_W;
    const int tx = i % BLUR_W;
    const int r = y0 - RADIUS + wy;
    const int x = x0 + tx;
    if (r < 0 || r >= p.h || x >= p.w) continue;
    const int wc = tx + RADIUS;
    const float* n_c = s_n[wy][wc];
    const float d_c = s_d[wy][wc];
    float acc = w_c * s_a[wy][wc];
    float total = w_c;
#pragma unroll
    for (int k = -RADIUS; k <= RADIUS; ++k) {
      if (k == 0) continue;
      const int col = x + k;
      const float d_n = (col < 0 || col >= p.w) ? border : s_d[wy][wc + k];
      const float wgt = blur_weight(s_n[wy][wc + k], n_c, d_n, d_c,
                                    s_w[k + RADIUS]);
      acc = acc + wgt * s_a[wy][wc + k];
      total = total + wgt;
    }
    s_h[wy][tx] = acc / total;
  }
  __syncthreads();

  // vertical, over the horizontal pass's rows (edge-clamped)
  for (int i = threadIdx.x; i < BLUR_H * BLUR_W; i += BLUR_THREADS) {
    const int ty = i / BLUR_W;
    const int tx = i % BLUR_W;
    const int y = y0 + ty;
    const int x = x0 + tx;
    if (y >= p.h || x >= p.w) continue;
    const int wy = ty + RADIUS;
    const int wc = tx + RADIUS;
    const float* n_c = s_n[wy][wc];
    const float d_c = s_d[wy][wc];
    float acc = w_c * s_h[wy][tx];
    float total = w_c;
#pragma unroll
    for (int k = -RADIUS; k <= RADIUS; ++k) {
      if (k == 0) continue;
      const int row = y + k;
      const int wr = min(max(row, 0), p.h - 1) - y0 + RADIUS;
      const float d_n = (row < 0 || row >= p.h) ? border : s_d[wr][wc];
      const float wgt =
          blur_weight(s_n[wr][wc], n_c, d_n, d_c, s_w[k + RADIUS]);
      acc = acc + wgt * s_h[wr][tx];
      total = total + wgt;
    }
    p.out[static_cast<long long>(y) * p.w + x] = acc / total;
  }
}

}  // namespace

// The (h, w) access map of the occlusion into out. inv: the (ntx *
// ceil(h / 8),) tile -> slot table and cb its capacity, or null for every
// tile; row_offset / full_height: the map's first row in a full_height-row
// screen (0 and h for the whole screen; a padded band's last rows may lie
// past it). normal_s0..s2, proj_s0/s1,
// inv_s0/s1: strides in floats. Returns 0 or the CUDA error code of the
// refused launch (cudaErrorInvalidValue for malformed arguments).
extern "C" int crychic_ssao_occlusion(
    const void* inv, int cb, const void* normal, long long normal_s0,
    long long normal_s1, long long normal_s2, const void* depth,
    const void* field, const void* tap, int tap_h, int tap_w,
    const void* offsets, const void* proj, int proj_s0, int proj_s1,
    const void* inv_proj, int inv_s0, int inv_s1, int h, int w,
    int row_offset, int full_height, void* out, void* stream) {
  if (h <= 0 || w <= 0 || tap_h <= 0 || tap_w <= 0 || row_offset < 0 ||
      full_height <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  OcclusionParams p;
  p.inv = static_cast<const long long*>(inv);
  p.normal = static_cast<const float*>(normal);
  p.ns0 = normal_s0;
  p.ns1 = normal_s1;
  p.ns2 = normal_s2;
  p.depth = static_cast<const float*>(depth);
  p.field = static_cast<const float*>(field);
  p.tap = static_cast<const float*>(tap);
  p.offsets = static_cast<const float*>(offsets);
  p.proj = static_cast<const float*>(proj);
  p.inv_proj = static_cast<const float*>(inv_proj);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.w = w;
  p.tap_h = tap_h;
  p.tap_w = tap_w;
  p.ntx = (w + TILE_W - 1) / TILE_W;
  p.cb = cb;
  p.row_offset = row_offset;
  p.full_height = full_height;
  p.proj_s0 = proj_s0;
  p.proj_s1 = proj_s1;
  p.inv_s0 = inv_s0;
  p.inv_s1 = inv_s1;
  const int tiles = p.ntx * ((h + TILE_H - 1) / TILE_H);
  occlusion_kernel<<<tiles, dim3(TILE_W, TILE_H), 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One blur iteration (horizontal, then vertical) of the (h, w) access map
// into out (not the input's buffer). depth: the (h, w) NDC depth;
// weights: the 11 Gaussian weights.
extern "C" int crychic_ssao_blur(const void* access, const void* normal,
                                 long long normal_s0, long long normal_s1,
                                 long long normal_s2, const void* depth,
                                 const void* weights, const void* proj,
                                 int proj_s0, int proj_s1, int h, int w,
                                 void* out, void* stream) {
  if (h <= 0 || w <= 0 || out == access)
    return static_cast<int>(cudaErrorInvalidValue);
  BlurParams p;
  p.access = static_cast<const float*>(access);
  p.normal = static_cast<const float*>(normal);
  p.ns0 = normal_s0;
  p.ns1 = normal_s1;
  p.ns2 = normal_s2;
  p.depth = static_cast<const float*>(depth);
  p.weights = static_cast<const float*>(weights);
  p.proj = static_cast<const float*>(proj);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.w = w;
  p.proj_s0 = proj_s0;
  p.proj_s1 = proj_s1;
  const dim3 grid((w + BLUR_W - 1) / BLUR_W, (h + BLUR_H - 1) / BLUR_H);
  blur_kernel<<<grid, BLUR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_ssao_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
