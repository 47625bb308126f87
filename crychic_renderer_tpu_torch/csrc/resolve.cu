// G-buffer resolve kernel (K7) for Hopper (sm_90a): the whole per-pixel
// resolve of passes/frame.py (_resolve_core over the tiles that
// _resolve_compacted keeps, or over every pixel) in one launch, written
// straight into the (rows, W, 16) G-buffer.
//
// What it replaces. No TPU kernel: the JAX package resolves the G-buffer
// with XLA ops (crychic_renderer_tpu/passes/frame.py _resolve_core,
// _resolve_compacted), and the port ran the same function as some
// hundreds of PyTorch ops, each writing its (slots, 1024, k) result to
// device memory, then concatenated the planes, gathered the tiles back
// and untiled them. The plain version stays that PyTorch code
// (passes/frame.py resolve_gbuffer_plain); the CPU takes it, and the card
// tests hold this kernel against it.
//
// Inputs. tid (H, W) int32, the main raster's triangle per pixel (-1:
// uncovered); inv (NT,) int64, _compact's tile -> slot table of the
// (8, 128) shade tiles of the full frame (a tile whose slot is cb, past
// the capacity or without a covered pixel, is not resolved), or null for
// the dense resolve; rec (T, 44) f32, _build_resolve_records' per-triangle
// record with one zero pad (11 float4 loads): screen xy 0:6, 1/w 6:9,
// world position 9:18, normal 18:27, tangent 27:36, uv 36:42 (three
// vertices each), material 42; the pair pool (rows, 8 | 16) int32 of
// ops/sampling.py; the <= 16-row material tables; the view matrix.
//
// What it computes, per pixel (x, y) with y < rows: a pixel of a tile
// that is not resolved, or with tid < 0, gets the render targets' clear
// values (_G_CLEAR: black, view-space normal (0, 0, 1)). Otherwise, at
// px = x + 0.5, py = (y + row_offset) + 0.5: the perspective-correct
// weights (rasterizer.barycentrics_at times 1/w, over their sum with the
// sign-preserving 1e-20 guard) at (px, py), (px + 1, py) and (px, py + 1);
// position, normal, tangent and uv interpolated; the uv derivatives from
// the two neighbours (per primitive); the sampler of
// cfg.anisotropy / cfg.aniso_probes (ops/sampling.py: trilinear, the
// anisotropic probe schedule, or the reference-quality probes) on the
// pool's layout (dual-mip rows of 16 lanes, single-mip rows of 8); the
// material by _mat_select's rule (a material outside the table selects
// 0); the TBN transform of the normal sample (shading.py
// normal_sample_to_world) and the view-space normal of the unbumped
// normal (shading.rowmat). Channels: pos_w 0:3, normal_w 3:6, normal_v
// 6:9, albedo 9:13, roughness 13, metalness 14, shininess_alpha 15.
//
// Same bits. Every operation is the plain version's, in its order and
// association, each rounded on its own (the file is built with
// -fmad=false): a / b as a division, the clamps and maximum / minimum
// passing NaN through as torch's do, floorf / ceilf / sqrtf / log2f as
// torch calls them, torch.remainder's sign rule, and the constants as
// torch rounds the Python floats to f32. Four places follow how
// PyTorch's own CUDA kernels evaluate a function, not the formula as
// written:
//   - a sum over a last dimension of 3 (barycentrics_at's area, the
//     weights' sum, normalize's squared length, the tangent's projection):
//     torch's reduction splits the 3 elements over two threads, so it adds
//     (e0 + e2) + e1; its accumulators start at +0, so a zero sum is +0;
//   - rowmat's sum over dimension -2: one thread, (e0 + e1) + e2;
//   - torch.linalg.cross: its kernel's a*b - c*d is contracted by the
//     compiler to fma(a, b, -(c*d));
//   - (i + 0.5) / M with a Python number on the left is torch's
//     M.reciprocal() * (i + 0.5).
// Uncovered pixels and the dropped tiles write the clear values, which
// is what the plain version's torch.where and fill give them. So the
// G-buffer equals the plain version's bit for bit on the card.
//
// What bounds it. At 1920x1080: tid in (8.3 MB) and the G-buffer out
// (133 MB), ~0.042 ms at 3.35 TB/s; the records of the visible triangles
// and each covered pixel's pool rows (two 64-byte dual rows per pixel
// with the 2-probe schedule) mostly hit the 50 MB L2. About 1,050 f32
// operations per covered pixel with that schedule (chip_smoke.py's
// K7_OPS_PER_PIXEL): ~0.031 ms at 33.5 T/s (each operation on its own)
// for config 4's 1.0M covered pixels, so the bytes bound it.
//
// Work split. One block of 128 threads per row of a shade tile (grid:
// tiles x 8), thread l on column l: the block reads its tile's slot once,
// a warp reads 32 consecutive tid words and writes its 32 pixels' 2 KB of
// the G-buffer as four float4 stores each. A covered pixel loads its
// triangle's record as 11 float4 (neighbouring pixels share triangles,
// so these hit the caches) and its pool rows as int4. The sampler mode
// and the pool layout are template parameters, chosen per launch.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int REC = 44;
constexpr int CHANNELS = 16;

constexpr int TRILINEAR = 0;
constexpr int ANISO = 1;
constexpr int ANISO_REF = 2;

// ops/sampling.py's two-class pool: big chains of 512^2 .. 1 (10 mips),
// small chains of 64^2 .. 1 (7 mips)
constexpr long long POOL_SIZE = 512;
constexpr long long POOL_SIZE_SMALL = 64;
constexpr long long POOL_MIPS = 10;
constexpr long long POOL_MIPS_SMALL = 7;
constexpr long long TEX_STRIDE = (1048576LL - 1) / 3;
constexpr long long TEX_STRIDE_SMALL = (16384LL - 1) / 3;

// the Python constants as torch rounds them to f32
constexpr float INV255 = static_cast<float>(1.0 / 255.0);
constexpr float EPS_DEN = static_cast<float>(1e-20);
constexpr float EPS_FOOT = static_cast<float>(1e-24);
constexpr float EPS_RHO = static_cast<float>(1e-12);
constexpr float EPS_W = static_cast<float>(1e-8);
constexpr float RATIO_BIAS = static_cast<float>(1e-4);
constexpr float FLOOR_LIMIT = 1073741824.0f;  // 2 ** 30

struct Params {
  const int* tid;
  const long long* inv;
  const float* rec;
  const int* pool;
  const float* mat_albedo;
  const float* mat_roughness;
  const float* mat_metalness;
  const int* mat_pair;
  const float* view;
  float* out;
  int width, rows, row_offset, ntx, cb, n_big, n_mat;
  int view_s0, view_s1, max_aniso, probes;
};

// torch.clamp / clamp_min / clamp_max and torch.maximum / minimum: a NaN
// passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// x.sum(-1) over a last dimension of 3, as torch's CUDA reduction adds it
__device__ __forceinline__ float sum3_last(float a, float b, float c) {
  return ((a + c) + b) + 0.0f;
}

// (v[..., :, None] * M).sum(dim=-2) (shading.rowmat), one thread in order
__device__ __forceinline__ float sum3_rows(float a, float b, float c) {
  return ((a + b) + c) + 0.0f;
}

// a*b - c*d as torch.linalg.cross's kernel evaluates it
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// torch.remainder of integers: the sign of the divisor
__device__ __forceinline__ long long py_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// sampling._floor_int: floor, clamped to +-2^30, as int64
__device__ __forceinline__ long long floor_int(float x) {
  return static_cast<long long>(
      clamp_nan(floorf(x), -FLOOR_LIMIT, FLOOR_LIMIT));
}

__device__ __forceinline__ long long mip_offset(long long m) {
  return (1048576LL - (1LL << (20 - 2 * m))) / 3;
}

__device__ __forceinline__ long long mip_offset_small(long long m) {
  return (16384LL - (1LL << (14 - 2 * m))) / 3;
}

// sampling.unpack_rgba8 of one word
__device__ __forceinline__ void unpack(int p, float c[4]) {
  c[0] = static_cast<float>(p & 0xFF) * INV255;
  c[1] = static_cast<float>((p >> 8) & 0xFF) * INV255;
  c[2] = static_cast<float>((p >> 16) & 0xFF) * INV255;
  c[3] = static_cast<float>((p >> 24) & 0xFF) * INV255;
}

// sampling._bilerp_quad
__device__ __forceinline__ void bilerp(int4 q, float fx, float fy,
                                       float out[4]) {
  float c00[4], c10[4], c01[4], c11[4];
  unpack(q.x, c00);
  unpack(q.y, c10);
  unpack(q.z, c01);
  unpack(q.w, c11);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = c00[c] * gx + c10[c] * fx;
    const float bot = c01[c] * gx + c11[c] * fx;
    out[c] = top * gy + bot * fy;
  }
}

struct Texel {
  long long row, xa, ya;
  float fx, fy;
};

// sampling._pair_texel: the row of the texel's quad at the pair's
// class-clamped mip and the bilinear fractions
__device__ __forceinline__ Texel pair_texel(int pair, int n_big, float u,
                                            float v, long long mip) {
  const bool big = pair < n_big;
  const long long mb = mip < 0 ? 0 : (mip > POOL_MIPS - 1 ? POOL_MIPS - 1
                                                           : mip);
  const long long ms = mip < 0 ? 0 : (mip > POOL_MIPS_SMALL - 1
                                          ? POOL_MIPS_SMALL - 1 : mip);
  const long long size = big ? (POOL_SIZE >> mb) : (POOL_SIZE_SMALL >> ms);
  const float fsize = static_cast<float>(size);
  const float x = u * fsize - 0.5f;
  const float y = v * fsize - 0.5f;
  Texel t;
  t.fx = x - floorf(x);
  t.fy = y - floorf(y);
  t.xa = py_mod(floor_int(x), size);
  t.ya = py_mod(floor_int(y), size);
  const long long off =
      big ? pair * TEX_STRIDE + mip_offset(mb)
          : n_big * TEX_STRIDE + (pair - n_big) * TEX_STRIDE_SMALL +
                mip_offset_small(ms);
  t.row = off + t.ya * size + t.xa;
  return t;
}

// sampling.sample_pair_bilinear: lanes 0:8 of the row
template <int LANES>
__device__ __forceinline__ void sample_bilinear(const Params& p, int pair,
                                                float u, float v,
                                                long long mip, float d[4],
                                                float n[4]) {
  const Texel t = pair_texel(pair, p.n_big, u, v, mip);
  const int4* row = reinterpret_cast<const int4*>(p.pool + t.row * LANES);
  bilerp(__ldg(row), t.fx, t.fy, d);
  bilerp(__ldg(row + 1), t.fx, t.fy, n);
}

// sampling.sample_pair_dual: the trilinear blend from one dual row
__device__ __forceinline__ void sample_dual(const Params& p, int pair,
                                            float u, float v, long long mip,
                                            float f, float d[4],
                                            float n[4]) {
  const Texel t = pair_texel(pair, p.n_big, u, v, mip);
  const int4* row = reinterpret_cast<const int4*>(p.pool + t.row * 16);
  float d0[4], n0[4], d1[4], n1[4];
  bilerp(__ldg(row), t.fx, t.fy, d0);
  bilerp(__ldg(row + 1), t.fx, t.fy, n0);
  const float fx1 =
      (0.5f * t.fx - 0.25f) + 0.5f * static_cast<float>(t.xa & 1);
  const float fy1 =
      (0.5f * t.fy - 0.25f) + 0.5f * static_cast<float>(t.ya & 1);
  bilerp(__ldg(row + 2), fx1, fy1, d1);
  bilerp(__ldg(row + 3), fx1, fy1, n1);
  const float g = 1.0f - f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    d[c] = d0[c] * g + clamp_nan(d1[c], 0.0f, 1.0f) * f;
    n[c] = n0[c] * g + clamp_nan(n1[c], 0.0f, 1.0f) * f;
  }
}

// sampling.class_lod
__device__ __forceinline__ float class_lod(bool big, float lod_uv) {
  const float bits = big ? 9.0f : 6.0f;
  const float max_mip = big ? 9.0f : 6.0f;
  return min_nan(clamp_min(lod_uv + bits, 0.0f), max_mip);
}

// rasterizer.barycentrics_at at (px, py) times 1/w, over the weights' sum
// with the sign-preserving guard (_resolve_core's weights_at)
__device__ __forceinline__ void weights_at(const float* r, float px,
                                           float py, float w[3]) {
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = (k + 1) % 3;
    const int b = (k + 2) % 3;
    const float ax = r[2 * a], ay = r[2 * a + 1];
    const float bx = r[2 * b], by = r[2 * b + 1];
    e[k] = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
  }
  const float area2 = sum3_last(e[0], e[1], e[2]);
  const float div = area2 == 0.0f ? 1.0f : area2;
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = (e[k] / div) * r[6 + k];
  const float den = sum3_last(w[0], w[1], w[2]);
  const float g = fabsf(den) < EPS_DEN ? EPS_DEN : den;
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = w[k] / g;
}

// one interpolated channel: ((w0 * v0) + (w1 * v1)) + (w2 * v2)
__device__ __forceinline__ float lerp3(const float w[3], const float* r,
                                       int base, int width, int c) {
  return (w[0] * r[base + c] + w[1] * r[base + width + c]) +
         w[2] * r[base + 2 * width + c];
}

// _mat_select of a float table column: table[mat] (a -0 entry reads +0
// once the sum has two rows), 0 outside the table
__device__ __forceinline__ float mat_select(const float* table, int stride,
                                            int col, long long mat,
                                            int n) {
  if (mat < 0 || mat >= n) return 0.0f;
  const float v = table[mat * stride + col];
  return n > 1 ? v + 0.0f : v;
}

__device__ __forceinline__ void store_clear(float4* o) {
  o[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  o[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  o[2] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
  o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The sampler of _resolve_core for one pixel: (diffuse, normal) samples
template <int MODE, int LANES>
__device__ __forceinline__ void sample(const Params& p, int pair,
                                       const float uv[2], const float dx[2],
                                       const float dy[2], float d[4],
                                       float n[4]) {
  const bool big = pair < p.n_big;
  if (MODE == TRILINEAR) {
    // sampling.lod_from_derivatives, then sample_pair_trilinear
    const float rho = max_nan(sqrtf(dx[0] * dx[0] + dx[1] * dx[1]),
                              sqrtf(dy[0] * dy[0] + dy[1] * dy[1]));
    const float lod = class_lod(big, log2f(clamp_min(rho, EPS_RHO)));
    const long long m0 = static_cast<long long>(floorf(lod));
    const float f = lod - static_cast<float>(m0);
    if (LANES == 16) {
      sample_dual(p, pair, uv[0], uv[1], m0, f, d, n);
    } else {
      float d0[4], n0[4], d1[4], n1[4];
      sample_bilinear<LANES>(p, pair, uv[0], uv[1], m0, d0, n0);
      sample_bilinear<LANES>(p, pair, uv[0], uv[1], m0 + 1, d1, n1);
      const float g = 1.0f - f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        d[c] = d0[c] * g + d1[c] * f;
        n[c] = n0[c] * g + n1[c] * f;
      }
    }
    return;
  }
  // sampling._aniso_footprint
  const float lx2 = dx[0] * dx[0] + dx[1] * dx[1];
  const float ly2 = dy[0] * dy[0] + dy[1] * dy[1];
  const bool major_x = lx2 >= ly2;
  const float p_max = sqrtf(clamp_min(max_nan(lx2, ly2), EPS_FOOT));
  const float p_min = sqrtf(clamp_min(min_nan(lx2, ly2), EPS_FOOT));
  const float ratio =
      clamp_nan(p_max / p_min, 1.0f, static_cast<float>(p.max_aniso));
  float M = ceilf(ratio - RATIO_BIAS);
  if (MODE == ANISO) M = clamp_max(M, static_cast<float>(p.probes));
  const float lod = class_lod(big, log2f(p_max / M));
  const float du = major_x ? dx[0] : dy[0];
  const float dv = major_x ? dx[1] : dy[1];
  const long long m0 = static_cast<long long>(floorf(lod));
  const float f = lod - static_cast<float>(m0);

  float da[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float na[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float wa = 0.0f;
  if (MODE == ANISO) {
    // sampling.sample_pair_aniso
    for (int i = 0; i < p.probes; ++i) {
      const float fi = static_cast<float>(i);
      float j = clamp_max(M - 1.0f, fi);
      j = M <= fi ? fi - M : j;
      const float s = ((j + 0.5f) / M - 0.5f) * ((M - 1.0f) / M);
      const float pu = uv[0] + du * s;
      const float pv = uv[1] + dv * s;
      float wgt, ds[4], ns[4];
      if (LANES == 16) {
        wgt = M > fi ? 1.0f : 0.0f;
        sample_dual(p, pair, pu, pv, m0, f, ds, ns);
      } else {
        const bool m1 = i % 2 == 1;
        const float active = clamp_min(2.0f * M, 2.0f) > fi ? 1.0f : 0.0f;
        wgt = (m1 ? f : 1.0f - f) * active;
        sample_bilinear<LANES>(p, pair, pu, pv, m1 ? m0 + 1 : m0, ds, ns);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        da[c] = da[c] + wgt * ds[c];
        na[c] = na[c] + wgt * ns[c];
      }
      wa = wa + wgt;
    }
  } else {
    // sampling.sample_pair_aniso_ref
    const float g = 1.0f - f;
    const float inv_m = 1.0f / M;
    for (int i = 0; i < p.max_aniso; ++i) {
      const float s = (inv_m * (static_cast<float>(i) + 0.5f) - 0.5f) *
                      ((M - 1.0f) / M);
      const float pu = uv[0] + du * s;
      const float pv = uv[1] + dv * s;
      const float active = M > static_cast<float>(i) ? 1.0f : 0.0f;
      float d0[4], n0[4], d1[4], n1[4];
      sample_bilinear<LANES>(p, pair, pu, pv, m0, d0, n0);
      sample_bilinear<LANES>(p, pair, pu, pv, m0 + 1, d1, n1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        da[c] = da[c] + active * (d0[c] * g + d1[c] * f);
        na[c] = na[c] + active * (n0[c] * g + n1[c] * f);
      }
      wa = wa + active;
    }
  }
  wa = clamp_min(wa, EPS_W);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    d[c] = da[c] / wa;
    n[c] = na[c] / wa;
  }
}

template <int MODE, int LANES>
__global__ void __launch_bounds__(TILE_W)
    resolve_kernel(const Params p) {
  const int tile = blockIdx.x;
  const int x = (tile % p.ntx) * TILE_W + threadIdx.x;
  const int y = (tile / p.ntx) * TILE_H + blockIdx.y;
  if (x >= p.width || y >= p.rows) return;
  const size_t pix = static_cast<size_t>(y) * p.width + x;
  float4* o = reinterpret_cast<float4*>(p.out + pix * CHANNELS);
  const int t = p.tid[pix];
  if (t < 0 || (p.inv != nullptr && p.inv[tile] >= p.cb)) {
    store_clear(o);
    return;
  }

  float r[REC];
  const float4* rp = reinterpret_cast<const float4*>(p.rec) +
                     static_cast<size_t>(t) * (REC / 4);
#pragma unroll
  for (int k = 0; k < REC / 4; ++k) {
    const float4 v = __ldg(rp + k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
  const float px = static_cast<float>(x) + 0.5f;
  const float py =
      (static_cast<float>(y) + static_cast<float>(p.row_offset)) + 0.5f;

  float w[3], wx[3], wy[3];
  weights_at(r, px, py, w);
  weights_at(r, px + 1.0f, py, wx);
  weights_at(r, px, py + 1.0f, wy);
  float pos[3], nrm[3], tan[3], uv[2], dx[2], dy[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pos[c] = lerp3(w, r, 9, 3, c);
    nrm[c] = lerp3(w, r, 18, 3, c);
    tan[c] = lerp3(w, r, 27, 3, c);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uv[c] = lerp3(w, r, 36, 2, c);
    dx[c] = lerp3(wx, r, 36, 2, c) - uv[c];
    dy[c] = lerp3(wy, r, 36, 2, c) - uv[c];
  }
  const long long mat = static_cast<long long>(r[42]);
  const int pair = (mat >= 0 && mat < p.n_mat) ? p.mat_pair[mat] : 0;

  float diffuse[4], ns[4];
  sample<MODE, LANES>(p, pair, uv, dx, dy, diffuse, ns);

  float albedo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    albedo[c] = mat_select(p.mat_albedo, 4, c, mat, p.n_mat) * diffuse[c];

  // shading.normalize of the interpolated normal
  const float nlen = sqrtf(sum3_last(nrm[0] * nrm[0], nrm[1] * nrm[1],
                                     nrm[2] * nrm[2]));
  const float nd = clamp_min(nlen, EPS_DEN);
  float N[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) N[c] = nrm[c] / nd;

  // shading.normal_sample_to_world
  const float tn = sum3_last(tan[0] * N[0], tan[1] * N[1], tan[2] * N[2]);
  float T[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) T[c] = tan[c] - tn * N[c];
  const float tlen =
      sqrtf(sum3_last(T[0] * T[0], T[1] * T[1], T[2] * T[2]));
  const float td = clamp_min(tlen, EPS_DEN);
#pragma unroll
  for (int c = 0; c < 3; ++c) T[c] = T[c] / td;
  const float B[3] = {cross_term(N[1], T[2], N[2], T[1]),
                      cross_term(N[2], T[0], N[0], T[2]),
                      cross_term(N[0], T[1], N[1], T[0])};
  float nt[3], bumped[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) nt[c] = 2.0f * ns[c] - 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    bumped[c] = (nt[0] * T[c] + nt[1] * B[c]) + nt[2] * N[c];

  // shading.rowmat(N, view[:3, :3]) (DrawNormals.hlsl:91)
  float nv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* col = p.view + j * p.view_s1;
    nv[j] = sum3_rows(N[0] * col[0], N[1] * col[p.view_s0],
                      N[2] * col[2 * p.view_s0]);
  }

  o[0] = make_float4(pos[0], pos[1], pos[2], bumped[0]);
  o[1] = make_float4(bumped[1], bumped[2], nv[0], nv[1]);
  o[2] = make_float4(nv[2], albedo[0], albedo[1], albedo[2]);
  o[3] = make_float4(albedo[3],
                     mat_select(p.mat_roughness, 1, 0, mat, p.n_mat),
                     mat_select(p.mat_metalness, 1, 0, mat, p.n_mat), ns[3]);
}

template <int MODE, int LANES>
cudaError_t launch(const Params& p, int tiles, cudaStream_t stream) {
  resolve_kernel<MODE, LANES>
      <<<dim3(tiles, TILE_H), TILE_W, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int LANES>
cudaError_t launch_mode(const Params& p, int mode, int tiles,
                        cudaStream_t stream) {
  switch (mode) {
    case TRILINEAR:
      return launch<TRILINEAR, LANES>(p, tiles, stream);
    case ANISO:
      return launch<ANISO, LANES>(p, tiles, stream);
    default:
      return launch<ANISO_REF, LANES>(p, tiles, stream);
  }
}

}  // namespace

// Resolve rows [0, rows) of the (H, W) frame into out, (rows, width, 16)
// f32. inv: the (ntx * ceil(H / 8),) tile -> slot table and cb its
// capacity, or null for every tile. mode: 0 trilinear, 1 the probe
// schedule of `probes` probes, 2 the reference-quality probes;
// pool_lanes: 16 (dual-mip rows) or 8. view, view_s0, view_s1: the view
// matrix and its strides in floats. Returns 0 or the CUDA error code of
// the refused launch (or cudaErrorInvalidValue for malformed arguments).
extern "C" int crychic_resolve(const void* tid, const void* inv, int cb,
                               const void* rec, const void* pool,
                               int pool_lanes, int n_big,
                               const void* mat_albedo,
                               const void* mat_roughness,
                               const void* mat_metalness,
                               const void* mat_pair, int n_mat,
                               const void* view, int view_s0, int view_s1,
                               int width, int rows, int row_offset,
                               int mode, int max_aniso, int probes,
                               void* out, void* stream) {
  if (width <= 0 || rows <= 0 || n_mat < 0 || mode < TRILINEAR ||
      mode > ANISO_REF || (pool_lanes != 8 && pool_lanes != 16) ||
      (mode != TRILINEAR && max_aniso < 1) || (mode == ANISO && probes < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.tid = static_cast<const int*>(tid);
  p.inv = static_cast<const long long*>(inv);
  p.rec = static_cast<const float*>(rec);
  p.pool = static_cast<const int*>(pool);
  p.mat_albedo = static_cast<const float*>(mat_albedo);
  p.mat_roughness = static_cast<const float*>(mat_roughness);
  p.mat_metalness = static_cast<const float*>(mat_metalness);
  p.mat_pair = static_cast<const int*>(mat_pair);
  p.view = static_cast<const float*>(view);
  p.out = static_cast<float*>(out);
  p.width = width;
  p.rows = rows;
  p.row_offset = row_offset;
  p.ntx = (width + TILE_W - 1) / TILE_W;
  p.cb = cb;
  p.n_big = n_big;
  p.n_mat = n_mat;
  p.view_s0 = view_s0;
  p.view_s1 = view_s1;
  p.max_aniso = max_aniso;
  p.probes = probes;
  const int tiles = p.ntx * ((rows + TILE_H - 1) / TILE_H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pool_lanes == 16
                              ? launch_mode<16>(p, mode, tiles, s)
                              : launch_mode<8>(p, mode, tiles, s);
  return static_cast<int>(err);
}

extern "C" const char* crychic_resolve_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
