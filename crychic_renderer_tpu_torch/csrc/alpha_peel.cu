// Alpha-tested layer depth-peel kernel (K8) for Hopper (sm_90a): the
// peel rounds of passes/frame.py's _alpha_peel, two launches a round,
// over any output grid (the main view, a band of it, a cascade's punch
// window).
//
// What it replaces. No TPU kernel: the JAX package peels the layer with
// XLA ops (crychic_renderer_tpu/passes/frame.py _alpha_peel, a loop over
// the triangles), and the port ran the same function as chunks of
// (triangles, rows, columns) PyTorch ops, each writing its slab to
// device memory, then a gather of each pixel's record and the sampler's
// ops over the whole image. The plain version stays that PyTorch code
// (passes/frame.py _alpha_peel); the CPU takes it, and the card tests
// hold this kernel against it.
//
// Inputs. table (T, 32) f32, one row per triangle, built by torch ops
// (ops/alpha_peel.py peel_table): the edge coefficients A 0:3, B 3:6,
// C 6:9 of rasterizer._edge_coeffs, the depth plane zA, zB, zC 9:12,
// the top-left flags 12:15 and the valid flag 15 (1.0 or 0.0), then the
// peel's 16-float record 16:32 (screen xy 0:6, 1/w 6:9, uv 9:15, three
// vertices each, material 15); the pair pool (rows, 8 | 16) int32 of
// ops/sampling.py; the <= 16-row material tables. The grid: rows x cols
// pixels whose first pixel is (oy, ox), each the sum of a host integer
// and, where given, a 0-d int64 on the device (the punch window's
// origin, so the frame's graph reads no host value).
//
// What it computes. Round k (k = 0 .. n_peels - 1), at px = (ox + x) +
// 0.5, py = (oy + y) + 0.5:
//   search: the first triangle t, in index order, that covers the pixel
//     (three edge functions (A*px + B*py) + C, > 0 or == 0 on a top-left
//     edge), is valid, and whose depth z = (zA*px + zB*py) + zC lies in
//     [0, 1] above the pixel's floor (z > zfloor; -1 in round 0) and
//     strictly below every earlier candidate: the chunked amin, first
//     index and `zmin < zb` of the plain version, so the earliest
//     triangle wins a tie. A pixel whose floor is +inf (no fragment the
//     round before) skips the loop: no z > inf passes. Every pixel then
//     interpolates the uv of its record (triangle 0's where it found
//     none, as rec[clamp(ib, 0)] does): perspective-correct weights with
//     the sign-preserving 1e-20 guard. It writes (u, v, z, id).
//   test: where the search found a fragment and the pixel is not yet
//     resolved, the uv derivatives by finite differences over this grid
//     (sampling.uv_derivatives: the last column and row take their
//     neighbour's difference), sampling.lod_from_derivatives, class_lod
//     and the trilinear fetch of the diffuse map's alpha on the pool's
//     layout, times the material's albedo alpha (_mat_select: 0 outside
//     the table); it passes where alpha - clip_thr >= 0. Then the
//     running result (res_z, res_id; res_id >= 0 is "resolved") takes a
//     passing fragment of an unresolved pixel, and the floor becomes the
//     found depth, or +inf where none was found. The round's count of
//     pixels with a fragment that stay unresolved is summed per block
//     (__syncthreads_count) and added with one integer atomicAdd, so it
//     is the same on every run.
//
// Same bits. The per-triangle values come from the plain version's own
// torch ops (the edge coefficients, 1 / area, the depth plane with
// torch's sum order), so only the per-pixel arithmetic is repeated here,
// in the plain version's order and association, each operation rounded
// on its own (-fmad=false). The functions below that also live in
// csrc/resolve.cu (K7) are copied from it unchanged (marked "K7's
// twin"); K7's notes say how they follow PyTorch's CUDA kernels (a sum
// over a last dimension of 3 adds (e0 + e2) + e1, the NaN rules of the
// clamps). A library is built from one source, so a shared header
// would not enter the build's hash.
//
// What bounds it. At 1920x1080 with 48 triangle slots: 26 f32
// operations per (pixel, triangle) in the search, ~2.6 G a round,
// 0.08 ms at 33.5 T/s; ~40 bytes a pixel read and written, 0.025 ms at
// 3.35 TB/s. A punch window of 640^2 with 24 slots: 0.01 ms a round.
//
// Work split. Blocks of 32 x 8 threads, one thread per pixel; the
// search's block stages the triangles' 16 coefficients in shared memory,
// TILE_TRIS triangles at a time, and every thread walks them in order.
// The pool layout is a template parameter, chosen per launch.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int TABLE = 32;
constexpr int COEFS = 16;
constexpr int REC = 16;
constexpr int TILE_TRIS = 128;

// ops/sampling.py's two-class pool (K7's twin)
constexpr long long POOL_SIZE = 512;
constexpr long long POOL_SIZE_SMALL = 64;
constexpr long long POOL_MIPS = 10;
constexpr long long POOL_MIPS_SMALL = 7;
constexpr long long TEX_STRIDE = (1048576LL - 1) / 3;
constexpr long long TEX_STRIDE_SMALL = (16384LL - 1) / 3;

// the Python constants as torch rounds them to f32 (K7's twin)
constexpr float INV255 = static_cast<float>(1.0 / 255.0);
constexpr float EPS_DEN = static_cast<float>(1e-20);
constexpr float EPS_RHO = static_cast<float>(1e-12);
constexpr float FLOOR_LIMIT = 1073741824.0f;  // 2 ** 30

struct Params {
  const float* table;
  const int* pool;
  const float* mat_albedo;
  const int* mat_pair;
  const long long* oy_dev;
  const long long* ox_dev;
  float* res_z;
  int* res_id;
  float* zfloor;
  float4* found;  // per pixel (u, v, z, id as int bits), the search's
  unsigned long long* counts;
  int rows, cols, oy, ox, tris, n_big, n_mat;
  float clip_thr;
};

// --- K7's twins (csrc/resolve.cu) -----------------------------------------

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float sum3_last(float a, float b, float c) {
  return ((a + c) + b) + 0.0f;
}

__device__ __forceinline__ long long py_mod(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

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

struct Texel {
  long long row, xa, ya;
  float fx, fy;
};

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

__device__ __forceinline__ float class_lod(bool big, float lod_uv) {
  const float bits = big ? 9.0f : 6.0f;
  const float max_mip = big ? 9.0f : 6.0f;
  return min_nan(clamp_min(lod_uv + bits, 0.0f), max_mip);
}

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

__device__ __forceinline__ float lerp3(const float w[3], const float* r,
                                       int base, int width, int c) {
  return (w[0] * r[base + c] + w[1] * r[base + width + c]) +
         w[2] * r[base + 2 * width + c];
}

__device__ __forceinline__ float mat_select(const float* table, int stride,
                                            int col, long long mat,
                                            int n) {
  if (mat < 0 || mat >= n) return 0.0f;
  const float v = table[mat * stride + col];
  return n > 1 ? v + 0.0f : v;
}

// --- the diffuse map's alpha alone ----------------------------------------
// K7's unpack / bilerp / sample_dual / sample_bilinear on channel 3 only:
// each channel is computed on its own, so its bits are the same.

__device__ __forceinline__ float unpack_alpha(int p) {
  return static_cast<float>((p >> 24) & 0xFF) * INV255;
}

__device__ __forceinline__ float bilerp_alpha(int4 q, float fx, float fy) {
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  const float top = unpack_alpha(q.x) * gx + unpack_alpha(q.y) * fx;
  const float bot = unpack_alpha(q.z) * gx + unpack_alpha(q.w) * fx;
  return top * gy + bot * fy;
}

// sampling.sample_pair_trilinear's diffuse alpha at (u, v) and class lod
template <int LANES>
__device__ __forceinline__ float diffuse_alpha(const Params& p, int pair,
                                               float u, float v,
                                               float lod) {
  const long long m0 = static_cast<long long>(floorf(lod));
  const float f = lod - static_cast<float>(m0);
  const float g = 1.0f - f;
  const Texel t = pair_texel(pair, p.n_big, u, v, m0);
  const int4* row = reinterpret_cast<const int4*>(p.pool + t.row * LANES);
  const float a0 = bilerp_alpha(__ldg(row), t.fx, t.fy);
  if (LANES == 16) {  // sampling.sample_pair_dual: the parent's quad
    const float fx1 =
        (0.5f * t.fx - 0.25f) + 0.5f * static_cast<float>(t.xa & 1);
    const float fy1 =
        (0.5f * t.fy - 0.25f) + 0.5f * static_cast<float>(t.ya & 1);
    const float a1 = bilerp_alpha(__ldg(row + 2), fx1, fy1);
    return a0 * g + clamp_nan(a1, 0.0f, 1.0f) * f;
  }
  const Texel t1 = pair_texel(pair, p.n_big, u, v, m0 + 1);
  const float a1 = bilerp_alpha(
      __ldg(reinterpret_cast<const int4*>(p.pool + t1.row * LANES)), t1.fx,
      t1.fy);
  return a0 * g + a1 * f;
}

__device__ __forceinline__ void origin(const Params& p, int x, int y,
                                       float* px, float* py) {
  const long long oy = p.oy + (p.oy_dev != nullptr ? *p.oy_dev : 0);
  const long long ox = p.ox + (p.ox_dev != nullptr ? *p.ox_dev : 0);
  *px = (static_cast<float>(ox) + static_cast<float>(x)) + 0.5f;
  *py = (static_cast<float>(oy) + static_cast<float>(y)) + 0.5f;
}

__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    search_kernel(const Params p, int round) {
  __shared__ float4 coef[TILE_TRIS * COEFS / 4];
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  const int lane = threadIdx.y * BLOCK_X + threadIdx.x;
  const bool inside = x < p.cols && y < p.rows;
  const size_t pix = static_cast<size_t>(y) * p.cols + x;
  if (p.counts != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      lane == 0)
    p.counts[round] = 0;  // the test kernel adds into it after this launch
  const float inf = __int_as_float(0x7f800000);
  const float zfloor = round == 0 ? -1.0f : (inside ? p.zfloor[pix] : inf);
  const bool live = inside && zfloor != inf;
  float px = 0.0f, py = 0.0f;
  origin(p, x, y, &px, &py);

  float best = inf;
  int ib = -1;
  const float4* table4 = reinterpret_cast<const float4*>(p.table);
  for (int t0 = 0; t0 < p.tris; t0 += TILE_TRIS) {
    const int n = min(TILE_TRIS, p.tris - t0);
    __syncthreads();
    for (int k = lane; k < n * (COEFS / 4); k += BLOCK_X * BLOCK_Y)
      coef[k] = __ldg(table4 + (t0 + k / (COEFS / 4)) * (TABLE / 4) +
                      k % (COEFS / 4));
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* c = reinterpret_cast<const float*>(coef + j * 4);
      bool cov = true;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float E = (c[e] * px + c[3 + e] * py) + c[6 + e];
        cov = cov && ((E > 0.0f) || (E == 0.0f && c[12 + e] != 0.0f));
      }
      const float z = (c[9] * px + c[10] * py) + c[11];
      if (cov && c[15] != 0.0f && z >= 0.0f && z <= 1.0f && z > zfloor &&
          z < best) {
        best = z;
        ib = t0 + j;
      }
    }
  }
  if (!inside) return;

  // the record of max(ib, 0): its uv enters the neighbours' derivatives
  float r[REC];
  const float4* rp =
      table4 + static_cast<size_t>(ib < 0 ? 0 : ib) * (TABLE / 4) + COEFS / 4;
#pragma unroll
  for (int k = 0; k < REC / 4; ++k) {
    const float4 v = __ldg(rp + k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
  float w[3];
  weights_at(r, px, py, w);
  p.found[pix] = make_float4(lerp3(w, r, 9, 2, 0), lerp3(w, r, 9, 2, 1),
                             best, __int_as_float(ib));
}

template <int LANES>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    test_kernel(const Params p, int round) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  const bool inside = x < p.cols && y < p.rows;
  bool unresolved = false;
  if (inside) {
    const size_t pix = static_cast<size_t>(y) * p.cols + x;
    const float4 s = p.found[pix];
    const int ib = __float_as_int(s.w);
    const bool resolved = round > 0 && p.res_id[pix] >= 0;
    bool take = false;
    if (ib >= 0 && !resolved) {
      // sampling.uv_derivatives: torch.diff, the last column and row
      // repeating their neighbour's
      const int x0 = x < p.cols - 1 ? x : x - 1;
      const int y0 = y < p.rows - 1 ? y : y - 1;
      const float4 l = p.found[static_cast<size_t>(y) * p.cols + x0];
      const float4 rt = p.found[static_cast<size_t>(y) * p.cols + x0 + 1];
      const float4 u = p.found[static_cast<size_t>(y0) * p.cols + x];
      const float4 d = p.found[static_cast<size_t>(y0 + 1) * p.cols + x];
      const float dx0 = rt.x - l.x, dx1 = rt.y - l.y;
      const float dy0 = d.x - u.x, dy1 = d.y - u.y;
      // sampling.lod_from_derivatives
      const float rho = max_nan(sqrtf(dx0 * dx0 + dx1 * dx1),
                                sqrtf(dy0 * dy0 + dy1 * dy1));
      const float lod_uv = log2f(clamp_min(rho, EPS_RHO));
      const long long mat = static_cast<long long>(
          __ldg(p.table + static_cast<size_t>(ib) * TABLE + COEFS + 15));
      const int pair = (mat >= 0 && mat < p.n_mat) ? p.mat_pair[mat] : 0;
      const float a = diffuse_alpha<LANES>(
          p, pair, s.x, s.y, class_lod(pair < p.n_big, lod_uv));
      const float aval = a * mat_select(p.mat_albedo, 4, 3, mat, p.n_mat);
      take = aval - p.clip_thr >= 0.0f;
    }
    const float inf = __int_as_float(0x7f800000);
    if (round == 0) {
      p.res_z[pix] = take ? s.z : inf;
      p.res_id[pix] = take ? ib : -1;
    } else if (take) {
      p.res_z[pix] = s.z;
      p.res_id[pix] = ib;
    }
    p.zfloor[pix] = ib >= 0 ? s.z : inf;
    unresolved = ib >= 0 && !resolved && !take;
  }
  const int n = __syncthreads_count(unresolved);
  if (p.counts != nullptr && threadIdx.x == 0 && threadIdx.y == 0 && n > 0)
    atomicAdd(p.counts + round, static_cast<unsigned long long>(n));
}

}  // namespace

// Peel the rows x cols grid whose first pixel is (oy + *oy_dev, ox +
// *ox_dev) (oy_dev, ox_dev: 0-d int64 on the device, or null for 0):
// n_peels rounds of the search and the test, 2 * n_peels launches on the
// stream. table: (tris, 32) f32 rows as above, 16-byte aligned; pool:
// (rows, pool_lanes) int32, pool_lanes 16 (dual-mip rows) or 8;
// mat_albedo (n_mat, 4) f32, mat_pair (n_mat,) int32. Writes res_z
// (rows, cols) f32 (+inf where no fragment passes) and res_id int32 (-1
// there); zfloor (rows, cols) f32 and found (rows, cols, 4) f32 are
// scratch; counts, (n_peels,) int64 or null, receives per round the
// pixels with a fragment that stay unresolved. Returns 0 or the CUDA
// error code of the refused launch (cudaErrorInvalidValue for malformed
// arguments).
extern "C" int crychic_alpha_peel(
    const void* table, int tris, const void* pool, int pool_lanes,
    int n_big, const void* mat_albedo, const void* mat_pair, int n_mat,
    int rows, int cols, int oy, int ox, const void* oy_dev,
    const void* ox_dev, int n_peels, float clip_thr, void* res_z,
    void* res_id, void* zfloor, void* found, void* counts, void* stream) {
  if (tris < 1 || rows < 2 || cols < 2 || n_peels < 1 || n_mat < 0 ||
      (pool_lanes != 8 && pool_lanes != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.table = static_cast<const float*>(table);
  p.pool = static_cast<const int*>(pool);
  p.mat_albedo = static_cast<const float*>(mat_albedo);
  p.mat_pair = static_cast<const int*>(mat_pair);
  p.oy_dev = static_cast<const long long*>(oy_dev);
  p.ox_dev = static_cast<const long long*>(ox_dev);
  p.res_z = static_cast<float*>(res_z);
  p.res_id = static_cast<int*>(res_id);
  p.zfloor = static_cast<float*>(zfloor);
  p.found = static_cast<float4*>(found);
  p.counts = static_cast<unsigned long long*>(counts);
  p.rows = rows;
  p.cols = cols;
  p.oy = oy;
  p.ox = ox;
  p.tris = tris;
  p.n_big = n_big;
  p.n_mat = n_mat;
  p.clip_thr = clip_thr;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((cols + BLOCK_X - 1) / BLOCK_X,
                  (rows + BLOCK_Y - 1) / BLOCK_Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int round = 0; round < n_peels; ++round) {
    search_kernel<<<grid, block, 0, s>>>(p, round);
    if (pool_lanes == 16)
      test_kernel<16><<<grid, block, 0, s>>>(p, round);
    else
      test_kernel<8><<<grid, block, 0, s>>>(p, round);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* crychic_alpha_peel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
