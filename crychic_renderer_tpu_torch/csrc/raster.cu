// Tile raster kernel for Hopper (sm_90a): the CUDA counterpart of the JAX
// package's Pallas kernel crychic_renderer_tpu/ops/raster_pallas.py
// (_raster_kernel, launched by rasterize_pallas). It serves both of the
// frame's launches: the main view (depth + triangle id) and the shadow
// atlas (depth only, with the per-record column guard [xlo, xhi)), for
// the full screen (K1, K2) and for one band of it (K3, the band modes of
// rasterize_pallas that parallel/sharded.py launches).
//
// Bands. A launch covers grid_tiles tiles whose runs are keys
// [tile_offset, tile_offset + grid_tiles) of the binning: the owner-major
// keys of one owner's interleaved tile rows (tile_offset = owner * rpd *
// ntx), or a contiguous run of tile rows (tile_offset = first row * ntx).
// Block b writes output rows (b / ntx) * 8 .. + 7; a band's output is whole
// tiles, so only the full screen's ragged last tile row is cropped (at
// height). The records are tile-local (build_records anchors C and zC
// at the tile's true, full-screen origin), so the arithmetic is that of
// the full-screen launch and a band equals the full raster's rows bit for
// bit. A key row past the screen (the last owner's padding when n_dev
// does not divide the tile rows) has count 0 and writes the clears.
//
// What it computes. The screen is cut into 8x128-pixel tiles. Binning
// (ops/rasterizer.py bin_triangles) sorts (tile, triangle) pairs by tile,
// so each tile's records are one contiguous run [start, start + count) of
// the (P, 16) f32 record array built by ops/raster.py build_records:
//   0-2 edge A, 3-5 edge B, 6-8 tile-local edge C with the top-left
//   epsilon folded in, 9-11 tile-local depth plane (zA, zB, zC),
//   12 triangle id (exact in f32), 13-14 tile-local xlo/xhi, 15 pad.
// At each pixel centre (lane % 128 + 0.5, lane / 128 + 0.5) a record
// covers when all three edge values are >= 0 (and, in atlas mode, the
// centre lies in [xlo, xhi)) and its depth z lies in [0, 1]. The pixel
// keeps the smallest z (clear 1.0, strict <) and the id that gave it.
// Ids in a run are strictly ascending (stable sort), so updating with a
// strict < in run order hands exact-z ties to the smallest id — the
// Pallas kernel's rule (min id within a block, earliest block across).
//
// Arithmetic. Each plane is evaluated as ((A*px) + (B*py)) + C with every
// operation rounded on its own (__fmul_rn/__fadd_rn, and the file is
// built with -fmad=false), which is how eager PyTorch evaluates the plain
// version (ops/raster.py rasterize_plain). The two are therefore equal
// bit for bit on the card.
//
// Work split. One block of 256 threads per tile; thread t owns the four
// pixels of column t % 128 in rows t / 128 + {0, 2, 4, 6}, with best z
// and best id in registers. The tile's run is staged through shared
// memory in chunks of 128 records (8 KB), loaded cooperatively as float4
// so the loads coalesce; every thread then reads the same record, which
// shared memory broadcasts. Output goes straight into the (H, W) planes;
// the ragged right and bottom tiles are masked, and empty tiles write the
// clears.
//
// What bounds it. Per pixel and record the function needs 8 f32 adds and
// 6 compares (A*px is shared down a column, B*py along a row), with 64
// bytes of record per 1024 pixels: the kernel is bound by f32 issue in
// the heavy tiles (chip_smoke.py RASTER_OPS_PER_PAIR counts the
// operations per record and tile), and by load imbalance, since a
// tile's run is processed by one block alone (the shadow atlas has a few
// tiles with thousands of records). It is simple on purpose: cp.async or
// TMA staging of the next chunk, and several tiles per block to balance
// the runs, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 128;
constexpr int TILE_H = 8;
constexpr int THREADS = 256;
constexpr int PIX = TILE_W * TILE_H / THREADS;  // pixels per thread: 4
constexpr int ROW_STEP = THREADS / TILE_W;      // 2
constexpr int CHUNK = 128;                      // records per smem stage

__device__ __forceinline__ float plane(float apx, float b, float py,
                                       float c) {
  return __fadd_rn(__fadd_rn(apx, __fmul_rn(b, py)), c);
}

template <bool WITH_IDS, bool WITH_XRANGE>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float4* __restrict__ records,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts, int tile_offset,
                    int ntx, int width, int height,
                    float* __restrict__ depth, int* __restrict__ tid) {
  __shared__ float4 srec[CHUNK * 4];

  const int tile = blockIdx.x;  // position in the launch's grid
  const int tile_x = tile % ntx;
  const int tile_y = tile / ntx;  // output tile row
  const int start = starts[tile_offset + tile];
  const int count = counts[tile_offset + tile];
  const int t = threadIdx.x;

  const float px = static_cast<float>(t % TILE_W) + 0.5f;
  float py[PIX];
  float best_z[PIX];
  int best_id[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    py[k] = static_cast<float>(k * ROW_STEP + t / TILE_W) + 0.5f;
    best_z[k] = 1.0f;
    best_id[k] = -1;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk has been consumed
    const float4* src = records + static_cast<size_t>(start + base) * 4;
    for (int i = t; i < n * 4; i += THREADS) srec[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float4 r0 = srec[j * 4 + 0];  // A0 A1 A2 B0
      const float4 r1 = srec[j * 4 + 1];  // B1 B2 C0 C1
      const float4 r2 = srec[j * 4 + 2];  // C2 zA zB zC
      const float4 r3 = srec[j * 4 + 3];  // id xlo xhi pad
      bool in_x = true;
      if (WITH_XRANGE) in_x = (px >= r3.y) && (px < r3.z);
      const float a0 = __fmul_rn(r0.x, px);
      const float a1 = __fmul_rn(r0.y, px);
      const float a2 = __fmul_rn(r0.z, px);
      const float az = __fmul_rn(r2.y, px);
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const float e0 = plane(a0, r0.w, py[k], r1.z);
        const float e1 = plane(a1, r1.x, py[k], r1.w);
        const float e2 = plane(a2, r1.y, py[k], r2.x);
        const float z = plane(az, r2.z, py[k], r2.w);
        // NaN-safe: every comparison with NaN is false, as jnp.minimum
        // followed by >= 0 is in the Pallas kernel
        const bool hit = in_x && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                         z >= 0.0f && z <= 1.0f && z < best_z[k];
        if (hit) {
          best_z[k] = z;
          if (WITH_IDS) best_id[k] = static_cast<int>(r3.x);
        }
      }
    }
  }

  const int col = tile_x * TILE_W + t % TILE_W;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int row = tile_y * TILE_H + k * ROW_STEP + t / TILE_W;
    if (row < height && col < width) {
      const size_t o = static_cast<size_t>(row) * width + col;
      depth[o] = best_z[k];
      if (WITH_IDS) tid[o] = best_id[k];
    }
  }
}

template <bool WITH_IDS, bool WITH_XRANGE>
void launch(const void* records, const void* starts, const void* counts,
            int tile_offset, int grid_tiles, int ntx, int width,
            int height, void* depth, void* tid, cudaStream_t stream) {
  raster_tiles_kernel<WITH_IDS, WITH_XRANGE>
      <<<grid_tiles, THREADS, 0, stream>>>(
          static_cast<const float4*>(records),
          static_cast<const int*>(starts), static_cast<const int*>(counts),
          tile_offset, ntx, width, height, static_cast<float*>(depth),
          static_cast<int*>(tid));
}

}  // namespace

// Plain C entry point bound with ctypes (ops/raster.py). Launches
// grid_tiles blocks on keys [tile_offset, tile_offset + grid_tiles) into a
// (height, width) output, height <= (grid_tiles / ntx) * 8; the wrapper
// has checked that the keys exist. tid == nullptr selects the depth-only
// variant. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a malformed grid without launching.
extern "C" int crychic_raster(const void* records, const void* starts,
                              const void* counts, int tile_offset,
                              int grid_tiles, int ntx, int width,
                              int height, void* depth, void* tid,
                              int with_xrange, void* stream) {
  if (tile_offset < 0 || grid_tiles <= 0 || ntx <= 0 ||
      grid_tiles % ntx != 0 || width <= 0 || width > ntx * TILE_W ||
      height <= 0 || height > (grid_tiles / ntx) * TILE_H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tid != nullptr) {
    if (with_xrange)
      launch<true, true>(records, starts, counts, tile_offset, grid_tiles,
                         ntx, width, height, depth, tid, s);
    else
      launch<true, false>(records, starts, counts, tile_offset, grid_tiles,
                          ntx, width, height, depth, tid, s);
  } else {
    if (with_xrange)
      launch<false, true>(records, starts, counts, tile_offset, grid_tiles,
                          ntx, width, height, depth, tid, s);
    else
      launch<false, false>(records, starts, counts, tile_offset,
                           grid_tiles, ntx, width, height, depth, tid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_raster_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
