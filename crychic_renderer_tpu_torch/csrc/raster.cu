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
//
// Field-major records (K4). raster_tiles_field_kernel is the same
// function on the records in the layout the Pallas kernels DMA
// (experiments/fma_kernel_probe.py _fma_kernel, layout 't',
// records_hbm.at[:, blk, :]): a (16, P) f32 array, field k of pair j at
// k * P + j, P a multiple of 128. A tile's run is staged in whole aligned
// 128-record blocks, as the Pallas kernel walks blocks: 16 coalesced rows
// of 128 floats, loaded as float4, 2 per thread, the block's records
// outside the run skipped. Each thread then reads field k of record j as
// the broadcast srec[k * 128 + j]: 12 scalar loads per record, 13 with
// the id and 14 with the column guard, where the pair-major kernel reads
// 4 float4. The arithmetic and run order are the pair-major kernel's, so
// it equals rasterize_plain bit for bit too. The TPU's tiles_per_prog
// (tiles per grid step) has no counterpart: one block per tile, as K1.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 128;
constexpr int TILE_H = 8;
constexpr int THREADS = 256;
constexpr int PIX = TILE_W * TILE_H / THREADS;  // pixels per thread: 4
constexpr int ROW_STEP = THREADS / TILE_W;      // 2
constexpr int CHUNK = 128;                      // records per smem stage
constexpr int REC_ROWS = 16;                    // f32 fields per record

__device__ __forceinline__ float plane(float apx, float b, float py,
                                       float c) {
  return __fadd_rn(__fadd_rn(apx, __fmul_rn(b, py)), c);
}

// The thread's pixel centres and best depth / id, clears in place.
struct Pixels {
  float px;
  float py[PIX];
  float best_z[PIX];
  int best_id[PIX];

  __device__ __forceinline__ explicit Pixels(int t) {
    px = static_cast<float>(t % TILE_W) + 0.5f;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      py[k] = static_cast<float>(k * ROW_STEP + t / TILE_W) + 0.5f;
      best_z[k] = 1.0f;
      best_id[k] = -1;
    }
  }

  // One record against the four pixels: edges A, B, C (tile-local C),
  // the depth plane zA, zB, zC, the id and the column guard [xlo, xhi).
  template <bool WITH_IDS, bool WITH_XRANGE>
  __device__ __forceinline__ void test(float A0, float A1, float A2,
                                       float B0, float B1, float B2,
                                       float C0, float C1, float C2,
                                       float zA, float zB, float zC,
                                       float id, float xlo, float xhi) {
    bool in_x = true;
    if (WITH_XRANGE) in_x = (px >= xlo) && (px < xhi);
    const float a0 = __fmul_rn(A0, px);
    const float a1 = __fmul_rn(A1, px);
    const float a2 = __fmul_rn(A2, px);
    const float az = __fmul_rn(zA, px);
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const float e0 = plane(a0, B0, py[k], C0);
      const float e1 = plane(a1, B1, py[k], C1);
      const float e2 = plane(a2, B2, py[k], C2);
      const float z = plane(az, zB, py[k], zC);
      // NaN-safe: every comparison with NaN is false, as jnp.minimum
      // followed by >= 0 is in the Pallas kernel
      const bool hit = in_x && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                       z >= 0.0f && z <= 1.0f && z < best_z[k];
      if (hit) {
        best_z[k] = z;
        if (WITH_IDS) best_id[k] = static_cast<int>(id);
      }
    }
  }

  // Output tile (tile_x, tile_y) into the (height, width) planes, masked
  // at the ragged right and bottom edges.
  template <bool WITH_IDS>
  __device__ __forceinline__ void store(int t, int tile_x, int tile_y,
                                        int width, int height, float* depth,
                                        int* tid) const {
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
};

template <bool WITH_IDS, bool WITH_XRANGE>
__global__ void __launch_bounds__(THREADS)
raster_tiles_kernel(const float4* __restrict__ records,
                    const int* __restrict__ starts,
                    const int* __restrict__ counts, int tile_offset,
                    int ntx, int width, int height,
                    float* __restrict__ depth, int* __restrict__ tid) {
  __shared__ float4 srec[CHUNK * 4];

  const int tile = blockIdx.x;  // position in the launch's grid
  const int start = starts[tile_offset + tile];
  const int count = counts[tile_offset + tile];
  const int t = threadIdx.x;
  Pixels p(t);

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
      p.test<WITH_IDS, WITH_XRANGE>(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                                    r1.z, r1.w, r2.x, r2.y, r2.z, r2.w,
                                    r3.x, r3.y, r3.z);
    }
  }
  p.store<WITH_IDS>(t, tile % ntx, tile / ntx, width, height, depth, tid);
}

template <bool WITH_IDS, bool WITH_XRANGE>
__global__ void __launch_bounds__(THREADS)
raster_tiles_field_kernel(const float* __restrict__ records, int n_pairs,
                          const int* __restrict__ starts,
                          const int* __restrict__ counts, int ntx,
                          int width, int height, float* __restrict__ depth,
                          int* __restrict__ tid) {
  __shared__ float4 sblk[REC_ROWS * CHUNK / 4];  // 16 rows of 128 floats
  const float* srec = reinterpret_cast<const float*>(sblk);

  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int end = start + counts[tile];
  const int t = threadIdx.x;
  Pixels p(t);

  if (end > start) {
    // the aligned 128-record blocks that hold [start, end), in order
    for (int blk = start / CHUNK; blk * CHUNK < end; ++blk) {
      __syncthreads();  // the previous block has been consumed
      const float* src = records + static_cast<size_t>(blk) * CHUNK;
      for (int i = t; i < REC_ROWS * CHUNK / 4; i += THREADS) {
        const int k = i / (CHUNK / 4);  // field row
        sblk[i] = reinterpret_cast<const float4*>(
            src + static_cast<size_t>(k) * n_pairs)[i % (CHUNK / 4)];
      }
      __syncthreads();

      const int j1 = min(end - blk * CHUNK, CHUNK);
      for (int j = max(start - blk * CHUNK, 0); j < j1; ++j) {
        p.test<WITH_IDS, WITH_XRANGE>(
            srec[0 * CHUNK + j], srec[1 * CHUNK + j], srec[2 * CHUNK + j],
            srec[3 * CHUNK + j], srec[4 * CHUNK + j], srec[5 * CHUNK + j],
            srec[6 * CHUNK + j], srec[7 * CHUNK + j], srec[8 * CHUNK + j],
            srec[9 * CHUNK + j], srec[10 * CHUNK + j],
            srec[11 * CHUNK + j], srec[12 * CHUNK + j],
            srec[13 * CHUNK + j], srec[14 * CHUNK + j]);
      }
    }
  }
  p.store<WITH_IDS>(t, tile % ntx, tile / ntx, width, height, depth, tid);
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

template <bool WITH_IDS, bool WITH_XRANGE>
void launch_field(const void* records, int n_pairs, const void* starts,
                  const void* counts, int grid_tiles, int ntx, int width,
                  int height, void* depth, void* tid, cudaStream_t stream) {
  raster_tiles_field_kernel<WITH_IDS, WITH_XRANGE>
      <<<grid_tiles, THREADS, 0, stream>>>(
          static_cast<const float*>(records), n_pairs,
          static_cast<const int*>(starts), static_cast<const int*>(counts),
          ntx, width, height, static_cast<float*>(depth),
          static_cast<int*>(tid));
}

bool malformed_grid(int grid_tiles, int ntx, int width, int height) {
  return grid_tiles <= 0 || ntx <= 0 || grid_tiles % ntx != 0 ||
         width <= 0 || width > ntx * TILE_W || height <= 0 ||
         height > (grid_tiles / ntx) * TILE_H;
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
  if (tile_offset < 0 || malformed_grid(grid_tiles, ntx, width, height))
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

// The field-major entry (K4): records a 16-byte aligned (16, n_pairs) f32
// array, n_pairs a multiple of 128; a full-screen grid of grid_tiles
// tiles. Otherwise as crychic_raster.
extern "C" int crychic_raster_field(const void* records, int n_pairs,
                                    const void* starts, const void* counts,
                                    int grid_tiles, int ntx, int width,
                                    int height, void* depth, void* tid,
                                    int with_xrange, void* stream) {
  if (n_pairs <= 0 || n_pairs % CHUNK != 0 ||
      malformed_grid(grid_tiles, ntx, width, height))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tid != nullptr) {
    if (with_xrange)
      launch_field<true, true>(records, n_pairs, starts, counts, grid_tiles,
                               ntx, width, height, depth, tid, s);
    else
      launch_field<true, false>(records, n_pairs, starts, counts,
                                grid_tiles, ntx, width, height, depth, tid,
                                s);
  } else {
    if (with_xrange)
      launch_field<false, true>(records, n_pairs, starts, counts,
                                grid_tiles, ntx, width, height, depth, tid,
                                s);
    else
      launch_field<false, false>(records, n_pairs, starts, counts,
                                 grid_tiles, ntx, width, height, depth, tid,
                                 s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_raster_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
