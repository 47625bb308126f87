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
// At each pixel centre (column + 0.5, row + 0.5) a record covers when all
// three edge values are >= 0 (and, in atlas mode, the centre lies in
// [xlo, xhi)) and its depth z lies in [0, 1]. The pixel keeps the
// smallest z (clear 1.0, strict <) and the id that gave it. Ids in a run
// are strictly ascending (stable sort), so updating with a strict < in
// run order hands exact-z ties to the smallest id — the Pallas kernel's
// rule (min id within a block, earliest block across).
//
// Arithmetic. Each plane is evaluated as ((A*px) + (B*py)) + C with every
// operation rounded on its own (__fmul_rn/__fadd_rn, and the file is
// built with -fmad=false), which is how eager PyTorch evaluates the plain
// version (ops/raster.py rasterize_plain). The two are therefore equal
// bit for bit on the card.
//
// Work split. One block of 256 threads per tile. Warp w owns the 16x8
// rectangle of columns 16w .. 16w + 15, all 8 rows; its lane l owns the
// four pixels of column 16w + l % 16 in rows 4 * (l / 16) .. + 3, with
// best z and best id in registers. The tile's run is staged through
// shared memory in chunks of 128 records (8 KB), loaded cooperatively as
// float4 so the loads coalesce. Output goes straight into the (H, W)
// planes; the ragged right and bottom tiles are masked, and empty tiles
// write the clears.
//
// Warp-level reject. Most (record, warp) pairs cannot cover a pixel: on
// config 4's 1080p frame only 18.5% of the atlas's and 24.7% of the main
// view's (record, warp) evaluations of the former layout (32 columns x 4
// alternate rows) had a covered pixel, and only 1.9% / 4.9% of the pixel
// tests hit. So each warp first decides, for 32 records at a time (lane l
// takes record g + l), whether the record can cover any pixel of the
// warp's rectangle, from the record's planes and the rectangle alone;
// __ballot_sync gathers the verdicts into a warp-uniform mask, and the
// warp then evaluates the live records, in run order, with all lanes
// (a 16x8 rectangle leaves fewer records live than a 32x4 one:
// tests/test_torch_raster.py reports the shares). A record is rejected
// when
//   (a) atlas: all 16 column centres lie outside [xlo, xhi) (the largest
//       centre < xlo, or the smallest >= xhi). Exact: the kernel compares
//       the centres with the guard itself;
//   (b) for some edge, M < -m, where M is ((A*x) + (B*y)) + C at the
//       rectangle's corner that maximises the plane (x the largest centre
//       if A >= 0 else the smallest; y likewise with B) and m =
//       2^-20 * (|A|*128 + |B|*8 + |C|) + 2^-120;
//   (c) the depth plane's maximum over the rectangle is < -m (every z < 0)
//       or its minimum is > 1 + m (every z > 1), with m of (zA, zB, zC).
// Why (b) and (c) are conservative under rounding. The rectangle holds
// every pixel centre of the warp, so the exact plane at any of them is at
// most its exact value at the maximising corner. A centre has |x| <= 128
// and |y| <= 8 in tile-local coordinates, so the rounded
// ((A*x) + (B*y)) + C differs from the exact value by at most
// 3.01 * 2^-24 * (|A|*128 + |B|*8 + |C|), for the pixel and for the
// corner alike (the 2^-120 covers underflow). m bounds twice that with a
// factor of 2 to spare, so M < -m makes every pixel's rounded edge value
// negative, and the pixel's ">= 0" test fails (a rounded -0.0 cannot
// arise: the value is below -m/2). The same holds for z against 0 and 1
// (a minimum > fl(1 + m) is at least 1 + m + half an ulp). Besides, the
// corners are pixel centres and each rounded operation is monotone, so
// the rounded plane at the maximising corner is already the largest
// rounded value over the rectangle: the margin is a second guard. A NaN
// or an infinity in a plane makes every comparison false or the margin
// infinite, so such a record is never rejected and is evaluated as
// before. Records that pass are evaluated exactly as in the plain
// version, so the kernel stays bit-equal to rasterize_plain; ops/raster.py
// warp_rejects mirrors the predicate, and tests/test_torch_raster.py
// holds that no rejected (record, warp) has a covered pixel.
//
// What bounds it. Per pixel and record the function needs 8 f32 adds and
// 6 compares (A*px is shared down a column, B*py along a row), with 64
// bytes of record per 1024 pixels (chip_smoke.py RASTER_OPS_PER_PAIR):
// f32 issue, not bytes. Without the reject every warp issued ~96
// instructions per thread for every record of its tile's run, ~257M warp
// instructions for the atlas (334,444 records x 8 warps), ~0.28 ms at
// 132 SMs x 4 schedulers x ~1.75 GHz: the 0.37 ms it took on an H100 SXM
// at 700 W was issue of work that mostly could not hit. With the reject
// a warp spends ~70 lane instructions per 32 records on the test and
// ~96 per live record; on config 4's 1080p frame it skips 85.9% of the
// atlas's (record, warp) pairs (11.9% have a covered pixel) and 75.3% of
// the main view's (18.2%), and the atlas launch took 0.119 ms on the
// same card, the main view 0.026 (experiments/kernel_ab_probe.py). It
// is not load imbalance: the heaviest atlas run has 386 records (p99
// 218, mean 20.4), the heaviest main-view run 273. Staging with cp.async
// or TMA is left out: a run is at most 4 chunks of 128 records at 1080p,
// so there is little load latency to hide behind the evaluation.
//
// Field-major records (K4). raster_tiles_field_kernel is the same
// function on the records in the layout the Pallas kernels DMA
// (experiments/fma_kernel_probe.py _fma_kernel, layout 't',
// records_hbm.at[:, blk, :]): a (16, P) f32 array, field k of pair j at
// k * P + j, P a multiple of 128. A tile's run is staged in whole aligned
// 128-record blocks, as the Pallas kernel walks blocks: 16 coalesced rows
// of 128 floats, loaded as float4, 2 per thread, the block's records
// outside the run skipped. Field k of record j is then srec[k * 128 + j].
// The reject, the arithmetic and the run order are the pair-major
// kernel's (one device loop serves both), so it equals rasterize_plain
// bit for bit too. The TPU's tiles_per_prog (tiles per grid step) has no
// counterpart: one block per tile, as K1.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 128;
constexpr int TILE_H = 8;
constexpr int THREADS = 256;
constexpr int WARP_W = 16;   // a warp's rectangle: 16 columns x TILE_H rows
constexpr int PIX = 4;       // pixels per thread: 4 rows of one column
constexpr int CHUNK = 128;   // records per smem stage
constexpr int REC_ROWS = 16; // f32 fields per record
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float plane(float apx, float b, float py,
                                       float c) {
  return __fadd_rn(__fadd_rn(apx, __fmul_rn(b, py)), c);
}

// One record's fields: edges A, B, C (tile-local C), the depth plane
// zA, zB, zC, the id and the column guard [xlo, xhi).
struct Rec {
  float A0, A1, A2, B0, B1, B2, C0, C1, C2, zA, zB, zC, id, xlo, xhi;
};

// Record j of a pair-major chunk in shared memory: 4 float4 per record.
struct PairMajor {
  const float4* s;
  __device__ __forceinline__ Rec operator()(int j) const {
    const float4 r0 = s[j * 4 + 0];  // A0 A1 A2 B0
    const float4 r1 = s[j * 4 + 1];  // B1 B2 C0 C1
    const float4 r2 = s[j * 4 + 2];  // C2 zA zB zC
    const float4 r3 = s[j * 4 + 3];  // id xlo xhi pad
    return {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w,
            r2.x, r2.y, r2.z, r2.w, r3.x, r3.y, r3.z};
  }
};

// Record j of a field-major block in shared memory: field k at k*128 + j.
struct FieldMajor {
  const float* s;
  __device__ __forceinline__ Rec operator()(int j) const {
    return {s[0 * CHUNK + j],  s[1 * CHUNK + j],  s[2 * CHUNK + j],
            s[3 * CHUNK + j],  s[4 * CHUNK + j],  s[5 * CHUNK + j],
            s[6 * CHUNK + j],  s[7 * CHUNK + j],  s[8 * CHUNK + j],
            s[9 * CHUNK + j],  s[10 * CHUNK + j], s[11 * CHUNK + j],
            s[12 * CHUNK + j], s[13 * CHUNK + j], s[14 * CHUNK + j]};
  }
};

// A warp's rectangle of pixel centres, tile-local: x in [x0, x1], y in
// [y0, y1].
struct Rect {
  float x0, x1, y0, y1;
  __device__ __forceinline__ explicit Rect(int warp)
      : x0(static_cast<float>(warp * WARP_W) + 0.5f),
        x1(static_cast<float>(warp * WARP_W + WARP_W - 1) + 0.5f),
        y0(0.5f),
        y1(static_cast<float>(TILE_H - 1) + 0.5f) {}
};

// The bound on twice the rounding error of a plane at a pixel centre
// (see "Warp-level reject" above).
__device__ __forceinline__ float margin(float a, float b, float c) {
  return __fadd_rn(
      __fmul_rn(0x1p-20f,
                __fadd_rn(__fadd_rn(__fmul_rn(fabsf(a), 128.0f),
                                    __fmul_rn(fabsf(b), 8.0f)),
                          fabsf(c))),
      0x1p-120f);
}

// The plane at the rectangle's corner that maximises it (hi) or minimises
// it, rounded as a pixel's value is.
__device__ __forceinline__ float corner(float a, float b, float c,
                                        const Rect& q, bool hi) {
  const float x = ((a >= 0.0f) == hi) ? q.x1 : q.x0;
  const float y = ((b >= 0.0f) == hi) ? q.y1 : q.y0;
  return plane(__fmul_rn(a, x), b, y, c);
}

__device__ __forceinline__ bool edge_out(float a, float b, float c,
                                         const Rect& q) {
  return corner(a, b, c, q, true) < -margin(a, b, c);
}

// False only if the record covers no pixel of the rectangle: (a) the
// column guard, (b) the edges, (c) the depth range.
template <bool WITH_XRANGE>
__device__ __forceinline__ bool may_cover(const Rec& r, const Rect& q) {
  bool out = false;
  if (WITH_XRANGE) out = (q.x1 < r.xlo) | (q.x0 >= r.xhi);
  out |= edge_out(r.A0, r.B0, r.C0, q);
  out |= edge_out(r.A1, r.B1, r.C1, q);
  out |= edge_out(r.A2, r.B2, r.C2, q);
  const float mz = margin(r.zA, r.zB, r.zC);
  out |= corner(r.zA, r.zB, r.zC, q, true) < -mz;
  out |= corner(r.zA, r.zB, r.zC, q, false) > __fadd_rn(1.0f, mz);
  return !out;
}

// The thread's pixel centres and best depth / id, clears in place.
struct Pixels {
  float px;
  float py[PIX];
  float best_z[PIX];
  int best_id[PIX];

  __device__ __forceinline__ Pixels(int warp, int lane) {
    px = static_cast<float>(warp * WARP_W + lane % WARP_W) + 0.5f;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      py[k] = static_cast<float>(lane / WARP_W * PIX + k) + 0.5f;
      best_z[k] = 1.0f;
      best_id[k] = -1;
    }
  }

  // One record against the four pixels.
  template <bool WITH_IDS, bool WITH_XRANGE>
  __device__ __forceinline__ void test(const Rec& r) {
    bool in_x = true;
    if (WITH_XRANGE) in_x = (px >= r.xlo) && (px < r.xhi);
    const float a0 = __fmul_rn(r.A0, px);
    const float a1 = __fmul_rn(r.A1, px);
    const float a2 = __fmul_rn(r.A2, px);
    const float az = __fmul_rn(r.zA, px);
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const float e0 = plane(a0, r.B0, py[k], r.C0);
      const float e1 = plane(a1, r.B1, py[k], r.C1);
      const float e2 = plane(a2, r.B2, py[k], r.C2);
      const float z = plane(az, r.zB, py[k], r.zC);
      // NaN-safe: every comparison with NaN is false, as jnp.minimum
      // followed by >= 0 is in the Pallas kernel
      const bool hit = in_x && e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                       z >= 0.0f && z <= 1.0f && z < best_z[k];
      if (hit) {
        best_z[k] = z;
        if (WITH_IDS) best_id[k] = static_cast<int>(r.id);
      }
    }
  }

  // Records [j0, j1) of the staged chunk, in order: each group of 32 is
  // tested against the warp's rectangle one record per lane, and the
  // live ones are evaluated by the whole warp. j0, j1 are block-uniform.
  template <bool WITH_IDS, bool WITH_XRANGE, class Load>
  __device__ __forceinline__ void run(const Load& load, const Rect& q,
                                      int lane, int j0, int j1) {
    for (int g = j0; g < j1; g += 32) {
      const int j = g + lane;
      // past the run a lane reads the last record and votes dead
      const bool live =
          may_cover<WITH_XRANGE>(load(min(j, j1 - 1)), q) && j < j1;
      unsigned mask = __ballot_sync(FULL, live);
      while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        test<WITH_IDS, WITH_XRANGE>(load(g + b));
      }
    }
  }

  // Output tile (tile_x, tile_y) into the (height, width) planes, masked
  // at the ragged right and bottom edges.
  template <bool WITH_IDS>
  __device__ __forceinline__ void store(int warp, int lane, int tile_x,
                                        int tile_y, int width, int height,
                                        float* depth, int* tid) const {
    const int col = tile_x * TILE_W + warp * WARP_W + lane % WARP_W;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int row = tile_y * TILE_H + lane / WARP_W * PIX + k;
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
  const int warp = t / 32;
  const int lane = t % 32;
  const Rect q(warp);
  Pixels p(warp, lane);

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk has been consumed
    const float4* src = records + static_cast<size_t>(start + base) * 4;
    for (int i = t; i < n * 4; i += THREADS) srec[i] = src[i];
    __syncthreads();
    p.run<WITH_IDS, WITH_XRANGE>(PairMajor{srec}, q, lane, 0, n);
  }
  p.store<WITH_IDS>(warp, lane, tile % ntx, tile / ntx, width, height,
                    depth, tid);
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
  const int warp = t / 32;
  const int lane = t % 32;
  const Rect q(warp);
  Pixels p(warp, lane);

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
      p.run<WITH_IDS, WITH_XRANGE>(FieldMajor{srec}, q, lane,
                                   max(start - blk * CHUNK, 0),
                                   min(end - blk * CHUNK, CHUNK));
    }
  }
  p.store<WITH_IDS>(warp, lane, tile % ntx, tile / ntx, width, height,
                    depth, tid);
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
