// Soft-disk shadow PCF kernel for Hopper (sm_90a): the 16-tap rotated
// Poisson filter with a 2.5-texel disk, RenderConfig.pcf_radius_texels.
//
// What it replaces. The JAX package evaluates this function in XLA as
// poisson_pcf_windowed's soft branch (crychic_renderer_tpu/ops/shadows.py
// :319, tap loop :423-457) and as the Pallas kernel make_kernel(mode).kern
// (experiments/pcf_probe.py:46, launched by run_kernel :117). Both read
// 16x16-texel "superwindows", a per-receiver gather table laid out for
// the TPU (superwindow_maps_u16, shadows.py:208); this kernel reads one
// window-ready copy of the 16-bit quantized maps instead, in which every
// receiver's superwindow is a 16x16 rectangle of the buffer.
//
// The window-ready map (ops/pcf.py quantize_map). A (C, S + 8, P) buffer
// of 16-bit depths: rows and columns 0..S-1 of cascade c are its map;
// rows S..S+7 repeat rows S-8..S-1, columns S..S+7 repeat columns
// S-8..S-1 (the corner block both), and columns S+8..P-1 are zero and
// never read. P, the row pitch in texels, is the least multiple of 16
// above S + 8 (ops/pcf.py window_pitch): 32-byte rows, the H100's
// texture pitch alignment. The superwindow's second block along each
// axis is min(q + 1, S/8 - 1), the clamp of superwindow_from_packed
// (shadows.py:197-205); at q = S/8 - 1 that is the last block again,
// which is what the padding holds. So window texel (wy, wx) of every
// receiver is buffer texel (8*qy0 + wy, 8*qx0 + wx) with no clamp in the
// address.
//
// What it computes, per (receiver, cascade) i, from the parameters
// params[k * m + i] that ops/pcf.py receiver_params prepares in PyTorch
// (k = 0..5: cx = u*S - 0.5, cy = v*S - 0.5, dq = z*65535 - 0.5, cos and
// sin of the rotation hash, the cascade index):
//   - the window: x_lo = floor(cx) - 3, qx0 = clip(x_lo >> 3, 0, S/8 - 1)
//     (the same for y); fx = cx - 8*qx0, fy = cy - 8*qy0.
//   - tap t of the disk sits at (fx + (px*c - py*s)*r, fy + (px*s +
//     py*c)*r). It adds relu(1 - |wx - tx|) * relu(1 - |wy - ty|) for each
//     of the <= 4 window texels under its tent whose 16-bit depth passes
//     dq <= texel. The 13 inner taps (|p| < 1.2) count only window rows
//     oy .. oy+7, oy = clip(y_lo - 8*qy0, 0, 7), with ty taken relative to
//     row oy (fy - oy + dy), as the JAX package's 8-row extraction does;
//     the 3 outer taps (1, 7 and 13) count all 16 rows.
//   - out[i] = sum / 16.
// Each weight is evaluated with every operation rounded on its own (the
// file is built with -fmad=false) and summed tap by tap, then (ky, kx),
// in the order of the plain version (ops/pcf.py soft_pcf_plain); a texel
// that does not count adds +0.0, which leaves the sum as it was (it
// starts at +0.0). So the two agree to the last bit on the card.
//
// Work split. i = 2 * pixel + slot (cascades.reshape(-1) in
// ops/shadows.py). Warp v of the grid takes slot v % 2 of the 32
// consecutive pixels 32 * (v / 2) ..: i = 2 * (32 * (v / 2) + lane) + v % 2.
// So a warp reads one cascade's map around 32 neighbouring receivers,
// where one thread per consecutive i read two maps 8 MB apart.
//
// Footprint fetches. A tap's 2x2 footprint is 2x2 neighbouring texels
// of the buffer, and one tex2Dgather fetches all four: the texture object
// views the buffer as a (C*(S+8)) x (S+8) 16-bit pitch-linear 2D texture
// with a pitch of 2*P bytes (point sampling, unnormalised coordinates,
// clamped at its edges), and the gather at (X + 1, Y + 1) returns texels
// (X, Y), (X+1, Y), (X, Y+1), (X+1, Y+1) as .w, .z, .x, .y; window row 0
// of cascade c is texture row c*(S+8) + 8*qy0. 16 fetches per receiver-
// cascade replace 64 scalar loads, for every receiver: the window masks
// (columns in [0, 16), the inner taps' 8 rows from oy) select the four
// weights without branches, and a texel outside the window (one the
// texture clamped, or one of the next cascade's rows) is fetched and
// masked away. A receiver with a non-finite or huge coordinate gets its
// window clamped to the map as any other and its taps masked.
//
// Texture objects. The eager C entry makes one at the first launch on a
// buffer's pointer and shape and caches it; the compiled frame
// (app/graphs.py) makes one per buffer it owns before its CUDA graph is
// captured and launches with it, so a graph never reads a cached object.
// The buffer's pitch (2*P bytes) and address must meet the card's
// texture pitch alignment and texture alignment (read once per device:
// 32 and 512 bytes on an H100); a buffer that does not is refused with
// an error, never read some other way. A buffer past the card's limits
// for pitch-linear textures (read once per device: 65,000 rows on an
// H100, so C*(S+8) > 65,000, four cascades from S = 16,248) gets no
// texture object, and only there the launch takes the scalar path,
// which reads the same texels of the buffer with the same addressing,
// four loads per tap.
//
// What bounds it. Per (receiver, cascade): 24 bytes of parameters in, 4
// bytes out, and the 28 f32 operations per tap that the function needs
// (two tap offsets and positions, two floors, the four bilinear weights,
// then per texel a product, a compare and an add), 460 with the window
// set-up (ops/pcf.py OPS_PER_RECEIVER), each rounded on its own. At 1080p
// that is 4.15M receiver-cascades, 116 MB of parameters and output plus
// the 32 MB map, against 1.9e9 operations: ~57 us at 33.5 T/s (the f32
// rate with every mul and add issued alone, half the 67 TFLOP/s that
// counts an FMA as two), more than the ~45 us of memory at 3.35 TB/s.
// The map fits in the 50 MB L2, so the first design (two cascades per
// warp, four 2-byte loads per tap behind data-dependent branches, ~265M
// texel loads at 1080p) was bound by load issue and L1 traffic, not DRAM:
// 0.372 ms on an H100 SXM at 700 W. This one issues one gather and ~55
// f32 and integer instructions per tap (the tap position, floors, masks,
// four tents and products, four selected adds), ~114M warp instructions
// at 1080p, ~0.12 ms at 132 SMs x 4 schedulers x ~1.75 GHz: it is bound
// by instruction issue, and ran in 0.161 ms on the same card
// (experiments/kernel_ab_probe.py). Before the window-ready map, the
// receivers whose window reached the map's last block, and every
// receiver of a map whose 2*S-byte rows missed the pitch alignment (S =
// 520), took the scalar path: config 4's 1080p receivers on 520^2 maps
// ran in 0.493 ms on that card. Comparing the texels with ceil(dq) as
// integers, to save their conversion to f32, made it no faster. A
// receiver's two cascades cannot share tap offsets: the rotation hash
// reads each cascade's own uv (ops/pcf.py receiver_params), so their
// angles differ. Skipping the receivers the frame discards (sky, no
// shadow, the second cascade of cascade-3 pixels: 51.8% of config 4's
// 1080p receiver-cascades, chip_smoke.py phase 7) is later work.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

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

// One receiver-cascade's window and parameters.
struct Receiver {
  float dq, c, s, fx, fy, fy_rel;
  int cascade, qx0, qy0, oy;
};

// Tap t's position (tx, ty) in the window (ty relative to row0), its
// row count and first window row.
struct Tap {
  float tx, ty, rows;
  int row0;
  __device__ __forceinline__ Tap(const Receiver& r, int t, float radius) {
    const bool outer = (OUTER_TAPS >> t) & 1u;
    const float px = kDiskX[t];
    const float py = kDiskY[t];
    const float dx = (px * r.c - py * r.s) * radius;
    const float dy = (px * r.s + py * r.c) * radius;
    tx = r.fx + dx;
    ty = (outer ? r.fy : r.fy_rel) + dy;
    rows = outer ? 16.0f : 8.0f;
    row0 = outer ? 0 : r.oy;
  }
};

// One gather per tap. rows = S + 8, the buffer's rows per cascade.
__device__ __forceinline__ float taps_gather(const Receiver& r,
                                             cudaTextureObject_t tex,
                                             int rows, float radius) {
  // texture row of window row 0 and column of window column 0; exact in
  // f32 (C*(S+8) <= the texture height limit < 2^24)
  const float row_base =
      static_cast<float>(r.cascade * rows + 8 * r.qy0);
  const float col_base = static_cast<float>(8 * r.qx0);
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < N_SAMPLE; ++t) {
    const Tap p(r, t, radius);
    const float x0 = floorf(p.tx);
    const float y0 = floorf(p.ty);
    const ushort4 q = tex2Dgather<ushort4>(
        tex, col_base + x0 + 1.0f,
        row_base + static_cast<float>(p.row0) + y0 + 1.0f, 0);
    const float y1 = y0 + 1.0f;
    const float x1 = x0 + 1.0f;
    const bool in_y0 = y0 >= 0.0f && y0 < p.rows;  // NaN-safe
    const bool in_y1 = y1 >= 0.0f && y1 < p.rows;
    const bool in_x0 = x0 >= 0.0f && x0 < 16.0f;
    const bool in_x1 = x1 >= 0.0f && x1 < 16.0f;
    const float wy0 = tent(y0, p.ty);
    const float wy1 = tent(y1, p.ty);
    const float wx0 = tent(x0, p.tx);
    const float wx1 = tent(x1, p.tx);
    acc += (in_y0 && in_x0 && r.dq <= static_cast<float>(q.w)) ? wy0 * wx0
                                                                : 0.0f;
    acc += (in_y0 && in_x1 && r.dq <= static_cast<float>(q.z)) ? wy0 * wx1
                                                                : 0.0f;
    acc += (in_y1 && in_x0 && r.dq <= static_cast<float>(q.x)) ? wy1 * wx0
                                                                : 0.0f;
    acc += (in_y1 && in_x1 && r.dq <= static_cast<float>(q.y)) ? wy1 * wx1
                                                                : 0.0f;
  }
  return acc;
}

// Scalar loads of the same texels, for a buffer past the card's texture
// limits: the plain version's reads, with the gather's addressing.
__device__ __forceinline__ float taps_scalar(const Receiver& r,
                                             const unsigned short* map,
                                             int rows, int pitch,
                                             float radius) {
  const unsigned short* win =
      map + (static_cast<size_t>(r.cascade) * rows + 8 * r.qy0) * pitch +
      8 * r.qx0;
  float acc = 0.0f;
  for (int t = 0; t < N_SAMPLE; ++t) {
    const Tap p(r, t, radius);
    const float x0 = floorf(p.tx);
    const float y0 = floorf(p.ty);
    for (int ky = 0; ky < 2; ++ky) {
      const float wyf = y0 + static_cast<float>(ky);
      if (!(wyf >= 0.0f && wyf < p.rows)) continue;  // NaN-safe
      const float wy = tent(wyf, p.ty);
      const unsigned short* row =
          win + static_cast<size_t>(static_cast<int>(wyf) + p.row0) * pitch;
      for (int kx = 0; kx < 2; ++kx) {
        const float wxf = x0 + static_cast<float>(kx);
        if (!(wxf >= 0.0f && wxf < 16.0f)) continue;
        const float texel =
            static_cast<float>(__ldg(row + static_cast<int>(wxf)));
        if (r.dq <= texel) acc += wy * tent(wxf, p.tx);
      }
    }
  }
  return acc;
}

// TEXTURE: every receiver through taps_gather; else (a buffer past the
// texture limits) through taps_scalar.
template <bool TEXTURE>
__global__ void __launch_bounds__(THREADS)
soft_pcf_kernel(cudaTextureObject_t tex,
                const unsigned short* __restrict__ map,
                const float* __restrict__ params, int m, int num_cascades,
                int size, int pitch, float radius, float* __restrict__ out) {
  const int v = (blockIdx.x * THREADS + threadIdx.x) / 32;  // grid warp
  const int lane = threadIdx.x % 32;
  const int i = 2 * (32 * (v / 2) + lane) + v % 2;
  if (i >= m) return;
  const size_t mm = static_cast<size_t>(m);
  const float cx = params[i];
  const float cy = params[mm + i];
  Receiver r;
  r.dq = params[2 * mm + i];
  r.c = params[3 * mm + i];
  r.s = params[4 * mm + i];
  r.cascade =
      min(max(static_cast<int>(params[5 * mm + i]), 0), num_cascades - 1);

  const int nb = size >> 3;
  const int x_lo = floor_sat(cx) - 3;
  const int y_lo = floor_sat(cy) - 3;
  r.qx0 = min(max(x_lo >> 3, 0), nb - 1);
  r.qy0 = min(max(y_lo >> 3, 0), nb - 1);
  r.oy = min(max(y_lo - 8 * r.qy0, 0), 7);
  r.fx = cx - static_cast<float>(8 * r.qx0);
  r.fy = cy - static_cast<float>(8 * r.qy0);
  r.fy_rel = r.fy - static_cast<float>(r.oy);

  const int rows = size + 8;
  float acc;
  if constexpr (TEXTURE)
    acc = taps_gather(r, tex, rows, radius);
  else
    acc = taps_scalar(r, map, rows, pitch, radius);
  out[i] = acc * (1.0f / N_SAMPLE);
}

// What the card allows a pitch-linear 2D texture, read at the device's
// first launch: its texturePitchAlignment and textureAlignment in bytes,
// and its maxTexture2DLinear width and height in texels and pitch in
// bytes.
struct TexLimits {
  int pitch_align, base_align, max_width, max_height, max_pitch;
};
constexpr int MAX_DEVICES = 64;
std::mutex tex_mutex;
TexLimits tex_limits[MAX_DEVICES] = {};

// The current device in *device and its limits in *lim. The caller holds
// tex_mutex.
cudaError_t device_limits(int* device, TexLimits* lim) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  TexLimits& l = tex_limits[*device];
  if (l.pitch_align == 0) {
    const cudaDeviceAttr attrs[5] = {
        cudaDevAttrTexturePitchAlignment, cudaDevAttrTextureAlignment,
        cudaDevAttrMaxTexture2DLinearWidth,
        cudaDevAttrMaxTexture2DLinearHeight,
        cudaDevAttrMaxTexture2DLinearPitch};
    int v[5];
    for (int k = 0; k < 5; ++k) {
      err = cudaDeviceGetAttribute(&v[k], attrs[k], *device);
      if (err != cudaSuccess) return err;
      if (v[k] <= 0) return cudaErrorInvalidValue;
    }
    l = {v[0], v[1], v[2], v[3], v[4]};
  }
  *lim = l;
  return cudaSuccess;
}

// Whether the (C, S + 8, P) buffer is read through a texture object:
// *use = 1 within the card's limits, 0 past them (the scalar path). A
// buffer within the limits whose pitch or address is off the card's
// texture alignment is an error (cudaErrorInvalidPitchValue,
// cudaErrorMisalignedAddress). The caller holds tex_mutex.
cudaError_t texture_plan(const void* map, int num_cascades, int size,
                         int pitch, int* device, int* use) {
  *use = 0;
  TexLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  const long long rows = size + 8;
  const long long pitch_bytes = 2LL * pitch;
  if (rows > lim.max_width || num_cascades * rows > lim.max_height ||
      pitch_bytes > lim.max_pitch)
    return cudaSuccess;
  if (pitch_bytes % lim.pitch_align != 0) return cudaErrorInvalidPitchValue;
  if (reinterpret_cast<uintptr_t>(map) % lim.base_align != 0)
    return cudaErrorMisalignedAddress;
  *use = 1;
  return cudaSuccess;
}

// A texture object viewing the buffer as a (C*(S+8)) x (S+8) 16-bit
// pitch-linear 2D texture of pitch 2*P bytes (see "Footprint fetches").
cudaError_t create_texture(const void* map, int num_cascades, int size,
                           int pitch, cudaTextureObject_t* tex) {
  cudaResourceDesc res = {};
  res.resType = cudaResourceTypePitch2D;
  res.res.pitch2D.devPtr = const_cast<void*>(map);
  res.res.pitch2D.desc = cudaCreateChannelDesc<unsigned short>();
  res.res.pitch2D.width = size + 8;
  res.res.pitch2D.height = static_cast<size_t>(num_cascades) * (size + 8);
  res.res.pitch2D.pitchInBytes = static_cast<size_t>(pitch) * 2;
  cudaTextureDesc desc = {};
  desc.addressMode[0] = cudaAddressModeClamp;
  desc.addressMode[1] = cudaAddressModeClamp;
  desc.filterMode = cudaFilterModePoint;
  desc.readMode = cudaReadModeElementType;
  desc.normalizedCoords = 0;
  return cudaCreateTextureObject(tex, &res, &desc, nullptr);
}

// The eager path's cache: texture objects over the buffers launched on so
// far, by device, pointer and shape. A texture object views the memory,
// not a copy, so a new map in the same allocation reads through the same
// object. When the cache is full the device is synchronised (no launch
// may still read an object) and every entry is destroyed: a rare event,
// since the caching allocator hands a frame loop the same few pointers.
// A CUDA graph must not read a cached object (a reset would destroy it
// under the graph, and the reset's synchronize cannot be captured): the
// compiled frame makes its own objects with crychic_soft_pcf_texture and
// destroys them with its graph.
struct TexEntry {
  int device, num_cascades, size, pitch;
  const void* map;
  cudaTextureObject_t tex;
};
constexpr int TEX_CACHE = 64;
TexEntry tex_cache[TEX_CACHE];
int tex_count = 0;
// how often the cache was full and reset (each a device synchronize)
int tex_fills = 0;

// The buffer's cached texture object in *tex and *has_tex = 1, or
// *has_tex = 0 past the card's texture limits.
cudaError_t map_texture(const void* map, int num_cascades, int size,
                        int pitch, cudaTextureObject_t* tex, int* has_tex) {
  *has_tex = 0;
  std::lock_guard<std::mutex> lock(tex_mutex);
  int device = 0, use = 0;
  cudaError_t err =
      texture_plan(map, num_cascades, size, pitch, &device, &use);
  if (err != cudaSuccess || !use) return err;
  for (int k = 0; k < tex_count; ++k) {
    const TexEntry& e = tex_cache[k];
    if (e.device == device && e.map == map &&
        e.num_cascades == num_cascades && e.size == size &&
        e.pitch == pitch) {
      *tex = e.tex;
      *has_tex = 1;
      return cudaSuccess;
    }
  }
  if (tex_count == TEX_CACHE) {
    ++tex_fills;
    err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return err;
    for (int k = 0; k < tex_count; ++k)
      cudaDestroyTextureObject(tex_cache[k].tex);
    tex_count = 0;
  }
  err = create_texture(map, num_cascades, size, pitch, tex);
  if (err != cudaSuccess) return err;
  tex_cache[tex_count++] = {device, num_cascades, size, pitch, map, *tex};
  *has_tex = 1;
  return cudaSuccess;
}

cudaError_t launch(cudaTextureObject_t tex, int has_tex, const void* map,
                   const void* params, int m, int num_cascades, int size,
                   int pitch, float radius, void* out, void* stream) {
  // a pair of warps (the two slots) per 32 pixels
  const int pixels = (m + 1) / 2;
  const int warps = 2 * ((pixels + 31) / 32);
  const int blocks = (warps * 32 + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned short* m16 = static_cast<const unsigned short*>(map);
  const float* p = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (has_tex)
    soft_pcf_kernel<true><<<blocks, THREADS, 0, st>>>(
        tex, m16, p, m, num_cascades, size, pitch, radius, o);
  else
    soft_pcf_kernel<false><<<blocks, THREADS, 0, st>>>(
        tex, m16, p, m, num_cascades, size, pitch, radius, o);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points bound with ctypes (ops/pcf.py). map: the (C, S +
// 8, pitch) window-ready 16-bit buffer (pitch in texels); params: (6, m)
// f32; out: (m,) f32.
//
// crychic_soft_pcf, the eager path: the buffer's texture object from the
// cache. Returns cudaGetLastError() after the launch (0 = launched), or,
// without launching, the error of reading the device's texture limits,
// of a pitch or address off its texture alignment, or of making the
// texture object. A buffer past the texture limits launches the scalar
// path.
extern "C" int crychic_soft_pcf(const void* map, const void* params, int m,
                                int num_cascades, int size, int pitch,
                                float radius, void* out, void* stream) {
  cudaTextureObject_t tex = 0;
  int has_tex = 0;
  const cudaError_t err =
      map_texture(map, num_cascades, size, pitch, &tex, &has_tex);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(tex, has_tex, map, params, m, num_cascades,
                                 size, pitch, radius, out, stream));
}

// A texture object over the buffer that the caller owns (*tex, *has_tex =
// 1), or *has_tex = 0 past the card's texture limits; it is not cached,
// and lives until crychic_soft_pcf_texture_destroy. The compiled frame
// makes one per map buffer it owns, before its CUDA graph is captured,
// and destroys it with the graph. Returns the error of crychic_soft_pcf's
// checks or of cudaCreateTextureObject (0 = made, or past the limits).
extern "C" int crychic_soft_pcf_texture(const void* map, int num_cascades,
                                        int size, int pitch,
                                        unsigned long long* tex,
                                        int* has_tex) {
  *tex = 0;
  *has_tex = 0;
  std::lock_guard<std::mutex> lock(tex_mutex);
  int device = 0, use = 0;
  cudaError_t err =
      texture_plan(map, num_cascades, size, pitch, &device, &use);
  if (err != cudaSuccess || !use) return static_cast<int>(err);
  cudaTextureObject_t t = 0;
  err = create_texture(map, num_cascades, size, pitch, &t);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tex = t;
  *has_tex = 1;
  return 0;
}

extern "C" int crychic_soft_pcf_texture_destroy(unsigned long long tex) {
  return static_cast<int>(cudaDestroyTextureObject(tex));
}

// The launch with a texture object of crychic_soft_pcf_texture (has_tex
// as it returned), on a buffer the caller owns: no cache, no allocation,
// no synchronize, so a CUDA graph can capture it.
extern "C" int crychic_soft_pcf_owned(unsigned long long tex, int has_tex,
                                      const void* map, const void* params,
                                      int m, int num_cascades, int size,
                                      int pitch, float radius, void* out,
                                      void* stream) {
  return static_cast<int>(launch(tex, has_tex, map, params, m, num_cascades,
                                 size, pitch, radius, out, stream));
}

// The current device's texture alignments and pitch-linear limits:
// out[0..4] = pitch alignment and address alignment in bytes, maximum
// width and height in texels, maximum pitch in bytes.
extern "C" int crychic_soft_pcf_limits(int* out) {
  std::lock_guard<std::mutex> lock(tex_mutex);
  int device = 0;
  TexLimits lim;
  const cudaError_t err = device_limits(&device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = lim.pitch_align;
  out[1] = lim.base_align;
  out[2] = lim.max_width;
  out[3] = lim.max_height;
  out[4] = lim.max_pitch;
  return 0;
}

// The number of times the texture cache was full since the library was
// loaded: each reset synchronized the device, which a frame loop that
// queues frames must never do.
extern "C" int crychic_soft_pcf_cache_fills() {
  std::lock_guard<std::mutex> lock(tex_mutex);
  return tex_fills;
}

extern "C" const char* crychic_soft_pcf_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
