// Light-loop kernel K10 for Hopper (sm_90a): passes/frame.py's
// direct_light stage, the per-pixel light loops of the deferred and the
// forward lighting, in one launch a frame.
//
// What it replaces. No TPU kernel: the JAX package shades with XLA ops
// (crychic_renderer_tpu/ops/shading.py pbr_shading, compute_lighting),
// and the port ran the same functions as dense PyTorch ops over every
// pixel, each writing its (H, W, 3) or (H, W, 1) result to device memory:
// ~52 ops a light for Blinn-Phong over point lights (config 3's 16 point
// lights: ~833 ops, 13.5 ms of a 1080p frame), ~50 a light for PBR over
// the directional lights (3: ~150 ops, 3.9 ms). The plain version stays
// that PyTorch code (passes/frame.py direct_light_plain); the CPU takes
// it, and the card tests hold this kernel against it.
//
// Inputs: K7's (h, w, 16) G-buffer read in place (pos_w, normal_w,
// albedo, roughness, metalness and, on the forward path,
// shininess_alpha: one pixel's record is four float4 loads), the eye
// position, the (16, ...) light tables of the DeviceScene (staged in
// shared memory once per block), light 0's (h, w) shadow factor (any
// strides; null: unshadowed) and the optional (h, w) reach counts (any
// strides). Per pixel: the unit normal and view vectors, fresnel_r0 and
// the shininess as direct_light computes them, then the light loops with
// the BRDF a template parameter: PBR (shading.pbr_shading) over num_dir
// directional lights, light 0 taking sf ** 5; or Blinn-Phong
// (shading.compute_lighting) over num_dir directional, num_point point
// and num_spot spot lights, the light index running on across the three
// loops, light 0 taking sf. Out: one buffer of five contiguous planes,
// one after another: direct, normal, view, fresnel_r0 (h, w, 3 each) and
// shininess (h, w), the layout the plain version's tensors have, so the
// torch ops of the rest of the lighting read them as they read those (a
// pixel-record layout made them read strided views, ~0.35 ms a 1080p
// frame more).
//
// A local light past its falloff_end. The plain version evaluates every
// (light, pixel) pair and multiplies the contribution by the in-range
// mask (d <= falloff_end, LightingUtil.hlsl's
// `if (d > L.FalloffEnd) return 0`). Where d > falloff_end the mask is 0
// and the contribution is finite (every factor of it is: the unit light
// vector, the clamped n.l and attenuation, the Blinn-Phong term s / (s +
// 1) of a finite s), so it adds a signed zero to a sum that is never -0:
// this kernel skips such a pair and adds nothing, which leaves the same
// bits. A NaN distance fails both tests, so the pair is evaluated and
// multiplied by 0, as in the plain version. The reach count adds the
// mask of every local light, skipped or not, as compute_lighting's
// in_reach.add_ does.
//
// Same bits. Every operation is the plain version's, in its order and
// association, each rounded on its own (the file is built with
// -fmad=false): divisions as divisions, sqrtf, the clamps passing NaN
// through as torch's do, and the Python constants as torch rounds them
// to f32. Where PyTorch's own CUDA kernels evaluate a function other
// than as written, this file follows them (as csrc/resolve.cu and
// csrc/ssao.cu do):
//   - a sum over a last dimension of 3 (the dot products, the squared
//     lengths): (e0 + e2) + e1 from +0;
//   - a tensor divided by a Python number is multiplied by the f32
//     reciprocal of that number: albedo / PI, x / 8.0;
//   - x ** 5 is the scalar-exponent pow kernel's powf(x, 5.0f), x ** 2
//     its square x * x; a tensor exponent (n.h ** m, the spot power) is
//     powf;
//   - a - b and 1.0 - b are a + (-1) * b, the same rounding as a - b.
// So the five outputs and the reach counts equal the plain version's bit
// for bit on the card.
//
// What bounds it. At 1920x1080 the stage needs 44 bytes of each pixel's
// G-buffer record (4 more on the forward path, 4 more for a shadow
// factor) and writes 52: 199-207 MB, 0.059-0.062 ms at 3.35 TB/s (the
// kernel reads the whole 64-byte record: ~232-240 MB). Its
// arithmetic, each operation rounded on its own (a division, square
// root or pow counted once; chip_smoke.py's K10_*_OPS): 35 a pixel, 116
// per PBR light, 78 per Blinn-Phong directional light, 99 per point
// light in reach and 13 per one past it. Config 3 (16 point lights, 79%
// of all pixels' pairs in reach: a sky pixel's cleared position, the
// origin, lies within every light's reach) needs ~1,330 a pixel, 0.082
// ms at 33.5 T/s, so the operations bound it; config 4 (3 PBR lights)
// ~383, 0.024 ms, so the bytes do. A pow or a division is many
// instructions, and the one thread a pixel hides their latency across
// the warps of an SM. The loop's branch on the distance is coherent
// within a warp's 32 neighbouring pixels of a row.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LIGHTS = 16;
constexpr int THREADS = 256;
// the light table staged in shared memory: strength, direction and
// position (16 x 3 each), falloff_start, falloff_end, spot_power (16 each)
constexpr int TABLE_FLOATS = 3 * 3 * MAX_LIGHTS + 3 * MAX_LIGHTS;

// ops/shading.py's constants as torch rounds them to f32
constexpr float PI = static_cast<float>(3.1415926);
constexpr float DIELECTRIC_F0 = static_cast<float>(0.04);
constexpr float PBR_DOT_MIN = static_cast<float>(0.001);
constexpr float NORMALIZE_EPS = static_cast<float>(1e-20);
constexpr float DISTANCE_EPS = static_cast<float>(1e-8);

struct LightParams {
  const float4* gbuf;
  const float* eye;
  const float* strength;
  const float* direction;
  const float* position;
  const float* falloff_start;
  const float* falloff_end;
  const float* spot_power;
  const float* sf;
  long long sf_s0, sf_s1;
  float* reach;
  long long reach_s0, reach_s1;
  float* out;
  long long pixels;
  int w, num_dir, num_point, num_spot, deferred;
};

struct LightTable {
  float strength[MAX_LIGHTS][3];
  float direction[MAX_LIGHTS][3];
  float position[MAX_LIGHTS][3];
  float falloff_start[MAX_LIGHTS];
  float falloff_end[MAX_LIGHTS];
  float spot_power[MAX_LIGHTS];
};
static_assert(sizeof(LightTable) == TABLE_FLOATS * sizeof(float),
              "the light table is TABLE_FLOATS floats");

// one pixel's surface, as direct_light hands it to the light loops
struct Surface {
  float pos[3];
  float n[3];
  float v[3];
  float albedo[3];
  float r0[3];
  float roughness, metalness, shininess;
};

// torch.clamp / clamp_min: a NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// (a * b).sum(-1) over a last dimension of 3, as torch's CUDA reduction
// adds it
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return ((a[0] * b[0] + a[2] * b[2]) + a[1] * b[1]) + 0.0f;
}

// shading.normalize, in place
__device__ __forceinline__ void normalize3(float v[3]) {
  const float len = clamp_min(sqrtf(dot3(v, v)), NORMALIZE_EPS);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = v[c] / len;
}

// shading.pbr_brdf for the unit light direction ld: the BRDF into brdf,
// n.l returned
__device__ __forceinline__ float pbr_brdf(const Surface& s, const float ld[3],
                                          float brdf[3]) {
  float hv[3] = {s.v[0] + ld[0], s.v[1] + ld[1], s.v[2] + ld[2]};
  normalize3(hv);
  const float h_dot_v = clamp_min(dot3(hv, s.v), PBR_DOT_MIN);
  const float n_dot_l = clamp_min(dot3(s.n, ld), PBR_DOT_MIN);
  const float n_dot_h = clamp_min(dot3(s.n, hv), PBR_DOT_MIN);
  // _ndf_ggx
  const float a2 = s.roughness * s.roughness;
  const float d = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  const float D = a2 / (PI * d * d);
  // the reference's nDotv := hDotv (PBR.hlsl:58)
  const float n_dot_v = h_dot_v;
  // _geometry_smith on the true n.v
  const float ndv = clamp_min(dot3(s.n, s.v), PBR_DOT_MIN);
  const float rp1 = s.roughness + 1.0f;
  const float k = 0.125f * (rp1 * rp1);
  const float g1 = ndv / (ndv * (1.0f - k) + k);
  const float g2 = n_dot_l / (n_dot_l * (1.0f - k) + k);
  const float G = g1 * g2;
  // _fresnel_schlick's (1 - cos) ** 5, shared by the channels
  const float f5 = powf(clamp_nan(1.0f - n_dot_v, 0.0f, 1.0f), 5.0f);
  const float dg = 0.25f * D * G;
  const float denom = n_dot_l * n_dot_v;
  const float inv_pi = 1.0f / PI;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float F = s.r0[c] + (1.0f - s.r0[c]) * f5;
    const float fs = dg * F / denom;
    const float fd = s.albedo[c] * inv_pi;
    const float kd = (1.0f - F) * (1.0f - s.metalness);
    brdf[c] = kd * fd + F * fs;
  }
  return n_dot_l;
}

// shading._blinn_phong: the contribution of light strength ls along the
// unit light vector lv into out
__device__ __forceinline__ void blinn_phong(const Surface& s,
                                            const float ls[3],
                                            const float lv[3],
                                            float out[3]) {
  const float m = s.shininess * 256.0f;
  float hv[3] = {s.v[0] + lv[0], s.v[1] + lv[1], s.v[2] + lv[2]};
  normalize3(hv);
  const float n_dot_h = clamp_min(dot3(hv, s.n), 0.0f);
  const float roughness_factor =
      (m + 8.0f) * powf(n_dot_h, m) * (1.0f / 8.0f);
  // schlick_fresnel(r0, half_vec, light_vec)
  const float cos_t = clamp_nan(dot3(hv, lv), 0.0f, 1.0f);
  const float f5 = powf(1.0f - cos_t, 5.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float fres = s.r0[c] + (1.0f - s.r0[c]) * f5;
    float spec = fres * roughness_factor;
    spec = spec / (spec + 1.0f);
    out[c] = (s.albedo[c] + spec) * ls[c];
  }
}

// shading.compute_lighting's point (spot false) or spot light i, added
// to result; returns the in-range mask (d <= falloff_end) as 0 or 1
template <bool SPOT>
__device__ __forceinline__ float local_light(const LightTable& t, int i,
                                             const Surface& s,
                                             float result[3]) {
  float lv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) lv[c] = t.position[i][c] - s.pos[c];
  const float d = sqrtf(dot3(lv, lv));
  const float end = t.falloff_end[i];
  const float in_range = d <= end ? 1.0f : 0.0f;
  if (d > end) return in_range;  // adds exactly 0 (see the note above)
  const float dl = clamp_min(d, DISTANCE_EPS);
#pragma unroll
  for (int c = 0; c < 3; ++c) lv[c] = lv[c] / dl;
  const float n_dot_l = clamp_min(dot3(s.n, lv), 0.0f);
  // _attenuation
  const float att =
      clamp_nan((end - d) / (end - t.falloff_start[i]), 0.0f, 1.0f);
  float ls[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ls[c] = t.strength[i][c] * n_dot_l * att;
  if (SPOT) {
    const float neg[3] = {-lv[0], -lv[1], -lv[2]};
    const float spot =
        powf(clamp_min(dot3(neg, t.direction[i]), 0.0f), t.spot_power[i]);
#pragma unroll
    for (int c = 0; c < 3; ++c) ls[c] = ls[c] * spot;
  }
  float contrib[3];
  blinn_phong(s, ls, lv, contrib);
#pragma unroll
  for (int c = 0; c < 3; ++c) result[c] = result[c] + in_range * contrib[c];
  return in_range;
}

// One thread per pixel of the (h, w) grid.
template <bool PBR>
__global__ void __launch_bounds__(THREADS) light_kernel(LightParams p) {
  __shared__ LightTable t;
  float* flat = reinterpret_cast<float*>(&t);
  for (int i = threadIdx.x; i < TABLE_FLOATS; i += THREADS) {
    const float* src;
    int j = i;
    if (j < 3 * MAX_LIGHTS) {
      src = p.strength;
    } else if ((j -= 3 * MAX_LIGHTS) < 3 * MAX_LIGHTS) {
      src = p.direction;
    } else if ((j -= 3 * MAX_LIGHTS) < 3 * MAX_LIGHTS) {
      src = p.position;
    } else if ((j -= 3 * MAX_LIGHTS) < MAX_LIGHTS) {
      src = p.falloff_start;
    } else if ((j -= MAX_LIGHTS) < MAX_LIGHTS) {
      src = p.falloff_end;
    } else {
      j -= MAX_LIGHTS;
      src = p.spot_power;
    }
    flat[i] = src[j];
  }
  __syncthreads();

  const long long px =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (px >= p.pixels) return;
  const long long y = px / p.w;
  const long long x = px - y * p.w;

  // K7's record: pos_w, normal_w, normal_v, albedo, roughness, metalness,
  // shininess_alpha
  const float4 g0 = __ldg(p.gbuf + 4 * px);
  const float4 g1 = __ldg(p.gbuf + 4 * px + 1);
  const float4 g2 = __ldg(p.gbuf + 4 * px + 2);
  const float4 g3 = __ldg(p.gbuf + 4 * px + 3);

  Surface s;
  s.pos[0] = g0.x;
  s.pos[1] = g0.y;
  s.pos[2] = g0.z;
  s.n[0] = g0.w;
  s.n[1] = g1.x;
  s.n[2] = g1.y;
  normalize3(s.n);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.v[c] = __ldg(p.eye + c) - s.pos[c];
  normalize3(s.v);
  s.albedo[0] = g2.y;
  s.albedo[1] = g2.z;
  s.albedo[2] = g2.w;
  s.roughness = g3.y;
  s.metalness = g3.z;
  const float dielectric = DIELECTRIC_F0 * (1.0f - s.metalness);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    s.r0[c] = dielectric + s.albedo[c] * s.metalness;
  // deferred: gBuffer2.w == 1 (GBuffer.hlsl:28); forward: the normal
  // map's alpha (Default.hlsl:159)
  const float alpha = p.deferred ? 1.0f : g3.w;
  s.shininess = (1.0f - s.roughness) * alpha;
  const float sf =
      p.sf == nullptr ? 1.0f : __ldg(p.sf + y * p.sf_s0 + x * p.sf_s1);

  float result[3] = {0.0f, 0.0f, 0.0f};
  if (PBR) {
    for (int i = 0; i < p.num_dir; ++i) {
      const float ld[3] = {-t.direction[i][0], -t.direction[i][1],
                           -t.direction[i][2]};
      float brdf[3];
      const float n_dot_l = pbr_brdf(s, ld, brdf);
      const float sfi = i == 0 ? powf(sf, 5.0f) : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        result[c] =
            result[c] + sfi * brdf[c] * (t.strength[i][c] * n_dot_l);
    }
  } else {
    int i = 0;
    for (; i < p.num_dir; ++i) {
      const float lv[3] = {-t.direction[i][0], -t.direction[i][1],
                           -t.direction[i][2]};
      const float n_dot_l = clamp_min(dot3(s.n, lv), 0.0f);
      float ls[3], contrib[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ls[c] = t.strength[i][c] * n_dot_l;
      blinn_phong(s, ls, lv, contrib);
      const float sfi = i == 0 ? sf : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) result[c] = result[c] + sfi * contrib[c];
    }
    float reach = p.reach == nullptr
                      ? 0.0f
                      : p.reach[y * p.reach_s0 + x * p.reach_s1];
    const int points_end = p.num_dir + p.num_point;
    for (; i < points_end; ++i)
      reach = reach + local_light<false>(t, i, s, result);
    const int spots_end = points_end + p.num_spot;
    for (; i < spots_end; ++i)
      reach = reach + local_light<true>(t, i, s, result);
    if (p.reach != nullptr && p.num_point + p.num_spot > 0)
      p.reach[y * p.reach_s0 + x * p.reach_s1] = reach;
  }

  // the planes: a warp's 32 pixels write 384 contiguous bytes of each
  const long long plane = 3 * p.pixels;
  float* o = p.out + 3 * px;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = result[c];
    o[plane + c] = s.n[c];
    o[2 * plane + c] = s.v[c];
    o[3 * plane + c] = s.r0[c];
  }
  p.out[4 * plane + px] = s.shininess;
}

}  // namespace

// The light loops over the (h, w) G-buffer gbuf (K7's contiguous (h, w,
// 16) float buffer, 16-byte aligned) into out (13 * h * w floats: the
// planes direct, normal, view, fresnel_r0 (h, w, 3) and shininess (h,
// w), one after another). eye: 3 floats; strength, direction,
// position: (16, 3); falloff_start, falloff_end, spot_power: (16,);
// num_dir, num_point, num_spot: the light counts (at most 16 together;
// pbr reads num_dir only); pbr: 1 for PBRShading, 0 for Blinn-Phong;
// deferred: 1 takes shininess alpha 1, 0 the G-buffer's; sf: light 0's
// shadow factor at sf[y * sf_s0 + x * sf_s1] or null; reach: the reach
// counts at reach[y * reach_s0 + x * reach_s1] or null (strides in
// floats). Returns 0 or the CUDA error code of the refused launch
// (cudaErrorInvalidValue for malformed arguments).
extern "C" int crychic_light(
    const void* gbuf, int h, int w, const void* eye, const void* strength,
    const void* direction, const void* position, const void* falloff_start,
    const void* falloff_end, const void* spot_power, int num_dir,
    int num_point, int num_spot, int pbr, int deferred, const void* sf,
    long long sf_s0, long long sf_s1, void* reach, long long reach_s0,
    long long reach_s1, void* out, void* stream) {
  if (h <= 0 || w <= 0 || num_dir < 0 || num_point < 0 || num_spot < 0 ||
      num_dir + num_point + num_spot > MAX_LIGHTS ||
      reinterpret_cast<unsigned long long>(gbuf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LightParams p;
  p.gbuf = static_cast<const float4*>(gbuf);
  p.eye = static_cast<const float*>(eye);
  p.strength = static_cast<const float*>(strength);
  p.direction = static_cast<const float*>(direction);
  p.position = static_cast<const float*>(position);
  p.falloff_start = static_cast<const float*>(falloff_start);
  p.falloff_end = static_cast<const float*>(falloff_end);
  p.spot_power = static_cast<const float*>(spot_power);
  p.sf = static_cast<const float*>(sf);
  p.sf_s0 = sf_s0;
  p.sf_s1 = sf_s1;
  p.reach = static_cast<float*>(reach);
  p.reach_s0 = reach_s0;
  p.reach_s1 = reach_s1;
  p.out = static_cast<float*>(out);
  p.pixels = static_cast<long long>(h) * w;
  p.w = w;
  p.num_dir = num_dir;
  p.num_point = num_point;
  p.num_spot = num_spot;
  p.deferred = deferred;
  const long long blocks = (p.pixels + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pbr)
    light_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p);
  else
    light_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_light_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
