"""Render configuration.

Replaces the reference's compile-time constants (gNumFrameResources,
shadow resolution, cascade radii, blur count, deferred/culling toggles —
CRYCHIC.h:20-21,188-189, CRYCHIC.cpp:49,221) with one
dataclass.

The PyTorch port carries the JAX package's RenderConfig over field for
field, so scenes_baseline and every caller port unchanged. What the fields
mean here:

- Every rendering setting renders as in the JAX package: deferred or
  forward, PBR or Blinn-Phong (directional, point and spot lights), the
  alpha-tested layer, and the render options.
- use_pallas selects the raster path, as in the JAX package: True (the
  default) the CUDA raster kernels of ops.raster (their plain PyTorch
  versions for CPU tensors), False the JAX package's pure-XLA path, the
  binned tensor raster of ops.rasterizer on 32-row tiles, per cascade
  for the shadow maps. bin_cap and shadow_bin_cap are that path's
  per-tile caps (the Renderer sizes them; a longer run is truncated and
  flagged). The port keeps use_pallas as given on every device.
  pallas_interpret has no meaning in the port (the kernels have no
  interpret mode; CPU tensors take their plain versions).
- shade_tile_capacity and ssao_tile_capacity mean what they mean in the
  JAX package: the slots of the tile-compacted resolve and PCF factor,
  in (8, 128) tiles, and of the compacted SSAO occlusion, in (8, 32)
  half-res tiles; None is the dense pass. Renderer sizes both; the
  band-sharded frame stays dense.
- band_pair_capacity and shadow_band_pair_capacity are the per-rank pair
  capacities of the band-sharded frame (parallel/sharded.py), None for
  the full-frame capacities; autosize_band_capacities sizes them and
  check_band_capacity guards them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1920
    height: int = 1080
    shadow_map_size: int = 2048  # reference builds 4096 (CRYCHIC.cpp:49);
    # BASELINE.json's graded configs specify 2048^2
    num_cascades: int = 4
    ssao_enabled: bool = True
    ssao_blur_count: int = 3  # CRYCHIC.cpp:221
    shadows_enabled: bool = True
    deferred: bool = True  # CRYCHIC.h:189 isDeferred
    frustum_culling: bool = True  # CRYCHIC.h:188
    sky_enabled: bool = True
    # rasterizer sizing (static): capacity of the pair expansion and the
    # per-tile bin. Oversize for safety; overflow is reported by bin stats.
    pair_capacity: int = 1 << 19
    bin_cap: int = 1024
    shadow_pair_capacity: int = 1 << 19
    shadow_bin_cap: int = 512
    # lighting config (shader #defines in the reference)
    num_dir_lights: int = 3
    num_point_lights: int = 0
    num_spot_lights: int = 0
    use_pbr: bool = True  # PBRShading vs ComputeLighting (Default.hlsl:163-165)
    # max anisotropy for material texture sampling; the reference's static
    # samplers use D3D12_FILTER_ANISOTROPIC with MaxAnisotropy=8
    # (CRYCHIC.cpp:2631-2645). 1 = trilinear.
    anisotropy: int = 8
    # static probe count for the aniso sampler (gathers per pixel); probes
    # alternate mip levels, so 4 probes = the cost of plain trilinear of
    # two textures while covering an 8:1 footprint (see sample_pair_aniso).
    # With dual_mip_rows each probe is a full trilinear from ONE gather:
    # 2 dual probes measure equal to the legacy 4 alternating-mip probes
    # against the 8-probe reference-quality evaluator (config 5: 40.4 vs
    # 41.1 dB, fewer >2% pixels — experiments/aniso_quality.py) at HALF
    # the row gathers; 4 dual probes are the high-quality option (44.2 dB)
    aniso_probes: int = 2
    use_pallas: bool = True  # Pallas raster kernel (TPU) vs pure-XLA path
    # alpha-tested geometry (the reference's ALPHA_TEST shader variants,
    # Default.hlsl clip(diffuseAlbedo.a - 0.1), Shadows.hlsl:49-65).
    # TPU design: small-N dense rasterization with k depth peels — the
    # nearest fragment whose sampled alpha passes wins (see
    # passes.frame.alpha-test section). Off unless the scene carries an
    # alpha layer.
    alpha_test_enabled: bool = False
    alpha_peels: int = 2          # depth-peel iterations (clip recovery)
    alpha_clip: float = 0.1       # clip threshold (Default.hlsl:106)
    alpha_shadow_window: int = 512  # static light-space window per cascade
    # run Pallas kernels in interpreter mode (CPU tests of the kernel path)
    pallas_interpret: bool = False
    # debug views: None | "shadow_cascade3" (the reference's ShadowDebug.hlsl
    # quad) | "cascades" (the commented-out colorization, Default.hlsl:152)
    debug_view: str = None
    # the sky is the PROCEDURAL substitute (the reference's snowcube1024.dds
    # asset is missing, SURVEY.md §0): evaluate it analytically — zero
    # gathers, strictly less quantization than sampling the baked cubemap.
    # False = gather from DeviceScene.cubemap (file-loaded cubemaps).
    procedural_sky: bool = True
    # Poisson PCF disk radius in texels. None = the radius the reference
    # COMPILES to: `5 / width / 2.0f` (Common.hlsl:301) is an int/uint
    # division, i.e. 0.0 — all 16 taps coincide, one bilinear comparison
    # tap (ops.shadows.compiled_poisson_radius_uv; verified against the
    # scalar HLSL transliteration in tests/test_hlsl_oracle.py). 2.5
    # restores the soft disk the author evidently INTENDED (the float
    # value of 5/width/2 texels) — an enhancement, not parity.
    pcf_radius_texels: float = None
    # texture pool layout: dual-mip rows pack mip m AND its m+1 parent
    # quads in one 16-lane row, so a trilinear sample and EVERY aniso
    # probe pay ONE row gather instead of two, at 2x pool bytes
    # (ops.sampling.PairPool docstring; quantified vs the 16-probe
    # reference-quality evaluator in experiments/aniso_quality.py)
    dual_mip_rows: bool = True
    # performance knobs (defaults keep reference parity):
    # compute the cascade PCF factor at half resolution + bilinear upsample
    fast_shadow_factor: bool = False
    # SSAO resolution divisor (2 = the reference's half-res)
    ssao_scale: int = 2
    # tile-compacted shading: the resolve and the cascade PCF factor run
    # only on the (8, 128) tiles with a covered pixel, at most this many
    # (None = dense); the image does not change. Renderer autosizes it.
    shade_tile_capacity: int = None
    # the same for the SSAO occlusion, in (8, 32) half-res tiles within
    # the blurs' reach of a covered pixel; Renderer autosizes it.
    ssao_tile_capacity: int = None
    # per-rank pair capacities of the band-sharded frame (None = the
    # full-frame capacities; parallel.sharded.autosize_band_capacities)
    band_pair_capacity: int = None
    shadow_band_pair_capacity: int = None

    @property
    def ssao_width(self):
        return self.width // self.ssao_scale

    def fast_preset(self) -> "RenderConfig":
        """The JAX package's --fast performance preset: half-res PCF
        factor + bilinear upsample, quarter-res SSAO, and trilinear
        texturing."""
        return dataclasses.replace(self, fast_shadow_factor=True,
                                   ssao_scale=4, anisotropy=1)

    @property
    def ssao_height(self):
        return self.height // self.ssao_scale
