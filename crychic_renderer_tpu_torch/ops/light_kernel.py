"""The light-loop kernel K10 (``csrc/light.cu``): its wrapper. Its launches
count in the tally (ops/tally.py) under "light", one a frame.

``light`` computes passes/frame.direct_light, the light loops (PBR over
the directional lights, or Blinn-Phong over the directional, point and
spot lights) with the surface terms the rest of the lighting reads, over
every pixel in one launch, and writes them into one buffer as
contiguous planes (``OUTPUTS``), laid out as the plain version's
tensors. It reads K7's (H, W, 16) G-buffer in place: the buffer
``passes/frame.resolve_gbuffer`` returns on the card as "buffer", whose
channels its planes are views of. Its plain version is that PyTorch code
(``passes/frame.direct_light_plain``): ``passes/frame.direct_light``
takes it for CPU tensors and launches this for CUDA tensors. It reads
nothing on the host, so it runs inside the compiled frame's capture.
"""
from __future__ import annotations

import ctypes

import torch

from . import resolve
from .build import KernelLibrary

# the light table's rows (models/materials.MAX_LIGHTS): the kernel stages
# all of them in shared memory
MAX_LIGHTS = 16
# what the kernel writes: the channels of each (H, W, channels) plane,
# the planes one after another in one buffer
OUTPUTS = dict(direct=3, normal=3, view=3, fresnel_r0=3, shininess=1)
CHANNELS = sum(OUTPUTS.values())

_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary("light.cu", "crychic_light", {
    "crychic_light": ([_vp, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                       _ci, _ci, _ci, _ci, _ci, _vp, _cl, _cl, _vp, _cl,
                       _cl, _vp, _vp], _ci),
}, error="crychic_light_error")


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           contiguous: bool = True):
    if (t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != shape
            or (contiguous and not t.is_contiguous())):
        kind = "a contiguous" if contiguous else "a"
        raise ValueError(f"{name} must be {kind} {shape} float32 tensor on "
                         f"{device}; got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def _device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError("K10 runs on CUDA tensors; the CPU takes "
                         "passes/frame.direct_light_plain")
    return t.device


def light(gbuf: torch.Tensor, eye_pos: torch.Tensor, lights, use_pbr: bool,
          deferred: bool, shadow_factor: torch.Tensor = None,
          in_reach: torch.Tensor = None) -> dict:
    """Launch K10: direct_light's outputs for the G-buffer gbuf, a dict
    of contiguous (H, W, channels) planes of one buffer (OUTPUTS).

    gbuf: K7's contiguous (H, W, resolve.CHANNELS) float32 G-buffer,
    16-byte aligned (passes/frame._G_CLEAR's channels); eye_pos: (3,)
    float32; lights: the light tables (strength, direction, position
    (16, 3); falloff_start, falloff_end, spot_power (16,); float32,
    contiguous) with the counts num_dir, num_point, num_spot
    (passes/frame._LightsView); use_pbr:
    PBRShading over num_dir directional lights, else Blinn-Phong over
    all three kinds; deferred: shininess alpha 1, else the G-buffer's.
    shadow_factor: None or light 0's (H, W) factor, any strides; in_reach:
    None or (H, W, 1), any strides, to which each local light's in-range
    mask is added in place (Blinn-Phong only). Raises ValueError for
    anything else, CPU tensors, a G-buffer of separate planes (None) and
    more than MAX_LIGHTS lights included, and RuntimeError for a refused
    launch."""
    if gbuf is None:
        raise ValueError("K10 reads K7's (H, W, 16) G-buffer, "
                         "resolve_gbuffer's \"buffer\" on the card; a "
                         "G-buffer of separate planes takes "
                         "passes/frame.direct_light_plain")
    dev = _device(gbuf)
    if gbuf.dim() != 3:
        raise ValueError(f"gbuf must be (H, W, {resolve.CHANNELS}); got "
                         f"{tuple(gbuf.shape)}")
    H, W = gbuf.shape[:2]
    _check("gbuf", gbuf, (H, W, resolve.CHANNELS), dev)
    if gbuf.data_ptr() % 16:
        raise ValueError("K7's G-buffer must be 16-byte aligned")
    counts = (lights.num_dir,) if use_pbr else (
        lights.num_dir, lights.num_point, lights.num_spot)
    if min(counts) < 0 or sum(counts) > MAX_LIGHTS:
        raise ValueError(f"K10 takes 0 to {MAX_LIGHTS} lights; got "
                         f"{counts}")
    _check("eye_pos", eye_pos, (3,), dev)
    for name in ("strength", "direction", "position"):
        _check(name, getattr(lights, name), (MAX_LIGHTS, 3), dev)
    for name in ("falloff_start", "falloff_end", "spot_power"):
        _check(name, getattr(lights, name), (MAX_LIGHTS,), dev)
    sf_ptr, sf_strides = None, (0, 0)
    if shadow_factor is not None:
        _check("shadow_factor", shadow_factor, (H, W), dev, contiguous=False)
        sf_ptr, sf_strides = shadow_factor.data_ptr(), shadow_factor.stride()
    reach_ptr, reach_strides = None, (0, 0)
    if in_reach is not None:
        _check("in_reach", in_reach, (H, W, 1), dev, contiguous=False)
        reach_ptr, reach_strides = in_reach.data_ptr(), in_reach.stride()[:2]
    out = torch.empty(CHANNELS * H * W, dtype=torch.float32, device=dev)
    LIBRARY.launch(
        "crychic_light", dev, gbuf.data_ptr(), H, W, eye_pos.data_ptr(),
        lights.strength.data_ptr(), lights.direction.data_ptr(),
        lights.position.data_ptr(), lights.falloff_start.data_ptr(),
        lights.falloff_end.data_ptr(), lights.spot_power.data_ptr(),
        lights.num_dir, 0 if use_pbr else lights.num_point,
        0 if use_pbr else lights.num_spot, int(use_pbr), int(deferred),
        sf_ptr, *sf_strides, reach_ptr, *reach_strides, out.data_ptr(),
        key="light")
    planes, o = {}, 0
    for name, n in OUTPUTS.items():
        planes[name] = out[o * H * W:(o + n) * H * W].view(H, W, n)
        o += n
    return planes
