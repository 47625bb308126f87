"""The graft entry points on the port (torch counterpart of the
repository's ``__graft_entry__.py``).

- ``entry(device)``: the full deferred frame (``passes.frame.render_frame``
  with the cfg bound) and its example arguments, the device scene and the
  frame constants of a small cascade scene, on one device.
- ``dryrun_multichip(n, backend, device)``: the band-sharded frame
  (``parallel/sharded.py``) on n spawned ranks of one process group
  (``parallel/launch.render_sharded``, all legs in one job), in three legs,
  each held against ``render_frame`` of the same scene and constants,
  rebuilt in the caller from the leaves the ranks receive: at most 1e-3 of
  pixels with a max-RGB |diff| above 0.02 (``tests/test_multichip.py``'s
  bound).

  1. the pure-tensor raster (``use_pallas=False``) at 128x1080, whose
     1080 rows the bands do not divide (the band padding and cropping),
     with band capacities sized at these rows
     (``autosize_band_capacities``) and checked (``check_band_capacity``);
  2. the raster kernel's band launches (K3 on the card, its plain version
     on the CPU) at 256x72, the capacities sized again at the kernel's
     8-row tiles;
  3. with n >= 4 and even: 2 x n/2 replica groups (``make_mesh2``), two
     frames in flight, each against its own single frame.

  With ``cpu_check``, each leg's image is also held against
  ``render_frame`` on the CPU from the same leaves (at most 0.5% of
  pixels > 0.02, the bound between the card and the CPU path): on the
  card, the raster kernel's band launches against their plain versions.
  A leg that fails raises. NCCL runs one rank per card (rank r on
  ``cuda:r`` when the device names no index); gloo ranks share the
  device.

    python -c "from crychic_renderer_tpu_torch import graft_entry as g; \\
        g.dryrun_multichip(4, 'gloo', 'cpu')"
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .app.renderer import Renderer, resolve_device
from .config import RenderConfig
from .models.scene import build_cascade_scene
from .parallel import launch, sharded
from .passes import frame as fr

SHARD_FRAC = 1e-3  # share of pixels whose max-RGB |diff| exceeds 0.02
CPU_FRAC = 0.005  # the same share between the card and the CPU path


def _small_setup(width=256, height=128, shadow=128, device="cuda",
                 **cfg_kw):
    cfg = RenderConfig(
        width=width, height=height, shadow_map_size=shadow,
        pair_capacity=1 << 16, bin_cap=256,
        shadow_pair_capacity=1 << 16, shadow_bin_cap=256,
        use_pallas=False,
        **cfg_kw,
    )
    r = Renderer(build_cascade_scene(), cfg, device=device)
    return r, cfg


def entry(device="cuda"):
    """Returns (fn, example_args): fn(scene, consts) -> (H, W, 4) image."""
    r, _ = _small_setup(device=device)
    consts = r.frame_constants(0.0)
    fn = functools.partial(fr.render_frame, cfg=r.cfg)  # auto-sized caps
    return fn, (r.device_scene, consts)


def _single(scene, consts, cfg, device) -> np.ndarray:
    """render_frame on the scene and constants as the ranks rebuild them
    from their host leaves."""
    s = fr.DeviceScene.from_numpy(launch.host_leaves(scene), device,
                                  attach_statics=False)
    c = fr.FrameConstants.from_numpy(launch.host_leaves(consts), device)
    return fr.render_frame(s, c, cfg).cpu().numpy()


def _vs_single(what, outs, ref, bound) -> tuple:
    """Every rank of a group returned the same finite image, with no
    overflow, within `bound` of `ref`: (max |diff|, share > 0.02)."""
    img = outs[0]["img"]
    for rank, out in enumerate(outs):
        if out["overflowed"] or not np.array_equal(out["img"], img):
            raise AssertionError(f"{what}: rank {rank} overflowed or "
                                 f"returned another image")
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"{what}: image {img.shape}, want {ref.shape}, "
                             f"finite")
    diff = np.abs(img - ref).max(axis=-1)
    frac = float((diff > 0.02).mean())
    if not frac < bound:
        raise AssertionError(f"{what} mismatch {frac:.4f}")
    return float(diff.max()), frac


def dryrun_multichip(n_devices: int, backend: str = None, device="cuda",
                     cpu_check: bool = False) -> dict:
    """The three legs (module doc) on n_devices ranks; backend None picks
    NCCL on a CUDA device, gloo on the CPU. Prints one line per leg and
    returns {leg: (max |diff|, share of pixels > 0.02)}, with cpu_check
    also {leg + "_cpu": the same against the CPU path}, and "launches",
    the raster and soft PCF launches summed over the ranks and legs."""
    n = n_devices
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"

    # 1: 1080-row pure-tensor frame, band capacities at these rows
    r1, cfg1 = _small_setup(width=128, height=1080, shadow=128, device=dev)
    c1 = r1.frame_constants(0.0)
    band1 = sharded.autosize_band_capacities(r1.device_scene, c1, r1.cfg, n)
    sharded.check_band_capacity(r1.device_scene, c1, band1, n)

    # 2: the kernel band path; capacities sized again at the kernel's
    # 8-row tiles (the first autosize ran at the tensor raster's 32)
    r2, _ = _small_setup(width=256, height=72, shadow=128, device=dev)
    r2.cfg = dataclasses.replace(r2.cfg, use_pallas=True)
    r2._autosize_capacity()
    c2 = r2.frame_constants(0.0)
    consts = [c1, c2]
    runs = [(band1, 0, (0,)), (r2.cfg, 1, (1,))]

    # 3: 2 replicas x n/2 bands, each replica its own frame
    replicas = n >= 4 and n % 2 == 0
    if replicas:
        r2.camera.walk(1.0)
        r2.camera.rotate_y(0.05)
        consts.append(r2.frame_constants(0.5))
        runs.append((r2.cfg, 1, (1, 2)))

    ranks = launch.render_sharded([r1.device_scene, r2.device_scene], consts,
                                  runs, n, backend, dev)
    out = {}

    def hold(leg, what, outs, r, c):
        """outs against render_frame of (r's scene, c) on the device and,
        with cpu_check, on the CPU; returns the printed note."""
        d, f = out[leg] = _vs_single(what, outs,
                                     _single(r.device_scene, c, r.cfg, dev),
                                     SHARD_FRAC)
        note = f"max diff {d:.5f}, {f:.4%} of pixels > 0.02"
        if cpu_check:
            d, f = out[f"{leg}_cpu"] = _vs_single(
                f"{what} vs the CPU path", outs,
                _single(r.device_scene, c, r.cfg, "cpu"), CPU_FRAC)
            note += f"; vs the CPU path max diff {d:.5f}, {f:.4%}"
        return note

    img = ranks[0][0]["img"]
    if img.shape != (cfg1.height, cfg1.width, 4):
        raise AssertionError(f"xla 1080-row image {img.shape}")
    note = hold("xla_1080", "xla 1080-row band", [r[0] for r in ranks], r1,
                c1)
    print(f"dryrun_multichip({n}): xla 1080-row ok, image {img.shape}, "
          f"band_h {sharded.band_height(band1, n)}, {note}", flush=True)

    note = hold("pallas_band", "pallas band", [r[1] for r in ranks], r2, c2)
    print(f"dryrun_multichip({n}): pallas band ok, {note}", flush=True)

    if replicas:
        half = n // 2
        notes = [f"replica {i} " + hold(
            f"replica_{i}", f"replica {i}",
            [r[2] for r in ranks[i * half:(i + 1) * half]], r2, c)
            for i, c in enumerate((c2, consts[2]))]
        print(f"dryrun_multichip({n}): replica axis ok (2 x {half} mesh), "
              f"{'; '.join(notes)}", flush=True)

    out["launches"] = {k: sum(run["launches"][k] for r in ranks for run in r)
                       for k in ranks[0][0]["launches"]}
    return out
