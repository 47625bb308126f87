"""The port's image-quality scripts and gallery
(crychic_renderer_tpu_torch/experiments/{fast_quality,aniso_quality,
make_gallery}.py) against the repository's JAX scripts of the same names,
loaded by path, on the CPU.

- ``ssim``, ``psnr`` (and the Gaussian window and separable filter under
  them) and ``aniso_quality.metrics`` on seeded arrays: bit-equal.
- ``fast_quality``'s main logic, both scripts with ``--small --configs
  4`` on config 4 cut to half size first, so the run is 1/8 size (240x135,
  256^2 maps): PSNR within 0.5 dB, SSIM within 1e-3 and the share of
  pixels moved > 2% within 0.5 points of the JAX script's printed line.
  Measured, JAX / port: PSNR 20.34 / 20.34 dB, SSIM 0.9095 / 0.9094,
  moved 33.96% / 33.96%.
- ``aniso_quality``'s main logic on config 1 at its fixed 1/4 scale
  (200x150), all four schedules against the 8-probe reference, within
  the same tolerances (PSNR 0.5 dB; the shares > 5/255 and > 2/255 within
  0.5 points). The crate's WoodCrate01.dds is not in the repository
  (white 1x1 filters to the same image under every schedule), so both
  packages' load_texture_chains give that slot one seeded 256^2 noise
  chain. Measured: every printed number equal (legacy4 77.96 dB, dual2
  81.49, dual4 82.46, trilinear 71.14 with 0.0089% of pixels > 2/255).
- ``make_gallery.main(["--small", "--out", DIR])`` renders and writes the
  seven files the JAX script names (its ``captions`` and the two debug
  views of config 4), each at its config's size cut by 4 and in more
  than one colour.

Both JAX scripts render on the JAX Renderer, which turns use_pallas off
on the CPU (its XLA raster); the port's Renderer is handed
use_pallas=False for those runs too (as tests/test_torch_app_cli.py
does).
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest

from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu_torch import bench
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.experiments import aniso_quality as aq
from crychic_renderer_tpu_torch.experiments import fast_quality as fq
from crychic_renderer_tpu_torch.experiments import make_gallery as mg
from crychic_renderer_tpu_torch.io import dds
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_TOL = 0.5   # dB
SSIM_TOL = 1e-3
SHARE_TOL = 0.5  # percentage points


def _jax_script(name):
    """experiments/<name>.py of the JAX system, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_fq():
    return _jax_script("fast_quality")


@pytest.fixture(scope="module")
def jax_aq():
    return _jax_script("aniso_quality")


def _jax_main(main, argv):
    """A JAX script's main() run on `argv`; returns its printed lines."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [main.__module__, *argv])
        with contextlib.redirect_stdout(buf):
            main()
    return buf.getvalue().splitlines()


class _XlaRaster(tren.Renderer):
    """The port's Renderer on the JAX CPU Renderer's raster path."""

    def __init__(self, scene, cfg, **kw):
        super().__init__(scene, dataclasses.replace(cfg, use_pallas=False),
                         **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_bit_equal_to_jax_scripts(jax_fq, jax_aq, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((67, 93, 4)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.05, a.shape), 0.0, 1.1).astype(
        np.float32)
    np.testing.assert_array_equal(fq._gauss_kernel(),
                                  jax_fq._gauss_kernel())
    np.testing.assert_array_equal(
        fq._filter2_sep(a[..., 0].astype(np.float64), fq._gauss_kernel()),
        jax_fq._filter2_sep(a[..., 0].astype(np.float64),
                            jax_fq._gauss_kernel()))
    x, y = a[..., :3], b[..., :3]
    assert fq.ssim(x, y) == jax_fq.ssim(x, y)
    assert fq.psnr(x, y) == jax_fq.psnr(x, y)
    assert fq.psnr(x, x) == jax_fq.psnr(x, x) == float("inf")
    assert aq.metrics(b, a) == jax_aq.metrics(b, a)
    assert aq.metrics(a, a) == jax_aq.metrics(a, a)


def _half(configs, c):
    """CONFIGS[c] at half size with 1024^2 maps: --small makes it 1/8."""
    base = configs[c]

    def config():
        scene, cfg, lights = base()
        return scene, dataclasses.replace(
            cfg, width=cfg.width // 2, height=cfg.height // 2,
            shadow_map_size=1024), lights
    return config


_FQ_LINE = re.compile(r"config (\d): fast-vs-parity  PSNR +([\d.]+) dB   "
                      r"SSIM ([\d.]+)   pixels moved >2%: ([\d.]+)%")


def test_fast_quality_matches_jax_script(jax_fq, monkeypatch):
    monkeypatch.setitem(jsb.CONFIGS, 4, _half(jsb.CONFIGS, 4))
    monkeypatch.setitem(tsb.CONFIGS, 4, _half(tsb.CONFIGS, 4))
    monkeypatch.setattr(tren, "Renderer", _XlaRaster)
    lines = _jax_main(jax_fq.main, ["--small", "--configs", "4"])
    (c, psnr, ssim, moved), = [_FQ_LINE.match(x).groups() for x in lines]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = fq.main(["--small", "--configs", "4", "--device", "cpu"])
    row = rows[4]
    port_line, = buf.getvalue().splitlines()
    assert _FQ_LINE.match(port_line).groups() == (
        "4", f"{row['psnr']:.2f}", f"{row['ssim']:.4f}",
        f"{100 * row['moved']:.2f}")
    assert row["size"] == "240x135" and row["assets"] == "built in"
    print(f"fast vs parity, JAX / port: PSNR {psnr} / {row['psnr']:.2f} dB,"
          f" SSIM {ssim} / {row['ssim']:.4f}, moved {moved}% / "
          f"{100 * row['moved']:.2f}%")
    assert c == "4"
    assert abs(row["psnr"] - float(psnr)) <= PSNR_TOL
    assert abs(row["ssim"] - float(ssim)) <= SSIM_TOL
    assert abs(100 * row["moved"] - float(moved)) <= SHARE_TOL
    assert 0.0 < row["moved"] < 1.0


class _Stop(Exception):
    pass


def _stop():
    raise _Stop


def _crate_chains(real):
    """load_texture_chains with WoodCrate01 as one seeded noise chain."""
    rng = np.random.default_rng(7)
    crate = dds.generate_mips(rng.integers(0, 256, (256, 256, 4),
                                           dtype=np.uint8))

    def chains(names, asset_dir):
        out, anim = real(names, asset_dir)
        return [crate if n == "WoodCrate01" else c
                for n, c in zip(names, out)], anim
    return chains


_AQ_ROW = re.compile(r"  (.{34})  PSNR +([\d.]+) dB   >2% px ([\d.]+)%   "
                     r">0.8% px ([\d.]+)%")


def _aniso_rows(main, argv=None):
    """{schedule: (PSNR dB, % > 5/255, % > 2/255)} that an
    aniso_quality main printed for config 1 before config 5 stopped it."""
    buf = io.StringIO()
    with pytest.raises(_Stop), contextlib.redirect_stdout(buf):
        main() if argv is None else main(argv)
    return {m.group(1).strip(): tuple(float(v) for v in m.groups()[1:])
            for m in map(_AQ_ROW.match, buf.getvalue().splitlines()) if m}


def test_aniso_quality_matches_jax_script(jax_aq, monkeypatch):
    """Config 1 only: config 5 stops each script after config 1's rows."""
    monkeypatch.setattr(jren, "load_texture_chains",
                        _crate_chains(jren.load_texture_chains))
    monkeypatch.setattr(tren, "load_texture_chains",
                        _crate_chains(tren.load_texture_chains))
    monkeypatch.setitem(jsb.CONFIGS, 5, _stop)
    monkeypatch.setitem(tsb.CONFIGS, 5, _stop)
    monkeypatch.setattr(tren, "Renderer", _XlaRaster)
    # config 1 loads no file: no asset set to write
    monkeypatch.setattr(bench, "assets",
                        lambda small: contextlib.nullcontext(({}, None)))
    want = _aniso_rows(jax_aq.main)
    got = _aniso_rows(aq.main, ["--device", "cpu"])
    assert sorted(got) == sorted(want) and len(want) == 4
    for name, (psnr, f5, f2) in want.items():
        p, g5, g2 = got[name]
        print(f"{name}: JAX / port PSNR {psnr} / {p} dB, > 5/255 {f5}% / "
              f"{g5}%, > 2/255 {f2}% / {g2}%")
        assert abs(p - psnr) <= PSNR_TOL, name
        assert abs(g5 - f5) <= SHARE_TOL, name
        assert abs(g2 - f2) <= SHARE_TOL, name
    # the schedules filter the crate differently (equal images read
    # 120 dB, as config 1 does under a white 1x1 crate)
    assert got["trilinear (1 dual gather)"][0] < 100.0


def _png_size_and_spread(path):
    """(width, height) of a PNG and the number of distinct pixel bytes."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return (w, h), len(set(zlib.decompress(idat)))


GALLERY = {  # the JAX script's file names, by config
    1: ["config1_crate_forward.png"], 2: ["config2_skull_forward.png"],
    3: ["config3_deferred_lights.png"],
    4: ["config4_cascade_shadows_ssao.png", "config4_cascades.png",
        "config4_shadow_cascade3.png"],
    5: ["config5_full_scene.png"]}


def test_make_gallery_writes_the_jax_scripts_files(tmp_path):
    mg.main(["--small", "--out", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == sorted(
        name for names in GALLERY.values() for name in names)
    with bench.assets(True):  # configs 2, 3 and 5 read their meshes
        sizes = {c: (cfg.width // 4, cfg.height // 4)
                 for c, (_, cfg, _) in ((c, tsb.CONFIGS[c]())
                                        for c in GALLERY)}
    for c, names in GALLERY.items():
        for name in names:
            size, spread = _png_size_and_spread(tmp_path / name)
            assert size == sizes[c], name
            assert spread > 1, f"{name}: one colour"
