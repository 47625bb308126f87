"""The port's asset layer (io/dds, io/bc7, io/bc6h, io/mesh_txt,
io/snapshot, app/renderer.load_sky_cubemap) against the JAX package's, on
bytes the tests write themselves from seeded numpy: every decoder and
loader must give EQUAL arrays (np.array_equal, same dtype). The JAX
package decodes BC1-BC3 and parses meshes through its C++ helper when it
builds and through numpy otherwise; the port, which has only numpy, is
held against both paths.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from crychic_renderer_tpu import native as jnative
from crychic_renderer_tpu.app import renderer as jren
from crychic_renderer_tpu.io import bc6h as jbc6h
from crychic_renderer_tpu.io import bc7 as jbc7
from crychic_renderer_tpu.io import dds as jdds
from crychic_renderer_tpu.io import mesh_txt as jmesh
from crychic_renderer_tpu.io import snapshot as jsnap
from crychic_renderer_tpu.models import scenes_baseline as jsb
from crychic_renderer_tpu.ops import sampling as jsamp
from crychic_renderer_tpu_torch.app import renderer as tren
from crychic_renderer_tpu_torch.experiments import synthetic_assets as sa
from crychic_renderer_tpu_torch.io import bc6h, bc7, dds, mesh_txt, snapshot
from crychic_renderer_tpu_torch.models import scenes_baseline as tsb
from crychic_renderer_tpu_torch.ops import sampling as tsamp
from torch_threads import cap_torch_threads

cap_torch_threads()


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _rand(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8)


# -- block decoders ----------------------------------------------------------

BC = {  # name -> (port decoder, JAX decoders, bytes per block)
    "bc1": (dds.decode_bc1, (jdds.decode_bc1, jdds._decode_bc1_numpy), 8),
    "bc2": (dds.decode_bc2, (jdds.decode_bc2, jdds._decode_bc2_numpy), 16),
    "bc3": (dds.decode_bc3, (jdds.decode_bc3, jdds._decode_bc3_numpy), 16),
    "bc4": (dds.decode_bc4, (jdds.decode_bc4,), 8),
    "bc5": (dds.decode_bc5, (jdds.decode_bc5,), 16),
}


@pytest.mark.parametrize("name", sorted(BC))
def test_bc1_to_bc5_equal_jax(name):
    """256 random blocks, decoded at 62x18 (cropped edge blocks), equal to
    the JAX numpy decoder and to its default path (the C++ helper for
    BC1-BC3 where it builds)."""
    port, refs, nbytes = BC[name]
    w, h = 62, 18
    n = ((w + 3) // 4) * ((h + 3) // 4)
    data = _rand(sorted(BC).index(name), n * nbytes).tobytes()
    got = port(data, w, h)
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    for ref in refs:
        _eq(got, ref(data, w, h), f"{name} vs {ref.__name__}")


def test_bc1_to_bc3_default_path_is_native():
    """The JAX default path above is its C++ helper here (else the test
    above compared the numpy decoders only)."""
    assert jnative.get_lib() is not None


@pytest.mark.parametrize("mode", list(range(8)) + ["reserved"])
def test_bc7_equal_jax(mode):
    """256 random blocks of each BC7 mode, and reserved-mode blocks
    (transparent black)."""
    raw = _rand(40 + (mode if mode != "reserved" else 8),
                256 * 16).reshape(256, 16)
    if mode == "reserved":
        raw[:, 0] = 0
    else:
        raw[:, 0] = (raw[:, 0] >> (mode + 1) << (mode + 1)) | (1 << mode)
    got = bc7.decode_bc7_blocks(raw)
    _eq(got, jbc7.decode_bc7_blocks(raw), f"mode {mode} blocks")
    if mode == "reserved":
        assert (got == 0).all()
    data = raw.tobytes()
    _eq(bc7.decode_bc7(data, 30, 34), jbc7.decode_bc7(data, 30, 34),
        f"mode {mode} image")


@pytest.mark.parametrize("pillow", [False, True])
@pytest.mark.parametrize("signed", [False, True])
def test_bc6h_equal_jax(signed, pillow):
    """1024 random blocks (every mode value, the reserved ones included),
    UF16 and SF16, the spec path and Pillow's emulation."""
    raw = _rand(70 + 2 * signed + pillow, 1024 * 16).reshape(1024, 16)
    modes = np.where(raw[:, 0] & 3 < 2, raw[:, 0] & 3, raw[:, 0] & 31)
    assert set(jbc6h._MODE_INFO) | {19, 23, 27, 31} <= set(modes.tolist())
    _eq(bc6h.decode_bc6h_blocks(raw, signed, pillow),
        jbc6h.decode_bc6h_blocks(raw, signed, pillow), "blocks")
    data = raw.tobytes()
    got = bc6h.decode_bc6h(data, 64, 62, signed=signed,
                           pillow_emulation=pillow)
    assert got.dtype == np.float32 and got.shape == (62, 64, 3)
    _eq(got, jbc6h.decode_bc6h(data, 64, 62, signed=signed,
                               pillow_emulation=pillow), "image")


def test_format_tables_equal_jax():
    assert dds._DXGI_TO_FOURCC == jdds._DXGI_TO_FOURCC
    assert dds._DXGI_RGBA_MASKS == jdds._DXGI_RGBA_MASKS


# -- load_dds ----------------------------------------------------------------

_BLOCK_BYTES = {b"DXT1": 8, b"ATI1": 8, b"DXT3": 16, b"DXT5": 16,
                b"ATI2": 16, b"BC7 ": 16, b"BC6H": 16, b"BC6S": 16}


def _payload_bytes(w, h, mips, block=None, bpp=32):
    total = 0
    for k in range(mips):
        mw, mh = max(w >> k, 1), max(h >> k, 1)
        total += (((mw + 3) // 4) * ((mh + 3) // 4) * block if block
                  else mw * mh * bpp // 8)
    return total


def _file(tmp_path, name, w, h, mips, items=1, fourcc=None, bpp=32,
          masks=sa.RGBA8_MASKS, cube=False, dx10=None, seed=0):
    """A DDS file of random payload: `items` mip chains (6 per array slice
    for a cube)."""
    block = _BLOCK_BYTES.get(fourcc) or (
        _BLOCK_BYTES.get(dds._DXGI_TO_FOURCC.get(dx10[0])) if dx10 else None)
    if dx10 and not block and dx10[0] in dds._DXGI_RGBA_MASKS:
        bpp = dds._DXGI_RGBA_MASKS[dx10[0]][0]
    n = _payload_bytes(w, h, mips, block, bpp) * items
    head = sa.dds_header(w, h, mips, fourcc=b"DX10" if dx10 else fourcc,
                         bpp=bpp, masks=masks, cube=cube, dx10=dx10)
    p = tmp_path / f"{name}.dds"
    p.write_bytes(head + _rand(seed, n).tobytes())
    return str(p)


def _same_texture(path):
    got, ref = dds.load_dds(path), jdds.load_dds(path)
    assert got.is_cubemap == ref.is_cubemap
    assert got.array_size == ref.array_size
    assert (got.width, got.height) == (ref.width, ref.height)
    items = [(got.faces, ref.faces), (got.layers, ref.layers)]
    if not ref.is_cubemap:
        items.append(([got.mips], [ref.mips]))
    for a, b in items:
        assert len(a) == len(b)
        for k, (ca, cb) in enumerate(zip(a, b)):
            assert len(ca) == len(cb)
            for m, (x, y) in enumerate(zip(ca, cb)):
                _eq(x, y, f"{path} item {k} mip {m}")
    return got


LEGACY = {  # name -> (w, h, mips, fourcc)
    "dxt1_mips": (20, 12, 5, b"DXT1"),
    "dxt3_mips": (16, 16, 5, b"DXT3"),
    "dxt5_mips": (36, 8, 6, b"DXT5"),
    "ati1_mips": (8, 8, 4, b"ATI1"),
    "ati2_mips": (12, 4, 4, b"ATI2"),
}
LEGACY_MASKS = {  # name -> (bpp, r, g, b, a)
    "r5g6b5": (16, 0xF800, 0x07E0, 0x001F, 0),
    "a1r5g5b5": (16, 0x7C00, 0x03E0, 0x001F, 0x8000),
    "a4r4g4b4": (16, 0x0F00, 0x00F0, 0x000F, 0xF000),
    "r8g8b8": (24, 0xFF0000, 0xFF00, 0xFF, 0),
    "x8r8g8b8": (32, 0xFF0000, 0xFF00, 0xFF, 0),
    "a8r8g8b8": (32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    "a8b8g8r8": (32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000),
    "l8": (8, 0xFF, 0, 0, 0),
    "a8": (8, 0, 0, 0, 0xFF),
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_load_dds_legacy_fourcc(tmp_path, name):
    w, h, mips, fourcc = LEGACY[name]
    t = _same_texture(_file(tmp_path, name, w, h, mips, fourcc=fourcc))
    assert [m.shape[:2] for m in t.mips] == [
        (max(h >> k, 1), max(w >> k, 1)) for k in range(mips)]


@pytest.mark.parametrize("name", sorted(LEGACY_MASKS))
def test_load_dds_legacy_masks(tmp_path, name):
    bpp, *masks = LEGACY_MASKS[name]
    _same_texture(_file(tmp_path, name, 6, 5, 3, bpp=bpp, masks=masks))


@pytest.mark.parametrize("dxgi", sorted(dds._DXGI_RGBA_MASKS))
def test_load_dds_dx10_masks(tmp_path, dxgi):
    _same_texture(_file(tmp_path, f"dxgi{dxgi}", 6, 5, 2,
                        dx10=(dxgi, 3, 0, 1, 0)))


@pytest.mark.parametrize("dxgi", sorted(dds._DXGI_TO_FOURCC))
def test_load_dds_dx10_blocks(tmp_path, dxgi):
    t = _same_texture(_file(tmp_path, f"dxgi{dxgi}", 16, 8, 3,
                            dx10=(dxgi, 3, 0, 1, 0)))
    if dds._DXGI_TO_FOURCC.get(dxgi) in (b"BC6H", b"BC6S"):
        assert t.mips[0].dtype == np.float32
        assert (t.mips[0][..., 3] == 1.0).all()


def test_load_dds_dx10_array(tmp_path):
    """arraySize 3 (DDSTextureLoader.cpp:1758-1809): a mip chain per
    slice, mips aliasing slice 0."""
    t = _same_texture(_file(tmp_path, "array", 8, 4, 2, items=3,
                            dx10=(28, 3, 0, 3, 0)))
    assert len(t.layers) == 3 and t.mips is t.layers[0]
    assert not np.array_equal(t.layers[0][0], t.layers[1][0])


@pytest.mark.parametrize("kind", ["legacy_rgba8", "legacy_dxt1",
                                  "dx10_bc6h", "dx10_bc7"])
def test_load_dds_cubemap(tmp_path, kind):
    """Six face chains: the legacy caps2 flags or the DX10 TEXTURECUBE
    misc flag."""
    kw = dict(legacy_rgba8=dict(cube=True),
              legacy_dxt1=dict(cube=True, fourcc=b"DXT1"),
              dx10_bc6h=dict(dx10=(95, 3, 0x4, 1, 0)),
              dx10_bc7=dict(dx10=(98, 3, 0x4, 1, 0)))[kind]
    t = _same_texture(_file(tmp_path, kind, 8, 8, 3, items=6, **kw))
    assert t.is_cubemap and len(t.faces) == 6


def test_load_dds_rejects_other_files(tmp_path):
    p = tmp_path / "x.dds"
    p.write_bytes(b"BM" + bytes(200))
    with pytest.raises(ValueError, match="not a DDS"):
        dds.load_dds(str(p))
    with pytest.raises(ValueError, match="DXGI format"):
        dds.load_dds(_file(tmp_path, "r16", 4, 4, 1, dx10=(56, 3, 0, 1, 0),
                           bpp=16))


# -- BMP ---------------------------------------------------------------------

@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bpp", [24, 32])
def test_load_bmp_equal_jax(tmp_path, bpp, top_down):
    """7x5 (rows padded to 4 bytes), both row orders; 24 bpp reads alpha
    255."""
    rng = np.random.default_rng(bpp + top_down)
    rgb = rng.integers(0, 256, (5, 7, 3), np.uint8)
    alpha = rng.integers(0, 256, (5, 7), np.uint8)
    p = tmp_path / "f.bmp"
    p.write_bytes(sa.bmp_bytes(rgb, bpp, top_down, alpha))
    got = dds.load_bmp(str(p))
    _eq(got, jdds.load_bmp(str(p)), "bmp")
    _eq(got[..., :3], rgb, "rgb")
    _eq(got[..., 3], alpha if bpp == 32 else np.full_like(alpha, 255),
        "alpha")


# -- meshes ------------------------------------------------------------------

def _mesh_files(tmp_path):
    """The synthetic SMALL skull and car, and a file of random decimals
    (9 significant digits, 1e-3 to 1e3) in the same format."""
    rng = np.random.default_rng(5)
    out = {}
    for name, (nv, nt), radii in (("skull", sa.SMALL.skull, (3, 3.6, 4.2)),
                                  ("car", sa.CAR, (2.5, 0.9, 1.2))):
        p = tmp_path / f"{name}.txt"
        p.write_text(sa.mesh_txt(*sa.ellipsoid_mesh(rng, nv, nt, radii)))
        out[name] = str(p)
    vals = rng.normal(size=(3000, 6)) * 10 ** rng.uniform(-3, 3, (3000, 6))
    idx = rng.integers(0, 3000, (500, 3))
    lines = ["VertexCount: 3000", "TriangleCount: 500",
             "VertexList (pos, normal)", "{"]
    lines += ["\t" + " ".join(f"{x:.9g}" for x in r) for r in vals]
    lines += ["}", "TriangleList", "{"] + [f"\t{a} {b} {c}" for a, b, c in idx]
    p = tmp_path / "decimals.txt"
    p.write_text("\n".join(lines + ["}"]))
    out["decimals"] = str(p)
    return out


def test_load_mesh_txt_equal_both_jax_paths(tmp_path, monkeypatch):
    files = _mesh_files(tmp_path)
    native = {k: jmesh.load_mesh_txt(p) for k, p in files.items()}
    assert jnative.parse_mesh_txt(files["car"]) is not None
    monkeypatch.setattr(jnative, "parse_mesh_txt", lambda path: None)
    plain = {k: jmesh.load_mesh_txt(p) for k, p in files.items()}
    for k, p in files.items():
        got = mesh_txt.load_mesh_txt(p)
        for ref, path in ((native[k], "C++"), (plain[k], "numpy")):
            for f in dataclasses.fields(got):
                _eq(getattr(got, f.name), getattr(ref, f.name),
                    f"{k} {f.name} vs the JAX {path} path")
    skull = mesh_txt.load_mesh_txt(files["skull"])
    assert (skull.num_vertices, skull.num_triangles) == sa.SMALL.skull
    assert skull.indices.max() < skull.num_vertices
    n = np.linalg.norm(skull.normals, axis=1)
    assert np.allclose(n, 1.0, atol=1e-5)


def test_published_mesh_counts():
    """FULL's meshes carry the published counts (BASELINE.md:35-36)."""
    rng = np.random.default_rng(0)
    for (nv, nt) in (sa.FULL.skull, sa.CAR):
        pos, nrm, idx = sa.ellipsoid_mesh(rng, nv, nt, (1, 1, 1))
        assert pos.shape == nrm.shape == (nv, 3) and idx.shape == (nt, 3)
        assert idx.max() < nv


# -- snapshots ---------------------------------------------------------------

def _same_scene(a, b, la, lb):
    for layer in ("opaque", "shadow"):
        da, db = getattr(a, layer), getattr(b, layer)
        for f in dataclasses.fields(da):
            _eq(getattr(da, f.name), getattr(db, f.name), f"{layer}.{f.name}")
    for f in dataclasses.fields(a.material_bank):
        _eq(getattr(a.material_bank, f.name),
            getattr(b.material_bank, f.name), f"material_bank.{f.name}")
    assert list(a.texture_names) == list(b.texture_names)
    for f in dataclasses.fields(la):
        x, y = getattr(la, f.name), getattr(lb, f.name)
        if isinstance(x, int):
            assert x == y, f.name
        else:
            _eq(x, y, f"lights.{f.name}")


def test_snapshot_round_trips_between_packages(tmp_path):
    """A snapshot written by either package loads in the other with equal
    leaves, equal to the scene it was written from."""
    scene, _, lights = tsb.CONFIGS[1]()
    jscene, _, jlights = jsb.CONFIGS[1]()
    snapshot.save_scene(str(tmp_path / "port.npz"), scene, lights)
    jsnap.save_scene(str(tmp_path / "jax.npz"), jscene, jlights)
    for path in ("port.npz", "jax.npz"):
        got, glights = snapshot.load_scene(str(tmp_path / path))
        ref, rlights = jsnap.load_scene(str(tmp_path / path))
        _same_scene(got, ref, glights, rlights)
        _same_scene(got, scene, glights, lights)
    got, glights = snapshot.load_scene(str(tmp_path / "port.npz"))
    assert glights is not None
    snapshot.save_scene(str(tmp_path / "nolights.npz"), scene)
    assert snapshot.load_scene(str(tmp_path / "nolights.npz"))[1] is None


# -- the sky cube and the renderer's asset defaults --------------------------

@pytest.mark.parametrize("kind", ["rgba8", "bc6h"])
def test_load_sky_cubemap_equal_jax(tmp_path, kind):
    kw = (dict(cube=True) if kind == "rgba8"
          else dict(dx10=(95, 3, 0x4, 1, 0)))
    p = _file(tmp_path, kind, 8, 8, 2, items=6, seed=3, **kw)
    got = tren.load_sky_cubemap(p)
    ref = jren.load_sky_cubemap(p)
    _eq(got, ref, "faces")
    assert got.shape == (6, 8, 8, 4)
    _eq(tsamp.pack_cubemap(got), jsamp.pack_cubemap(ref), "packed")
    with pytest.raises(ValueError, match="not a cubemap"):
        tren.load_sky_cubemap(_file(tmp_path, "flat", 8, 8, 1))


def test_asset_defaults_equal_jax():
    """The port's asset entry points take the JAX package's defaults and
    its sky_cubemap_path."""
    assert tren.DEFAULT_ASSET_DIR == jren.DEFAULT_ASSET_DIR
    assert tsb.REF_MODELS == jsb.REF_MODELS
    for name in ("load_texture_chains", "build_pair_pool",
                 "build_device_scene", "Renderer"):
        tsig = inspect.signature(getattr(tren, name)).parameters
        jsig = inspect.signature(getattr(jren, name)).parameters
        for p, jp in jsig.items():
            assert p in tsig, f"{name}: no {p}"
            assert tsig[p].default == jp.default, f"{name}({p})"
