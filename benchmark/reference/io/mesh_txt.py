"""Loader for the ``Models/*.txt`` mesh format (skull.txt, car.txt); the
port's copy of ``crychic_renderer_tpu.io.mesh_txt``.

Format (reference parser: CRYCHIC::BuildSkullGeometry,
CRYCHIC.cpp:1447-1516)::

    VertexCount: N
    TriangleCount: M
    VertexList (pos, normal)
    {
    px py pz nx ny nz     # N lines
    }
    TriangleList
    {
    i0 i1 i2              # M lines
    }

Tangents are synthesized as cross(up, N) with a z-up fallback when the
normal is (anti)parallel to +y (CRYCHIC.cpp:1486-1497); UVs are zero.

The JAX package parses with a C++ helper when it builds (fscanf "%f",
decimal straight to float32) and otherwise with this token parser
(decimal to a Python float, then float32). The port has only the token
parser; tests/test_torch_io.py holds it bit-equal to both JAX paths.
"""
from __future__ import annotations

import numpy as np

from ..models.geometry import MeshData


def load_mesh_txt(path: str) -> MeshData:
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def expect_kv(key):
        k = next(it)
        if not k.lower().startswith(key.lower()[:6]):
            raise ValueError(f"{path}: expected {key!r}, found {k!r}")
        return int(next(it))

    vcount = expect_kv("VertexCount:")
    tcount = expect_kv("TriangleCount:")
    # skip "VertexList (pos, normal) {"
    tok = next(it)
    while not tok.endswith("{"):
        tok = next(it)

    vals = np.array([float(next(it)) for _ in range(vcount * 6)],
                    dtype=np.float64).astype(np.float32)
    v = vals.reshape(vcount, 6)
    positions = v[:, :3].copy()
    normals = v[:, 3:].copy()

    # skip "} TriangleList {"
    tok = next(it)
    while not tok.endswith("{"):
        tok = next(it)
    idx = np.array([int(next(it)) for _ in range(tcount * 3)],
                   dtype=np.int32)

    tangents = synthesize_tangents(normals)
    uvs = np.zeros((vcount, 2), dtype=np.float32)
    return MeshData(positions, normals, tangents, uvs, idx)


def synthesize_tangents(normals: np.ndarray) -> np.ndarray:
    """cross(up, N), falling back to cross(N, z) near the poles
    (CRYCHIC.cpp:1486-1497)."""
    up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    z = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    t_main = np.cross(np.broadcast_to(up, normals.shape), normals)
    t_fallback = np.cross(normals, np.broadcast_to(z, normals.shape))
    use_fallback = np.abs(normals @ up) >= 1.0 - 0.001
    t = np.where(use_fallback[:, None], t_fallback, t_main)
    n = np.linalg.norm(t, axis=-1, keepdims=True)
    return (t / np.maximum(n, 1e-20)).astype(np.float32)
