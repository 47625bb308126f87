"""FPS camera with DirectXMath conventions.

Re-implements the reference's Camera (Common/Camera.cpp):
position + right/up/look orthonormal basis, left-handed perspective lens,
walk/strafe/pitch/rotateY, lazily rebuilt row-vector view matrix.
"""
from __future__ import annotations

import numpy as np

from ..utils import mathutil as mu


class Camera:
    def __init__(self):
        self.position = np.array([0.0, 0.0, 0.0], dtype=np.float32)
        self.right = np.array([1.0, 0.0, 0.0], dtype=np.float32)
        self.up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        self.look = np.array([0.0, 0.0, 1.0], dtype=np.float32)
        self._view = mu.identity4()
        self._view_dirty = True
        self.set_lens(0.25 * np.pi, 1.0, 1.0, 1000.0)

    # -- lens ---------------------------------------------------------------
    def set_lens(self, fov_y: float, aspect: float, zn: float, zf: float):
        """Camera::SetLens (Camera.cpp:116-129)."""
        self.fov_y = float(fov_y)
        self.aspect = float(aspect)
        self.near_z = float(zn)
        self.far_z = float(zf)
        self.near_window_height = 2.0 * zn * np.tan(0.5 * fov_y)
        self.far_window_height = 2.0 * zf * np.tan(0.5 * fov_y)
        self._proj = mu.perspective_fov_lh(fov_y, aspect, zn, zf)

    # -- lens-derived accessors (Camera.cpp:90-114) ---------------------------
    def fov_x(self) -> float:
        half_width = 0.5 * self.near_window_width()
        return 2.0 * float(np.arctan(half_width / self.near_z))

    def near_window_width(self) -> float:
        return self.aspect * self.near_window_height

    def far_window_width(self) -> float:
        return self.aspect * self.far_window_height

    # -- placement ----------------------------------------------------------
    def set_position(self, x: float, y: float, z: float):
        self.position = np.array([x, y, z], dtype=np.float32)
        self._view_dirty = True

    def look_at(self, pos, target, world_up):
        """Camera::LookAt (Camera.cpp:131-143)."""
        pos = np.asarray(pos, dtype=np.float32)
        target = np.asarray(target, dtype=np.float32)
        world_up = np.asarray(world_up, dtype=np.float32)
        L = mu.normalize(target - pos)
        R = mu.normalize(np.cross(world_up, L))
        U = np.cross(L, R)
        self.position, self.look, self.right, self.up = pos, L, R, U
        self._view_dirty = True

    # -- movement (Camera.cpp:179-224) ---------------------------------------
    def strafe(self, d: float):
        self.position = self.position + d * self.right
        self._view_dirty = True

    def walk(self, d: float):
        self.position = self.position + d * self.look
        self._view_dirty = True

    def pitch(self, angle: float):
        R = mu.rotation_axis(self.right, angle)
        self.up = mu.transform_normal(self.up, R)
        self.look = mu.transform_normal(self.look, R)
        self._view_dirty = True

    def rotate_y(self, angle: float):
        R = mu.rotation_y(angle)
        self.right = mu.transform_normal(self.right, R)
        self.up = mu.transform_normal(self.up, R)
        self.look = mu.transform_normal(self.look, R)
        self._view_dirty = True

    # -- matrices -------------------------------------------------------------
    def update_view_matrix(self):
        """Camera::UpdateViewMatrix (Camera.cpp:226-273)."""
        if not self._view_dirty:
            return
        L = mu.normalize(self.look)
        U = mu.normalize(np.cross(L, self.right))
        R = np.cross(U, L)
        P = self.position
        x, y, z = -np.dot(P, R), -np.dot(P, U), -np.dot(P, L)
        self.right, self.up, self.look = R, U, L
        self._view = np.array(
            [
                [R[0], U[0], L[0], 0.0],
                [R[1], U[1], L[1], 0.0],
                [R[2], U[2], L[2], 0.0],
                [x, y, z, 1.0],
            ],
            dtype=np.float32,
        )
        self._view_dirty = False

    @property
    def view(self) -> np.ndarray:
        self.update_view_matrix()
        return self._view

    @property
    def proj(self) -> np.ndarray:
        return self._proj

    @property
    def view_proj(self) -> np.ndarray:
        return self.view @ self.proj


class BoundingFrustum:
    """DirectX::BoundingFrustum built from a projection matrix, with the
    Contains(AABB) test used for instance culling (CRYCHIC.cpp:515-557).

    We represent the frustum in its local (view) space by the 6 plane
    equations derived from the projection matrix's slopes, and implement
    Transform() by transforming the AABB into frustum-local space instead
    (equivalent test; the reference transforms the frustum into the box's
    local space, same disjoint answer either way).
    """

    def __init__(self, proj: np.ndarray):
        # For a row-vector LH projection: right slope = 1/m00, top = 1/m11,
        # near = m32/m22 ... compute from inverse-projected NDC corners for
        # robustness instead.
        inv = np.linalg.inv(proj)
        corners_ndc = np.array(
            [
                [-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0],
                [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
            ],
            dtype=np.float32,
        )
        c = mu.transform_point(corners_ndc, inv)
        self.corners_view = (c[:, :3] / c[:, 3:4]).astype(np.float32)

    def planes_in(self, frustum_to_target: np.ndarray):
        """Return the 6 frustum planes (n, d) with n·p + d >= 0 inside,
        expressed in a target space given the frustum->target transform
        (row-vector 4x4)."""
        cs = mu.transform_point(self.corners_view, frustum_to_target)
        cs = cs[:, :3] / cs[:, 3:4]
        n0, n1, n2, n3, f0, f1, f2, f3 = cs
        # plane from 3 points, normal toward inside
        def plane(a, b, c, inside):
            n = np.cross(b - a, c - a)
            n = n / np.linalg.norm(n)
            d = -np.dot(n, a)
            if np.dot(n, inside) + d < 0:
                n, d = -n, -d
            return np.concatenate([n, [d]])

        center = cs.mean(axis=0)
        planes = [
            plane(n0, n1, n2, center),  # near
            plane(f0, f2, f1, center),  # far
            plane(n0, n2, f0, center),  # left
            plane(n1, f1, n3, center),  # right
            plane(n2, n3, f2, center),  # top
            plane(n0, f0, n1, center),  # bottom
        ]
        return np.stack(planes).astype(np.float32)


def cull_instances(frustum: "BoundingFrustum", inv_view: np.ndarray,
                   inv_worlds: np.ndarray, centers: np.ndarray,
                   extents: np.ndarray) -> np.ndarray:
    """Vectorized per-instance frustum culling (UpdateInstanceData,
    CRYCHIC.cpp:515-557): transform the frustum into every instance's local
    space at once and test the local AABBs.

    inv_worlds: (D, 4, 4); centers/extents: (D, 3). Returns (D,) bool.
    """
    corners = frustum.corners_view  # (8, 3)
    ch = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
    M = np.einsum("ij,djk->dik", inv_view, inv_worlds)  # (D, 4, 4)
    cs = np.einsum("ci,dij->dcj", ch, M)
    cs = cs[..., :3] / cs[..., 3:4]  # (D, 8, 3)
    n0, n1, n2, n3, f0, f1, f2, f3 = [cs[:, i] for i in range(8)]

    def plane(a, b, c):
        n = np.cross(b - a, c - a)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        d = -(n * a).sum(-1)
        return n, d

    center = cs.mean(axis=1)
    planes = [plane(n0, n1, n2), plane(f0, f2, f1), plane(n0, n2, f0),
              plane(n1, f1, n3), plane(n2, n3, f2), plane(n0, f0, n1)]
    visible = np.ones(cs.shape[0], dtype=bool)
    for n, d in planes:
        # orient inward
        flip = (n * center).sum(-1) + d < 0
        n = np.where(flip[:, None], -n, n)
        d = np.where(flip, -d, d)
        dist = (n * centers).sum(-1) + d
        radius = (np.abs(n) * extents).sum(-1)
        visible &= dist + radius >= 0.0
    return visible


def frustum_aabb_intersects(planes: np.ndarray, centers: np.ndarray,
                            extents: np.ndarray) -> np.ndarray:
    """Vectorized frustum-vs-AABB not-DISJOINT test.

    planes: (6, 4) with inside = n·p + d >= 0. centers/extents: (N, 3).
    Returns (N,) bool — True if the box is not disjoint from the frustum
    (matches ``Contains(...) != DISJOINT`` in CRYCHIC.cpp:543).
    """
    n = planes[:, :3]  # (6,3)
    d = planes[:, 3]  # (6,)
    # signed distance of box center to each plane
    dist = centers @ n.T + d  # (N, 6)
    # projection radius of the box onto each plane normal
    radius = extents @ np.abs(n).T  # (N, 6)
    outside_any = (dist + radius < 0.0).any(axis=-1)
    return ~outside_any
