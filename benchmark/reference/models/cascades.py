"""Cascaded-shadow-map fitting.

Replicates CRYCHIC::UpdateCascadeShadowTransform
(CRYCHIC.cpp:634-815): 4 cascades split at view depths
{near, 30, 50, 80, far}; per cascade the camera sub-frustum's NDC corners
are unprojected to world space, a bounding length is taken as the max of
two frustum diagonals, a light-space ortho box of that size is fit around
the slice center, and its xy center is snapped to shadow-texel multiples to
kill shimmering. Only light 0 casts shadows (CRYCHIC.cpp:726).

The reference computes transforms for 4 cascades but uploads 12 pass CBs and
renders 6 depth maps (SURVEY.md §0 caveats); the shaders only ever read
cascades 0-3, so we implement exactly the 4 meaningful cascades.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import mathutil as mu

# Cascade selection radii used by the shaders (Shaders/Default.hlsl:124).
CASCADE_RADII = (30.0, 50.0, 80.0, 100.0)
NUM_CASCADES = 4


@dataclasses.dataclass
class CascadeTransforms:
    light_views: np.ndarray  # (4, 4, 4) row-vector view matrices
    light_projs: np.ndarray  # (4, 4, 4)
    shadow_transforms: np.ndarray  # (4, 4, 4) world -> shadow-map uv/depth

    @property
    def view_projs(self) -> np.ndarray:
        return np.einsum("cij,cjk->cik", self.light_views, self.light_projs)


def fit_cascades(camera, light_dir, shadow_map_size: int,
                 splits=None) -> CascadeTransforms:
    """camera: models.camera.Camera; light_dir: (3,) world direction."""
    light_dir = np.asarray(light_dir, dtype=np.float32)
    view = camera.view
    if splits is None:
        z_near = [camera.near_z, 30.0, 50.0, 80.0]
        z_far = [30.0, 50.0, 80.0, camera.far_z]
    else:
        z_near = list(splits[:-1])
        z_far = list(splits[1:])

    views, projs, transforms = [], [], []
    T = mu.ndc_to_tex()
    for zn, zf in zip(z_near, z_far):
        proj = mu.perspective_fov_lh(camera.fov_y, camera.aspect, zn, zf)
        inv_vp = np.linalg.inv(view @ proj)
        corners_ndc = np.array(
            [
                [-1, +1, 0], [+1, +1, 0], [+1, -1, 0], [-1, -1, 0],
                [-1, +1, 1], [+1, +1, 1], [+1, -1, 1], [-1, -1, 1],
            ],
            dtype=np.float32,
        )
        ch = mu.transform_point(corners_ndc, inv_vp)
        corners = ch[:, :3] / ch[:, 3:4]

        cross_far = np.linalg.norm(corners[7] - corners[5])
        cross_near2far = np.linalg.norm(corners[3] - corners[5])
        length = float(max(cross_far, cross_near2far))

        target = 0.5 * (corners[3] + corners[5])
        light_pos = -length * light_dir + target
        light_view = mu.look_at_lh(light_pos, target, (0.0, 1.0, 0.0))

        corners_ls = mu.transform_point(corners, light_view)[:, :3]
        vmin = corners_ls.min(axis=0)
        vmax = corners_ls.max(axis=0)

        texel = length / shadow_map_size
        center = 0.5 * (vmin + vmax)
        center = np.floor(center / texel) * texel

        l, b, n = center - 0.5 * length
        r, t, f = center + 0.5 * length
        light_proj = mu.ortho_off_center_lh(l, r, b, t, n, f)

        views.append(light_view)
        projs.append(light_proj)
        transforms.append(light_view @ light_proj @ T)

    return CascadeTransforms(
        light_views=np.stack(views).astype(np.float32),
        light_projs=np.stack(projs).astype(np.float32),
        shadow_transforms=np.stack(transforms).astype(np.float32),
    )
