"""World -> camera -> pixel projection with optional lens distortion.

Counterpart of ``worldforge_tpu/sfm/projection.py``: extrinsics are
world-to-camera [R|t] (3x4), intrinsics K (3x3), distortion parameters as
``sfm/distortion.py``; fp32, as JAX runs it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from worldforge_tpu_torch.sfm.distortion import apply_distortion


def img_from_cam(intrinsics: torch.Tensor, points_cam: torch.Tensor,
                 extra_params: Optional[torch.Tensor] = None,
                 default: float = 0.0) -> torch.Tensor:
    """K [B, 3, 3], camera points [B, 3, N] -> pixels [B, N, 2]; NaN
    becomes ``default`` and +-inf the largest finite fp32, as
    ``jnp.nan_to_num``."""
    z = points_cam[:, 2:3, :]
    uv = (points_cam / z)[:, :2, :]
    if extra_params is not None:
        uu, vv = apply_distortion(extra_params, uv[:, 0], uv[:, 1])
        uv = torch.stack([uu, vv], dim=1)
    h = torch.cat([uv, torch.ones_like(uv[:, :1, :])], dim=1)
    p2d = torch.einsum("bij,bjn->bin", intrinsics, h)[:, :2]
    p2d = torch.nan_to_num(p2d, nan=default)
    return p2d.transpose(1, 2)


def project_3d_points(points3d: torch.Tensor, extrinsics: torch.Tensor,
                      intrinsics: Optional[torch.Tensor] = None,
                      extra_params: Optional[torch.Tensor] = None,
                      default: float = 0.0, only_points_cam: bool = False
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """World points [N, 3] and w2c extrinsics [B, 3, 4] -> (pixels
    [B, N, 2], camera points [B, 3, N])."""
    pts = torch.as_tensor(points3d).float()
    ext = torch.as_tensor(extrinsics, device=pts.device).float()
    h = torch.cat([pts, torch.ones((pts.shape[0], 1), device=pts.device)],
                  dim=1)                                      # [N, 4]
    points_cam = torch.einsum("bij,nj->bin", ext, h)          # [B, 3, N]
    if only_points_cam:
        return None, points_cam
    if intrinsics is None:
        raise ValueError("intrinsics required unless only_points_cam")
    p2d = img_from_cam(torch.as_tensor(intrinsics, device=pts.device).float(),
                       points_cam, extra_params, default)
    return p2d, points_cam
