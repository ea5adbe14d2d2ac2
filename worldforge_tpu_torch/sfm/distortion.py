"""Camera distortion models (COLMAP SIMPLE_RADIAL / RADIAL / OPENCV).

Counterpart of ``worldforge_tpu/sfm/distortion.py``: ``apply_distortion``
for 1, 2 or 4 parameters, one forward application, and the inversion by
Newton iterations with a numerically differentiated 2x2 Jacobian and a
closed-form solve. JAX runs the iterations as a fixed-trip
``lax.fori_loop``; here they are a fixed-trip Python loop, with no early
exit either.
"""

from __future__ import annotations

import torch


def apply_distortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """params [B, k] (k in {1, 2, 4}); u, v [B, N] normalised coordinates ->
    the distorted (u, v)."""
    k = params.shape[1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    if k == 1:
        radial = params[:, 0:1] * r2
        du, dv = u * radial, v * radial
    elif k == 2:
        radial = params[:, 0:1] * r2 + params[:, 1:2] * r2 * r2
        du, dv = u * radial, v * radial
    elif k == 4:
        k1, k2 = params[:, 0:1], params[:, 1:2]
        p1, p2 = params[:, 2:3], params[:, 3:4]
        uv = u * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
        dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    else:
        raise ValueError(f"unsupported distortion parameter count {k}")
    return u + du, v + dv


def single_undistortion(params: torch.Tensor,
                        tracks: torch.Tensor) -> torch.Tensor:
    """One forward application; tracks [B, N, 2]."""
    u, v = apply_distortion(params, tracks[..., 0], tracks[..., 1])
    return torch.stack([u, v], dim=-1)


def iterative_undistortion(params: torch.Tensor, tracks: torch.Tensor,
                           max_iterations: int = 100,
                           rel_step_size: float = 1e-6) -> torch.Tensor:
    """Invert the distortion by ``max_iterations`` Newton steps: distorted
    normalised tracks [B, N, 2] -> undistorted."""
    orig_u, orig_v = tracks[..., 0], tracks[..., 1]
    eps = torch.finfo(tracks.dtype).eps
    u, v = orig_u, orig_v
    for _ in range(max_iterations):
        du_, dv_ = apply_distortion(params, u, v)
        dx = orig_u - du_
        dy = orig_v - dv_
        su = torch.clamp(u.abs() * rel_step_size, min=eps)
        sv = torch.clamp(v.abs() * rel_step_size, min=eps)
        up, um = apply_distortion(params, u + su, v), \
            apply_distortion(params, u - su, v)
        vp, vm = apply_distortion(params, u, v + sv), \
            apply_distortion(params, u, v - sv)
        j00 = (up[0] - um[0]) / (2 * su) + 1.0
        j01 = (vp[0] - vm[0]) / (2 * sv)
        j10 = (up[1] - um[1]) / (2 * su)
        j11 = (vp[1] - vm[1]) / (2 * sv) + 1.0
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
        step_u = (j11 * dx - j01 * dy) / det
        step_v = (j00 * dy - j10 * dx) / det
        u, v = u + step_u, v + step_v
    return torch.stack([u, v], dim=-1)
