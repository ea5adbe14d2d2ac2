"""Pinhole geometry: unprojection, rigid transforms, projection.

Counterpart of ``worldforge_tpu/warp/geometry.py`` (:16-73). Points are
``[3, N]`` fp32 tensors on any device (``dc_unproject``'s are ``[N, 3]``). Every 3x3 product is computed as
the JAX package's CPU dot computes it, a fused multiply-add chain
``fma(m2, p2, fma(m1, p1, m0 p0))`` (``_mat3``), so that the warp masks are
bit-identical to its warp: a product summed in another order (cuBLAS) or
rounded at each step moves a point that projects onto a pixel's .5
boundary into the neighbouring pixel. Each fused step is emulated in
float64 (the product of two fp32 values is exact there) and rounded back,
which the CPU and the card compute alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _mat3(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``m [..., 3, 3] @ p [..., 3, N]`` in fp32, each row as the chain
    ``fma(m[i,2], p2, fma(m[i,1], p1, m[i,0] p0))``."""
    m = m.double()[..., None]
    p = p.double()
    rows = []
    for i in range(3):
        acc = (m[..., i, 0, :] * p[..., 0, :]).float()
        for j in (1, 2):
            acc = (m[..., i, j, :] * p[..., j, :] + acc.double()).float()
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
        a, torch.Tensor) else a, dtype=torch.float32, device=device)


def pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Homogeneous pixel coords [3, H*W] = (x, y, 1), row-major."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1),
                        torch.ones(h * w, device=device)])


def unproject_depth(depth: torch.Tensor, intrinsic) -> torch.Tensor:
    """depth [H, W] + K [3, 3] -> camera-frame points [3, H*W]
    (K^-1 @ pix * depth). K^-1 is inverted in fp32 on the host."""
    h, w = depth.shape
    k_inv = torch.linalg.inv(_as_f32(intrinsic, "cpu")).to(depth.device)
    rays = _mat3(k_inv, pixel_grid(h, w, depth.device))
    return rays * depth.float().reshape(1, -1)


def cam_to_world(points_cam: torch.Tensor, extrinsic_w2c) -> torch.Tensor:
    """[3, N] from the source camera frame to world through the inverse of
    a w2c extrinsic: R^T p - R^T t."""
    e = _as_f32(extrinsic_w2c, points_cam.device)
    rt = e[:3, :3].T.contiguous()
    t = e[:3, 3]
    rtt = torch.stack([rt[i, 0] * t[0] + rt[i, 1] * t[1] + rt[i, 2] * t[2]
                       for i in range(3)])
    return _mat3(rt, points_cam) - rtt[:, None]


def world_to_cam(points_world: torch.Tensor, extrinsic_w2c) -> torch.Tensor:
    e = _as_f32(extrinsic_w2c, points_world.device)
    return _mat3(e[:3, :3], points_world) + e[:3, 3][:, None]


def project(points_cam: torch.Tensor, intrinsic
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[3, N] camera points -> (uv [2, N], z [N])."""
    z = points_cam[2]
    safe_z = torch.where(z.abs() > 1e-6, z, torch.ones_like(z))
    uvw = _mat3(_as_f32(intrinsic, points_cam.device), points_cam / safe_z)
    return uvw[:2], z


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded once in fp32 on every device: CUDA divides a tensor
    by a Python number as a product with its reciprocal, which can differ
    in the last bit."""
    return x / torch.tensor(s, dtype=torch.float32, device=x.device)


def dc_unproject(inv_depth: torch.Tensor, f: float = 525.0) -> torch.Tensor:
    """DepthCrafter unprojection: fixed intrinsics f = 525, c = (W/2, H/2);
    the input is 1/(depth+0.1). Returns points [N, 3] in the source camera
    frame (the world: identity pose)."""
    h, w = inv_depth.shape
    dev = inv_depth.device
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    d = inv_depth.float()
    x = _div((jj - 0.5 * w) * d, f)
    y = _div((ii - 0.5 * h) * d, f)
    return torch.stack([x.reshape(-1), y.reshape(-1), d.reshape(-1)], dim=-1)


def dc_intrinsic(h: int, w: int, f: float = 525.0) -> np.ndarray:
    return np.array([[f, 0.0, 0.5 * w], [0.0, f, 0.5 * h], [0.0, 0.0, 1.0]],
                    np.float32)
