"""Z-buffer point splat of the VGGT warp: nearest pixel, nearest in z wins.

Counterpart of ``worldforge_tpu/warp/splat.py`` (:37-101,
``_winner_take_all`` and ``splat_nearest``). JAX finds the winners with a
deterministic two-pass ``segment_min``: the least z per pixel, then the
least point index among the points at that z (a first-wins sequential
z-buffer). Here both passes are ``scatter_reduce_(..., "amin")``, which is
exact and independent of the order of the writes on the CPU and the card.
All frames of a trajectory splat in one call (a leading frame axis), as
JAX's ``vmap`` does. The DepthCrafter splats (``splat_disk``,
``render_points_nearest``) come with the DepthCrafter warp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from worldforge_tpu_torch.warp.geometry import _as_f32, _mat3

_BIG = 3.0e38
_BIG_I = 2 ** 31 - 1


def _winner_take_all(flat_idx: torch.Tensor, z: torch.Tensor,
                     colors: torch.Tensor, valid: torch.Tensor,
                     num_pixels: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-z scatter of F frames: flat_idx, z, valid [F, N], colors [N, C].
    Returns (color [F, P, C], zbuf [F, P], mask [F, P]). Ties in z go to the
    lowest point index."""
    f, n = z.shape
    dev = z.device
    stride = num_pixels + 1                      # + the overflow bucket
    base = (torch.arange(f, device=dev) * stride)[:, None]
    idx = (torch.where(valid, flat_idx, num_pixels) + base).reshape(-1)
    zm = torch.where(valid, z.float(), _BIG)
    zbuf = torch.full((f * stride,), _BIG, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, idx, zm.reshape(-1), "amin")
    zbuf = zbuf.reshape(f, stride)[:, :num_pixels]
    at = torch.gather(zbuf, 1, flat_idx.clamp(0, num_pixels - 1))
    is_win = valid & (zm == at)
    pid = torch.arange(n, device=dev).expand(f, n)
    win = torch.full((f * stride,), _BIG_I, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, idx, torch.where(is_win, pid, _BIG_I).reshape(-1),
                        "amin")
    win_pid = win.reshape(f, stride)[:, :num_pixels]
    mask = zbuf < _BIG
    color = colors[torch.where(mask, win_pid, 0)]
    color = torch.where(mask[..., None], color, torch.zeros_like(color))
    zbuf = torch.where(mask, zbuf, torch.full_like(zbuf, float("inf")))
    return color, zbuf, mask


def splat_nearest(points_cam: torch.Tensor, colors: torch.Tensor, intrinsic,
                  valid: torch.Tensor, *, h: int, w: int):
    """VGGT-style splat. points_cam [F, 3, N] (or [3, N]) in the target
    camera frames, colors [N, C], valid [N] bool. Returns (image
    [F, H, W, C], mask [F, H, W], depth [F, H, W] with NaN off the mask),
    without the frame axis for [3, N] points.

    Borders as the JAX default (``round_first=False``): the float
    coordinates are bounds-checked, then rounded (half to even) and
    clipped, so a point at u = W - 0.4 lands in the last column."""
    single = points_cam.dim() == 2
    pts = points_cam[None] if single else points_cam
    z = pts[:, 2]
    near = z.abs() > 1e-6
    ok = valid[None] & near
    safe_z = torch.where(near, z, torch.ones_like(z))
    uvw = _mat3(_as_f32(intrinsic, pts.device), pts / safe_z[:, None])
    uf, vf = uvw[:, 0], uvw[:, 1]
    ok = ok & (uf >= 0) & (uf < w) & (vf >= 0) & (vf < h)
    u = torch.where(ok, torch.round(uf).clamp(0, w - 1), 0).long()
    v = torch.where(ok, torch.round(vf).clamp(0, h - 1), 0).long()
    color, zbuf, mask = _winner_take_all(v * w + u, z, colors, ok, h * w)
    f = pts.shape[0]
    img = color.reshape(f, h, w, -1)
    m = mask.reshape(f, h, w)
    depth = torch.where(m, zbuf.reshape(f, h, w),
                        torch.full_like(m, float("nan"), dtype=torch.float32))
    if single:
        return img[0], m[0], depth[0]
    return img, m, depth
