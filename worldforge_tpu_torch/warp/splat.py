"""Z-buffer point splats of the warps: nearest in z wins.

Counterpart of ``worldforge_tpu/warp/splat.py`` (:37-95,
``_winner_take_all`` and ``splat_nearest``, the VGGT warp, with both
border rules; :98, ``render_points_nearest``, the numpy renderer's
fallback; :139-215, ``_disk_offsets``, ``splat_disk`` and ``morph_open``,
the DepthCrafter warp). JAX finds the winners with a
deterministic two-pass ``segment_min``: the least z per pixel, then the
least point index among the points at that z (a first-wins sequential
z-buffer). Here both passes are ``scatter_reduce_(..., "amin")``, which is
exact and independent of the order of the writes on the CPU and the card.
All frames of a trajectory splat in one call (a leading frame axis), as
JAX's ``vmap`` does. ``splat_disk`` covers every pixel whose centre lies
within a point's radius and finds the winners the same two-pass way over
the expanded (point, pixel) set, the ties going to the lowest point id;
``morph_open`` is cv2 on the host, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.warp.geometry import _as_f32, _mat3

_BIG = 3.0e38
_BIG_I = 2 ** 31 - 1


def _winner_take_all(flat_idx: torch.Tensor, z: torch.Tensor,
                     colors: torch.Tensor, valid: torch.Tensor,
                     num_pixels: int, pid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-z scatter of F frames: flat_idx, z, valid [F, N], colors [M, C].
    Returns (color [F, P, C], zbuf [F, P], mask [F, P]). Ties in z go to the
    lowest point id: ``pid`` [F, N] (ids into colors), by default the
    entry's index."""
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
    if pid is None:
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
                  valid: torch.Tensor, *, h: int, w: int,
                  round_first: bool = False):
    """VGGT-style splat. points_cam [F, 3, N] (or [3, N]) in the target
    camera frames, colors [N, C], valid [N] bool. Returns (image
    [F, H, W, C], mask [F, H, W], depth [F, H, W] with NaN off the mask),
    without the frame axis for [3, N] points.

    Borders, as JAX's two renderers: by default the float coordinates are
    bounds-checked, then rounded (half to even) and clipped, so a point at
    u = W - 0.4 lands in the last column; with ``round_first`` they are
    rounded first and the integers bounds-checked (the DepthCrafter CPU
    renderer), so u = -0.4 lands in column 0 and u = W - 0.4 falls out."""
    single = points_cam.dim() == 2
    pts = points_cam[None] if single else points_cam
    z = pts[:, 2]
    near = z.abs() > 1e-6
    ok = valid[None] & near
    safe_z = torch.where(near, z, torch.ones_like(z))
    uvw = _mat3(_as_f32(intrinsic, pts.device), pts / safe_z[:, None])
    uf, vf = uvw[:, 0], uvw[:, 1]
    if round_first:
        uf, vf = torch.round(uf), torch.round(vf)
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


def render_points_nearest(points: np.ndarray, features: np.ndarray,
                          extrinsic: np.ndarray, intrinsic: np.ndarray,
                          h: int, w: int, device=None):
    """The numpy renderer's fallback, as JAX's (``warp/splat.py:98``):
    ``splat_nearest(round_first=True)`` of the world points on ``device``
    (the card unless the CPU is asked for), a 3x3 morphological close of
    the mask (cv2), and at the pixels the close adds, colours from a linear
    ``griddata`` over the projected points (scipy) in float64 on the host.
    Returns (image [H, W, C] float32, mask [H, W] uint8)."""
    import cv2

    dev = resolve_device(device)
    pc = extrinsic[:3, :3] @ points.T + extrinsic[:3, 3][:, None]
    img_t, mask0_t, _ = splat_nearest(
        torch.as_tensor(pc, dtype=torch.float32, device=dev),
        torch.as_tensor(features, dtype=torch.float32, device=dev),
        np.asarray(intrinsic, np.float32),
        torch.ones(points.shape[0], dtype=torch.bool, device=dev),
        h=h, w=w, round_first=True)
    mask0 = mask0_t.cpu().numpy()
    mask = cv2.morphologyEx(mask0.astype(np.uint8), cv2.MORPH_CLOSE,
                            np.ones((3, 3), np.uint8))
    img = img_t.cpu().numpy().copy()
    crack = (mask > 0) & ~mask0
    if crack.any():
        from scipy.interpolate import griddata
        # the reference's pixel set: a float64 projection, np.round
        z = pc[2]
        u = np.round(intrinsic[0, 0] * (pc[0] / z) + intrinsic[0, 2]
                     ).astype(int)
        v = np.round(intrinsic[1, 1] * (pc[1] / z) + intrinsic[1, 2]
                     ).astype(int)
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        cy, cx = np.nonzero(crack)
        vals = griddata(np.stack((u[ok], v[ok]), axis=-1), features[ok],
                        np.stack((cx, cy), axis=-1).astype(np.float32),
                        method="linear", fill_value=0)
        img[cy, cx] = np.clip(vals, 0, 1).astype(np.float32)
    img[mask == 0] = 0
    return img, mask


def _disk_offsets(radius_px: float):
    r = int(np.ceil(radius_px + 0.5))
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def splat_disk(points: torch.Tensor, colors: torch.Tensor, extrinsic,
               intrinsic, *, h: int, w: int, radius_ndc: float = 0.005):
    """DepthCrafter-style splat. points [N, 3] world, extrinsic 4x4 used as
    the OpenCV w2c (the trajectory matrix as it is), colors [N, C]. Each
    point covers the pixels whose centres fall within the NDC radius; the
    least z per pixel wins. Returns (image [H, W, C], mask [H, W])."""
    dev = points.device
    e = _as_f32(extrinsic, dev)
    pc = _mat3(e[:3, :3], points.T.float()) + e[:3, 3][:, None]  # [3, N]
    z = pc[2]
    ok0 = z > 1e-6
    safe_z = torch.where(ok0, z, torch.ones_like(z))
    uvw = _mat3(_as_f32(intrinsic, dev), pc / safe_z[None])
    uf, vf = uvw[0], uvw[1]

    radius_px = radius_ndc * min(h, w) / 2.0
    n = points.shape[0]
    offs = torch.tensor(_disk_offsets(radius_px), dtype=torch.int32,
                        device=dev)                          # [K, 2]
    # every (offset, point) pair, offset-major as JAX concatenates them
    px = torch.floor(uf).int()[None] + offs[:, 1:2]          # [K, N]
    py = torch.floor(vf).int()[None] + offs[:, 0:1]
    dist2 = (uf[None] - px.float()) ** 2 + (vf[None] - py.float()) ** 2
    ok = (ok0[None] & (dist2 <= radius_px ** 2) & (px >= 0) & (px < w)
          & (py >= 0) & (py < h))
    flat = (py * w + px.clamp(0, w - 1)).long()
    pid = torch.arange(n, device=dev).expand(len(offs), n)
    color, _, mask = _winner_take_all(
        flat.reshape(1, -1), z.expand(len(offs), n).reshape(1, -1), colors,
        ok.reshape(1, -1), h * w, pid.reshape(1, -1))
    return color.reshape(h, w, -1), mask.reshape(h, w)


def morph_open(mask: np.ndarray, ksize: int = 5) -> np.ndarray:
    """Binary morphological open (erode then dilate) with a ksize x ksize
    ones kernel, the post-splat cleanup: cv2 on the host for its border
    handling, scipy where cv2 is missing (as the JAX package)."""
    try:
        import cv2
        return cv2.morphologyEx(mask.astype(np.uint8), cv2.MORPH_OPEN,
                                np.ones((ksize, ksize), np.uint8)
                                ).astype(mask.dtype)
    except ImportError:
        from scipy import ndimage
        st = np.ones((ksize, ksize), bool)
        return ndimage.binary_opening(mask.astype(bool), structure=st).astype(
            mask.dtype)
