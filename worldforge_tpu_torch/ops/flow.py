"""Per-channel optical flow of latent videos, batched over frame pairs.

Counterpart of ``worldforge_tpu/ops/flow.py``. FLF channel selection needs
the flow of every latent channel between consecutive frames, for the
generated pred_x0 and for the fused reference: all B * C * (T - 1) pairs of
both videos go through one call.

``method="farneback"`` (the default) runs ``ops/farneback.py``, the
reference's exact algorithm, on frames quantized to the uint8 scale as the
reference quantizes them; ``method="lk"`` is the pyramidal Lucas-Kanade
approximation (coarse-to-fine, Gaussian window sums), the JAX package's
opt-in. Plain tensor code on the inputs' device, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.ops.farneback import farneback_flow
from worldforge_tpu_torch.ops.sampling import jax_linear_weights


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _sep_blur(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable blur over the last two axes of [N, H, W], zero borders,
    as fp32 shift-and-add."""
    pad = len(k) // 2
    n, h, w = x.shape
    y = F.pad(x, (0, 0, pad, pad))
    y = sum(y[:, i:i + h] * float(kv) for i, kv in enumerate(k))
    y = F.pad(y, (pad, pad))
    return sum(y[:, :, i:i + w] * float(kv) for i, kv in enumerate(k))


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimation on [N, H, W]."""
    return _sep_blur(x, _gauss_kernel1d(1.0, 2))[:, ::2, ::2]


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, h, w), "bilinear")`` of [N, H0, W0]."""
    wy = jax_linear_weights(x.shape[1], h, x.device)
    wx = jax_linear_weights(x.shape[2], w, x.device)
    return torch.einsum("nyx,yh,xw->nhw", x, wy, wx)


def _grad(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference spatial gradients of [N, H, W] (wrapped)."""
    gx = (torch.roll(x, -1, dims=2) - torch.roll(x, 1, dims=2)) * 0.5
    gy = (torch.roll(x, -1, dims=1) - torch.roll(x, 1, dims=1)) * 0.5
    return gx, gy


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """Bilinear warp img [N, H, W] by flow (u, v): sample at (x+u, y+v)."""
    n, h, w = img.shape
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    sx = torch.clamp(xx[None] + u, 0.0, w - 1.0)
    sy = torch.clamp(yy[None] + v, 0.0, h - 1.0)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    wx = sx - x0
    wy = sy - y0
    flat = img.reshape(n, h * w)

    def gather(yi, xi):
        idx = yi.to(torch.int64) * w + xi.to(torch.int64)
        return torch.gather(flat, 1, idx.reshape(n, h * w)).reshape(n, h, w)

    i00 = gather(y0, x0)
    i01 = gather(y0, x1)
    i10 = gather(y1, x0)
    i11 = gather(y1, x1)
    return (i00 * (1 - wx) * (1 - wy) + i01 * wx * (1 - wy)
            + i10 * (1 - wx) * wy + i11 * wx * wy)


def _lk_level(i1, i2, u, v, win_kernel, iters: int):
    gx, gy = _grad(i1)
    blur = functools.partial(_sep_blur, k=win_kernel)
    sxx = blur(gx * gx)
    syy = blur(gy * gy)
    sxy = blur(gx * gy)
    det = sxx * syy - sxy * sxy
    inv = 1.0 / (det + 1e-6)
    for _ in range(iters):
        it = _warp(i2, u, v) - i1
        sxt = blur(gx * it)
        syt = blur(gy * it)
        du = -(syy * sxt - sxy * syt) * inv
        dv = -(sxx * syt - sxy * sxt) * inv
        u = u + torch.clamp(du, -2.0, 2.0)
        v = v + torch.clamp(dv, -2.0, 2.0)
    return u, v


def optical_flow(i1: torch.Tensor, i2: torch.Tensor, *, levels: int = 3,
                 iters: int = 3, win_radius: int = 3) -> torch.Tensor:
    """Pyramidal Lucas-Kanade flow from i1 to i2 ([N, H, W], any scale).
    Returns [N, 2, H, W]: channel 0 = u (x-flow), 1 = v (y-flow)."""
    i1 = i1.float()
    i2 = i2.float()
    win = _gauss_kernel1d(2.0, win_radius)

    pyr = [(i1, i2)]
    for _ in range(levels - 1):
        if min(pyr[-1][0].shape[1:]) < 8:
            break
        pyr.append((_downsample2(pyr[-1][0]), _downsample2(pyr[-1][1])))

    u = torch.zeros_like(pyr[-1][0])
    v = torch.zeros_like(pyr[-1][0])
    for li in range(len(pyr) - 1, -1, -1):
        a, b = pyr[li]
        if u.shape != a.shape:
            sy = a.shape[1] / u.shape[1]
            sx = a.shape[2] / u.shape[2]
            u = _resize_bilinear(u, a.shape[1], a.shape[2]) * sx
            v = _resize_bilinear(v, a.shape[1], a.shape[2]) * sy
        u, v = _lk_level(a, b, u, v, win, iters)
    return torch.stack([u, v], dim=1)


def _norm_frame_pairs(video: torch.Tensor, quantize: bool):
    """Per-tensor global min/max normalisation + frame pairing: the min
    and range are taken over the whole video, then
    ``floor((v - vmin) / vrange * 255)`` in that order when quantizing.
    Returns (i1, i2) of shape [B*C*(T-1), H, W]."""
    b, c, t, h, w = video.shape
    vf = video.float()
    vmin = vf.min()
    vrange = vf.max() - vmin + 1e-8
    vf = (vf - vmin) / vrange * 255.0
    if quantize:
        vf = torch.floor(vf)  # (v * 255).astype(uint8) truncation
    frames = vf.reshape(b * c, t, h, w)
    i1 = frames[:, :-1].reshape(b * c * (t - 1), h, w)
    i2 = frames[:, 1:].reshape(b * c * (t - 1), h, w)
    return i1, i2


def video_channel_flows_pair(*videos: torch.Tensor,
                             method: str = "farneback", levels: int = 3,
                             iters: int = 3):
    """Per-channel frame-pair flows for one or more same-shape videos
    [B, C, T, H, W], batched through one flow call (each video normalised
    by its own global min and range). Returns a tuple of
    [B, C, T-1, 2, H, W] fp32 tensors, one per input."""
    b, c, t, h, w = videos[0].shape
    quant = method == "farneback"
    pairs = [_norm_frame_pairs(v, quant) for v in videos]
    i1 = torch.cat([p[0] for p in pairs])
    i2 = torch.cat([p[1] for p in pairs])
    if quant:
        fl = farneback_flow(i1, i2, levels=levels,
                            iterations=iters).permute(0, 3, 1, 2)
    else:
        fl = optical_flow(i1, i2, levels=levels, iters=iters)
    n = b * c * (t - 1)
    return tuple(fl[i * n:(i + 1) * n].reshape(b, c, t - 1, 2, h, w)
                 for i in range(len(videos)))


def video_channel_flows(video: torch.Tensor, *, method: str = "farneback",
                        levels: int = 3, iters: int = 3) -> torch.Tensor:
    """Per-channel frame-pair flows of one latent video [B, C, T, H, W]
    -> [B, C, T-1, 2, H, W]."""
    return video_channel_flows_pair(video, method=method, levels=levels,
                                    iters=iters)[0]
