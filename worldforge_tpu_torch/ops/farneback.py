"""Farneback dense optical flow, cv2-exact, batched over frame pairs.

Counterpart of ``worldforge_tpu/ops/farneback.py``: OpenCV's
``calcOpticalFlowFarneback(flags=0)`` (pyr_scale 0.5, levels 3, winsize
15, iterations 3, poly_n 5, poly_sigma 1.2 by default) over a batch of
frame pairs in one call on the device, the way FLF channel selection asks
for it (16 channels x 2 videos x (T - 1) pairs per guided step):

- polynomial expansion: separable Gaussian-weighted least squares with
  replicate borders, the (1, x, y, x^2, y^2, xy) basis and the sparse
  inverse-Gram coefficients (ig11 / ig03 / ig33 / ig55);
- displacement update: bilinear warp of the second expansion, A averaging
  (0.5 / cross term 0.25), the out-of-border fallback, the 5-px border
  down-weighting ramp (0.14, 0.14, 0.4472, ...);
- flow solve: 15x15 replicate-padded box blur of the 2x2 normal equations,
  determinant regulariser +1e-3;
- pyramid: levels capped so every level stays >= 32 px (latent-sized
  inputs run one level), a per-level Gaussian presmooth of the full-size
  image with sigma = (1/scale - 1)/2 and reflect-101 borders (the OpenCV
  small-kernel table at sigma 0), then cv2's INTER_LINEAR resize; the flow
  is upsampled and scaled by 1/pyr_scale between levels.

The host tables are built as the JAX package builds them (float64, then
float32). Every correlation is fp32 shift-and-add on the tensors' device:
no cuDNN convolution, so no TF32 rounding on the card, where the JAX code
runs its convolutions at ``Precision.HIGHEST``. Plain tensor code in the
JAX package too (no Pallas kernel), so plain tensor code here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core.consts import device_constant

# --- host tables (float64 -> float32, OpenCV's) ----------------------------

_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125], np.float32),
}


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel semantics (incl. the small-kernel table)."""
    if sigma <= 0 and ksize <= 7:
        return _SMALL_GAUSSIAN_TAB[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _poly_exp_kernels(n: int, sigma: float):
    """Applicability kernels g / xg / xxg and the inverse-Gram coefficients."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    # OpenCV normalises in float32 then promotes; keep that rounding
    g = (g / g.sum()).astype(np.float32).astype(np.float64)
    xg = x * g
    xxg = x * x * g
    G = np.zeros((6, 6))
    G[0, 0] = (g[:, None] * g[None, :]).sum()
    G[1, 1] = (g[:, None] * (g * x * x)[None, :]).sum()
    G[3, 3] = (g[:, None] * (g * x ** 4)[None, :]).sum()
    G[5, 5] = ((g * x * x)[:, None] * (g * x * x)[None, :]).sum()
    G[2, 2] = G[1, 1]
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    coeffs = (invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5])
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32), coeffs)


def _border_scale(h: int, w: int) -> np.ndarray:
    """5-px edge down-weighting ramp applied to the normal equations."""
    bw = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
    sy = np.ones(h, np.float32)
    sx = np.ones(w, np.float32)
    for i in range(min(5, (h + 1) // 2)):
        sy[i] *= bw[i]
        sy[h - 1 - i] *= bw[i]
    for i in range(min(5, (w + 1) // 2)):
        sx[i] *= bw[i]
        sx[w - 1 - i] *= bw[i]
    return sy[:, None] * sx[None, :]


def _pyramid_plan(h: int, w: int, pyr_scale: float, levels: int,
                  min_size: int = 32) -> List[Tuple[int, int, float]]:
    """(h_k, w_k, scale_k) coarsest first, with OpenCV's >= 32 px cap."""
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < min_size or h * scale < min_size:
            break
        k += 1
    plan = []
    for lvl in range(k, -1, -1):
        s = pyr_scale ** lvl
        plan.append((int(round(h * s)), int(round(w * s)), s))
    return plan


# --- device helpers --------------------------------------------------------


def _taps(xp: torch.Tensor, k: Sequence[float], axis: int, n_out: int
          ) -> torch.Tensor:
    """Valid correlation of the padded ``xp`` with taps ``k`` along
    ``axis``, as fp32 shift-and-add."""
    out = None
    for i, kv in enumerate(k):
        term = xp.narrow(axis, i, n_out) * float(kv)
        out = term if out is None else out + term
    return out


def _corr1d(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """1-D correlation along ``axis`` (1 = H, 2 = W) of [N, H, W],
    replicate border."""
    n = (len(k) - 1) // 2
    pad = (0, 0, n, n) if axis == 1 else (n, n, 0, 0)
    xp = F.pad(x[:, None], pad, mode="replicate")[:, 0]
    return _taps(xp, k, axis, x.shape[axis])


def _poly_exp(img: torch.Tensor, g, xg, xxg, coeffs) -> torch.Tensor:
    """Polynomial expansion of [N, H, W] -> [N, H, W, 5] channels
    (b_y, b_x, a_yy, a_xx, a_xy) in OpenCV's storage order."""
    ig11, ig03, ig33, ig55 = (float(c) for c in coeffs)
    b0 = _corr1d(img, g, axis=1)          # even in y
    b1 = _corr1d(img, xg, axis=1)         # odd in y
    b2 = _corr1d(img, xxg, axis=1)        # even in y
    B1 = _corr1d(b0, g, axis=2)
    B2 = _corr1d(b0, xg, axis=2)
    B4 = _corr1d(b0, xxg, axis=2)
    B3 = _corr1d(b1, g, axis=2)
    B6 = _corr1d(b1, xg, axis=2)
    B5 = _corr1d(b2, g, axis=2)
    return torch.stack([
        B3 * ig11,                         # b_y
        B2 * ig11,                         # b_x
        B1 * ig03 + B5 * ig33,             # a_yy
        B1 * ig03 + B4 * ig33,             # a_xx
        B6 * ig55,                         # a_xy
    ], dim=-1)


def _update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                     border: torch.Tensor) -> torch.Tensor:
    """Per-pixel 2x2 normal equations M = (G11, G12, G22, h1, h2)
    [N, H, W, 5]."""
    n, h, w = flow.shape[:3]
    dev = flow.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dx = flow[..., 0]
    dy = flow[..., 1]
    fx = xx[None] + dx
    fy = yy[None] + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    fxf = fx - x1
    fyf = fy - y1
    inb = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    x1c = torch.clamp(x1, 0, w - 2).to(torch.int64)
    y1c = torch.clamp(y1, 0, h - 2).to(torch.int64)

    flat = R1.reshape(n, h * w, 5)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, 5)
        return torch.gather(flat, 1, idx).reshape(n, h, w, 5)

    a00 = ((1 - fxf) * (1 - fyf))[..., None]
    a01 = (fxf * (1 - fyf))[..., None]
    a10 = ((1 - fxf) * fyf)[..., None]
    a11 = (fxf * fyf)[..., None]
    samp = (a00 * gather(y1c, x1c) + a01 * gather(y1c, x1c + 1)
            + a10 * gather(y1c + 1, x1c) + a11 * gather(y1c + 1, x1c + 1))

    zero = torch.zeros((), dtype=samp.dtype, device=dev)
    r2 = torch.where(inb, samp[..., 0], zero)
    r3 = torch.where(inb, samp[..., 1], zero)
    r4 = torch.where(inb, (R0[..., 2] + samp[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inb, (R0[..., 3] + samp[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inb, (R0[..., 4] + samp[..., 4]) * 0.25,
                     R0[..., 4] * 0.5)
    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    sc = border[None]
    r2 = r2 * sc
    r3 = r3 * sc
    r4 = r4 * sc
    r5 = r5 * sc
    r6 = r6 * sc
    return torch.stack([r4 * r4 + r6 * r6,
                        (r4 + r5) * r6,
                        r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=-1)


def _box_blur(M: torch.Tensor, m: int) -> torch.Tensor:
    """Replicate-padded (2m+1)^2 box sum over [N, H, W, 5]."""
    ones = np.ones(2 * m + 1, np.float32)
    n, h, w, c = M.shape
    x = M.permute(0, 3, 1, 2).reshape(n * c, h, w)
    y = _corr1d(_corr1d(x, ones, axis=1), ones, axis=2)
    return y.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _update_flow(M: torch.Tensor, block_size: int) -> torch.Tensor:
    m = block_size // 2
    scale = 1.0 / (block_size * block_size)
    S = _box_blur(M, m) * scale
    g11, g12, g22, h1, h2 = S.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-1)


def _resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cv2 INTER_LINEAR (half-pixel centres, clamped, no anti-aliasing)
    over the H, W axes of [N, H0, W0, C]."""
    n, h0, w0, c = x.shape
    dev = x.device
    sy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (h0 / h) - 0.5
    sx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (w0 / w) - 0.5
    y0 = torch.clamp(torch.floor(sy), 0, h0 - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), 0, w0 - 1).to(torch.int64)
    wy = torch.clamp(sy - y0, 0.0, 1.0)
    wx = torch.clamp(sx - x0, 0.0, 1.0)
    y1 = torch.clamp(y0 + 1, max=h0 - 1)
    x1 = torch.clamp(x0 + 1, max=w0 - 1)
    rows0, rows1 = x[:, y0], x[:, y1]
    wx_ = wx[None, None, :, None]
    top = rows0[:, :, x0] * (1 - wx_) + rows0[:, :, x1] * wx_
    bot = rows1[:, :, x0] * (1 - wx_) + rows1[:, :, x1] * wx_
    return top * (1 - wy)[None, :, None, None] + bot * wy[None, :, None, None]


def _presmooth(img: torch.Tensor, smooth: np.ndarray) -> torch.Tensor:
    """Separable Gaussian of [N, H, W] with reflect-101 borders."""
    pad = len(smooth) // 2
    n, h, w = img.shape
    f = F.pad(img[:, None], (pad, pad, pad, pad), mode="reflect")[:, 0]
    f = _taps(f, smooth, 1, h)
    return _taps(f, smooth, 2, w)


# --- top level --------------------------------------------------------------


def farneback_flow(i1: torch.Tensor, i2: torch.Tensor, *,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3,
                   poly_n: int = 5, poly_sigma: float = 1.2) -> torch.Tensor:
    """cv2.calcOpticalFlowFarneback(flags=0) over a batch.

    i1, i2: [N, H, W] on the uint8 value scale (0..255); the caller
    quantizes. Returns [N, H, W, 2] fp32 with channels (dx, dy), on the
    inputs' device."""
    i1 = i1.float()
    i2 = i2.float()
    n, h, w = i1.shape
    g, xg, xxg, coeffs = _poly_exp_kernels(poly_n, poly_sigma)

    flow = None
    for (hk, wk, scale) in _pyramid_plan(h, w, pyr_scale, levels):
        sigma_s = (1.0 / scale - 1.0) * 0.5
        ksz = max(int(round(sigma_s * 5)) | 1, 3)
        smooth = _gaussian_kernel(ksz, sigma_s)
        imgs = []
        for img in (i1, i2):
            f = _presmooth(img, smooth)
            if (hk, wk) != (h, w):
                f = _resize_linear(f[..., None], hk, wk)[..., 0]
            imgs.append(f)
        R0 = _poly_exp(imgs[0], g, xg, xxg, coeffs)
        R1 = _poly_exp(imgs[1], g, xg, xxg, coeffs)
        if flow is None:
            flow = torch.zeros((n, hk, wk, 2), dtype=torch.float32,
                               device=i1.device)
        elif flow.shape[1:3] != (hk, wk):
            flow = _resize_linear(flow, hk, wk) * (1.0 / pyr_scale)
        border = device_constant(
            ("farneback_border", hk, wk),
            lambda: torch.from_numpy(_border_scale(hk, wk)), i1.device)
        M = _update_matrices(R0, R1, flow, border)
        for it in range(iterations):
            flow = _update_flow(M, winsize)
            if it < iterations - 1:
                M = _update_matrices(R0, R1, flow, border)
    return flow
