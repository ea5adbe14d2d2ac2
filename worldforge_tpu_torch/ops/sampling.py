"""Resizes: align-corners linear (counterpart of the resize half of
``worldforge_tpu/ops/sampling.py``) and the per-axis weights of
``jax.image.resize`` (linear and bicubic).

``F.interpolate(mode='trilinear', align_corners=True)`` is separable, so a
3D resize composes from one 1D linear resample per axis. This is the
refine upscale's resize (``pipelines/longcat.py``) and, in 2-D, the VGGT
DPT head's. The half-pixel mapping of ``jax.image.resize``
(``jax_linear_weights``, ``jax_nearest_index``) is the guided fuse's resize
(``sampling/guidance.py``) and the LK flow's (``ops/flow.py``); its bicubic
weights resize the DINO position embedding (``models/vggt/vit.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from worldforge_tpu_torch.core.consts import device_constant


def interp1d_align_corners(x: torch.Tensor, n_out: int, axis: int
                           ) -> torch.Tensor:
    """Linear align_corners=True resample of ``x`` along ``axis``."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    p = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float32,
                       device=x.device)
    i0 = torch.floor(p).long()
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    shape = [1] * x.ndim
    shape[axis] = n_out
    w1 = (p - i0.float()).to(x.dtype).reshape(shape)
    x0 = torch.index_select(x, axis, i0)
    x1 = torch.index_select(x, axis, i1)
    return x0 * (1.0 - w1) + x1 * w1


def resize3d_align_corners(x: torch.Tensor, t: int, h: int, w: int
                           ) -> torch.Tensor:
    """align_corners=True trilinear resize of [B, C, T, H, W]."""
    x = interp1d_align_corners(x, t, axis=2)
    x = interp1d_align_corners(x, h, axis=3)
    return interp1d_align_corners(x, w, axis=4)


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of [B, H, W, C] (the 2-D resize of
    ``worldforge_tpu/ops/sampling.py``): a lerp along W, then along H, the
    border clamped."""
    return interp1d_align_corners(interp1d_align_corners(x, w, axis=2), h,
                                  axis=1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 on |x|, as ``jax.image.resize`` builds it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def jax_linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(method="linear")`` on one
    axis: a triangle kernel at half-pixel centres, widened by the scale when
    downsampling (antialiasing), each column normalised, samples outside the
    input zeroed. Computed in float32, as JAX computes them."""
    return device_constant(
        ("jax_linear_weights", n_in, n_out),
        lambda: _jax_weights(n_in, n_out, "cpu",
                             lambda x: torch.clamp(1.0 - x, min=0.0)),
        device)


def jax_cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The same for ``method="bicubic"``: Keys' cubic (a = -0.5, not
    ``F.interpolate``'s -0.75), antialiased when downsampling."""
    return _jax_weights(n_in, n_out, device, _keys_cubic)


def jax_resize2d(x: torch.Tensor, h: int, w: int, weights) -> torch.Tensor:
    """``jax.image.resize`` of [B, H, W, C] to [B, h, w, C] with one of the
    weight builders above, as JAX contracts it (one einsum, fp32)."""
    wh = weights(x.shape[1], h, x.device)
    ww = weights(x.shape[2], w, x.device)
    return torch.einsum("bhwc,hy,wx->byxc", x.float(), wh, ww).to(x.dtype)


def _jax_weights(n_in: int, n_out: int, device, kernel) -> torch.Tensor:
    scale = np.float32(n_out) / np.float32(n_in)
    inv = 1.0 / scale
    kscale = max(float(inv), 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * float(inv)
              - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kscale
    w = kernel(x)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def jax_nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(method="nearest")``: floor((i + 0.5) * in / out),
    in float32."""
    def make():
        off = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(off).to(torch.int64)
    return device_constant(("jax_nearest_index", n_in, n_out), make, device)
