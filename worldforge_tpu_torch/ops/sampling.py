"""Align-corners linear resizes (counterpart of the resize half of
``worldforge_tpu/ops/sampling.py``).

``F.interpolate(mode='trilinear', align_corners=True)`` is separable, so a
3D resize composes from one 1D linear resample per axis. This is the
refine upscale's resize (``pipelines/longcat.py``), not the half-pixel
mapping of ``jax.image.resize``.
"""

from __future__ import annotations

import torch


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
