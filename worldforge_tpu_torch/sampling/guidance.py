"""WorldForge guidance pieces: the pixel-space latent fusion of IRR.

Counterpart of ``worldforge_tpu/sampling/guidance.py``: ``fuse_latents``
decodes pred_x0, blends it with the reference video under the mask and
re-encodes it, on the device.

FLF channel selection (``GuidanceConfig.use_flf``) needs the optical-flow
ops and ``sampling/channel_select.py``, which are the next slice of the
port: ``flf_select`` raises when it is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

FLF_NOT_PORTED = (
    "FLF channel selection (use_flf / --use-pca-channel-selection) needs "
    "ops/farneback.py, ops/flow.py and sampling/channel_select.py, which are "
    "slice 2 of the port; run with use_flf=False")


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """The reference's flag surface (same fields and defaults as the JAX
    package; ``use_flf=True`` raises in this slice)."""
    guided: bool = True
    guide_steps: int = 15
    resample_steps: int = 2       # IRR inner iterations
    resample_round: int = 20      # steps after which IRR stops
    omega: float = 4.0            # DSG strength while i < guide_steps
    omega_resample: float = 1.0   # DSG strength after guide_steps
    use_flf: bool = True          # flow-guided channel selection
    flf_backend: str = "wan"      # 'wan' | 'longcat' selection schedule
    distill: bool = False         # LongCat distilled schedule
    max_replace: Optional[int] = None
    use_optical_flow: bool = True  # False -> temporal-difference fallback


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(method="linear")`` on one
    axis: a triangle kernel at half-pixel centres, widened by the scale when
    downsampling (antialiasing), each column normalised, samples outside the
    input zeroed. Computed in float32, as JAX computes them."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = 1.0 / scale
    kscale = max(float(inv), 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * float(inv)
              - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize(method="nearest")``: floor((i + 0.5) * in / out),
    in float32."""
    off = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return torch.floor(off).to(torch.int64).to(device)


def resize_video_like(x: torch.Tensor, target_shape, method: str
                      ) -> torch.Tensor:
    """Resize [B, C, T, H, W] to ``target_shape`` with the semantics of
    ``jax.image.resize`` (not ``F.interpolate``: half-pixel centres and an
    antialiasing triangle filter when ``linear`` downsamples). A batch of 1
    broadcasts to the target batch first."""
    if tuple(x.shape) == tuple(target_shape):
        return x
    if x.shape[0] != target_shape[0]:
        x = x.expand((target_shape[0],) + tuple(x.shape[1:]))
    if method not in ("linear", "nearest"):
        raise ValueError(f"unsupported resize method {method!r}")
    for d, n_out in enumerate(target_shape):
        n_in = x.shape[d]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = torch.index_select(x, d, _nearest_index(n_in, n_out,
                                                        x.device))
        else:
            w = _linear_weights(n_in, n_out, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def fuse_latents(pred_x0: torch.Tensor,
                 video_ref: torch.Tensor,
                 mask: torch.Tensor,
                 vae_decode: Callable[[torch.Tensor], torch.Tensor],
                 vae_encode: Callable[[torch.Tensor], torch.Tensor],
                 *,
                 flf_channels: Optional[Sequence[int]] = None
                 ) -> torch.Tensor:
    """decode(pred_x0) -> ref*m + gen*(1-m) -> encode.

    pred_x0: [B, z, T', H', W'] normalized latents.
    video_ref: [B, 3, T, H, W] reference pixels in [0, 1] (scaled to [-1, 1]
    here). mask: [B, 1, T, H, W], 1 = use reference.
    vae_decode / vae_encode close over the VAE params and handle the
    per-channel latent normalization."""
    if flf_channels:
        raise NotImplementedError(FLF_NOT_PORTED)
    decoded = vae_decode(pred_x0)  # [B, 3, T, H, W] in [-1, 1]
    tgt = decoded.shape
    ref = resize_video_like(video_ref.to(decoded.dtype), tgt, "linear")
    m = resize_video_like(mask.to(decoded.dtype),
                          (tgt[0], 1, tgt[2], tgt[3], tgt[4]), "nearest")
    ref = 2.0 * ref - 1.0
    fused = ref * m + decoded * (1.0 - m)
    return vae_encode(fused).to(pred_x0.dtype)


def flf_select(pred_x0: torch.Tensor, encoded_ref: torch.Tensor,
               current_step: int, cfg: GuidanceConfig) -> List[int]:
    """FLF channel selection: [] when it is off; raises when it is on (a
    later slice of the port)."""
    if not cfg.use_flf:
        return []
    raise NotImplementedError(FLF_NOT_PORTED)
