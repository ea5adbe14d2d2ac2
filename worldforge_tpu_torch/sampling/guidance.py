"""WorldForge guidance pieces: the pixel-space latent fusion of IRR and the
FLF channel selection.

Counterpart of ``worldforge_tpu/sampling/guidance.py``: ``fuse_latents``
decodes pred_x0, blends it with the reference video under the mask and
re-encodes it, on the device; ``flf_select`` picks the channels whose
flow disagrees most with the reference (``sampling/channel_select.py``),
which ``fuse_latents(flf_channels=...)`` hands back to pred_x0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from worldforge_tpu_torch.ops.sampling import (jax_linear_weights,
                                               jax_nearest_index)
from worldforge_tpu_torch.sampling.channel_select import (
    apply_channel_replacement, channel_similarities, select_channels_longcat,
    select_channels_wan)


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """The reference's flag surface (same fields and defaults as the JAX
    package)."""
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
            x = torch.index_select(x, d, jax_nearest_index(n_in, n_out,
                                                           x.device))
        else:
            w = jax_linear_weights(n_in, n_out, x.device).to(x.dtype)
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
    per-channel latent normalization.
    flf_channels: channel indices whose fused latents are replaced by the
    generated pred_x0 (from ``flf_select``)."""
    decoded = vae_decode(pred_x0)  # [B, 3, T, H, W] in [-1, 1]
    tgt = decoded.shape
    ref = resize_video_like(video_ref.to(decoded.dtype), tgt, "linear")
    m = resize_video_like(mask.to(decoded.dtype),
                          (tgt[0], 1, tgt[2], tgt[3], tgt[4]), "nearest")
    ref = 2.0 * ref - 1.0
    fused = ref * m + decoded * (1.0 - m)
    encoded = vae_encode(fused)
    if flf_channels:
        encoded = apply_channel_replacement(encoded, pred_x0, flf_channels)
    return encoded.to(pred_x0.dtype)


def flf_select(pred_x0: torch.Tensor, encoded_ref: torch.Tensor,
               current_step: int, cfg: GuidanceConfig) -> List[int]:
    """Pick the low-similarity channels by the backend's schedule."""
    if not cfg.use_flf:
        return []
    if current_step < 2:
        # both schedules return [] before step 2: skip the flows they would
        # discard
        return []
    scores = channel_similarities(pred_x0, encoded_ref,
                                  use_optical_flow=cfg.use_optical_flow,
                                  variant=cfg.flf_backend)
    if cfg.flf_backend == "wan":
        return select_channels_wan(scores, current_step)
    return select_channels_longcat(scores, current_step, cfg.distill,
                                   cfg.max_replace)


def guided_fuse(x0: torch.Tensor, video_ref: torch.Tensor, mask: torch.Tensor,
                vae_decode: Callable[[torch.Tensor], torch.Tensor],
                vae_encode: Callable[[torch.Tensor], torch.Tensor],
                step: int, cfg: GuidanceConfig, flf: bool = True
                ) -> torch.Tensor:
    """One guided step's fuse: ``fuse_latents``, then (``flf`` and
    ``cfg.use_flf``) ``flf_select`` scores the fused latents against the
    unfused x0 and the selected channels go back to the unfused values."""
    fused = fuse_latents(x0, video_ref, mask, vae_decode, vae_encode)
    if flf and cfg.use_flf:
        sel = flf_select(x0, fused, step, cfg)
        if sel:
            fused = apply_channel_replacement(fused, x0, sel)
    return fused
