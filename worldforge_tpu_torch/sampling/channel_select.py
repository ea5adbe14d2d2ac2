"""FLF (flow-guided latent fusion) channel selection.

Counterpart of ``worldforge_tpu/sampling/channel_select.py``. Per latent
channel, the optical flow over frame pairs is taken for the generated
pred_x0 and for the fused reference, and a similarity score combines
M-EPE, Fl-all and M-AE:

  wan:      similarity = 1 - (0.45*clip(EPE/10) + 0.45*clip(Fl/0.5)
                              + 0.1*clip(AE/30)), outliers EPE > 3 AND
                              EPE > 5% of |ref flow|
  longcat:  weights 0.4 / 0.4 / 0.2, outliers with OR

A step-dependent schedule then picks the LOW-similarity channels, which
are handed back to the generated latents:

  Wan: step < 2 -> none; <= 5 -> none; <= 10 -> worst 1; else threshold
  mean - 0.625*std, at least 2 and at most 6.
  LongCat: distill: <= 3 worst 1, else the threshold with at most
  max_replace (default 3); standard: <= 5 worst 1, else at most
  max_replace (default 1).

The flows and scores run on the device in one batched call; the [C] score
vector comes to the host once, and the host schedules use numpy
(``np.argsort``), so ties break as in the JAX package. The device-mask
schedules are the same rules as rank arithmetic on a device tensor (a
stable argsort, std with ddof 0).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from worldforge_tpu_torch.ops.flow import video_channel_flows_pair


def _flow_similarity_scores(pred_flows: torch.Tensor,
                            ref_flows: torch.Tensor,
                            variant: str = "wan") -> torch.Tensor:
    """similarity [C] from per-channel flows [B, C, T-1, 2, H, W]."""
    diff = pred_flows - ref_flows
    epe = torch.sqrt((diff ** 2).sum(dim=3) + 1e-8)      # [B,C,T-1,H,W]

    dot = (ref_flows * pred_flows).sum(dim=3)
    nr = torch.sqrt((ref_flows ** 2).sum(dim=3) + 1e-8)
    nc = torch.sqrt((pred_flows ** 2).sum(dim=3) + 1e-8)
    cos = torch.clamp(dot / (nr * nc + 1e-8), -1.0, 1.0)
    ae = torch.arccos(cos) * (180.0 / math.pi)

    if variant == "wan":
        outlier = ((epe > 3.0) & (epe > nr * 0.05)).float()
        w_epe, w_fl, w_ae = 0.45, 0.45, 0.1
    else:
        outlier = ((epe > 3.0) | (epe > nr * 0.05)).float()
        w_epe, w_fl, w_ae = 0.4, 0.4, 0.2

    axes = (0, 2, 3, 4)
    m_epe = epe.mean(dim=axes)
    m_ae = ae.mean(dim=axes)
    fl_all = outlier.mean(dim=axes)

    err = (w_epe * torch.clamp(m_epe / 10.0, 0.0, 1.0)
           + w_fl * torch.clamp(fl_all / 0.5, 0.0, 1.0)
           + w_ae * torch.clamp(m_ae / 30.0, 0.0, 1.0))
    return torch.clamp(1.0 - err, 0.0, 1.0)


def _temporal_diff_motion(video: torch.Tensor) -> torch.Tensor:
    """Fallback motion features: per-channel frame differences repeated to
    the 2-channel flow layout [B, C, T-1, 2, H, W]."""
    d = (video[:, :, 1:] - video[:, :, :-1]).float()
    return torch.stack([d, d], dim=3)


def channel_similarities(pred_x0: torch.Tensor, ref_latents: torch.Tensor,
                         use_optical_flow: bool = True,
                         variant: str = "wan") -> np.ndarray:
    """Per-channel flow-similarity scores [C] as host numpy float32 (the one
    device-to-host transfer of a selection)."""
    if use_optical_flow:
        pf, rf = video_channel_flows_pair(pred_x0, ref_latents)
    else:
        pf = _temporal_diff_motion(pred_x0)
        rf = _temporal_diff_motion(ref_latents)
    return _flow_similarity_scores(pf, rf, variant=variant).cpu().numpy()


def select_channels_wan(scores: np.ndarray, current_step: int) -> List[int]:
    """Wan schedule. Returns the sorted channel indices to hand back to the
    generated latents."""
    if current_step < 2:
        return []
    order = np.argsort(scores)
    if current_step <= 10:
        max_replace = 0 if current_step <= 5 else 1
        sel = order[:max_replace].tolist()
    else:
        threshold = scores.mean() - 0.625 * scores.std()
        below = [i for i, s in enumerate(scores) if s < threshold]
        if len(below) < 2:
            sel = order[:2].tolist()
        elif len(below) > 6:
            below.sort(key=lambda i: scores[i])
            sel = below[:6]
        else:
            sel = below
    return sorted(int(i) for i in sel)


def select_channels_longcat(scores: np.ndarray, current_step: int,
                            distill: bool, max_replace: Optional[int] = None
                            ) -> List[int]:
    """LongCat schedule: warm-up takes the single worst channel; after it
    the mean - 0.625*std threshold with at least 1 and at most max_replace
    channels (3 distilled, 1 standard by default)."""
    if current_step < 2:
        return []
    order = np.argsort(scores)
    warm = current_step <= (3 if distill else 5)
    if warm:
        return sorted(int(i) for i in order[:1].tolist())
    max_n = max_replace if max_replace is not None else (3 if distill else 1)
    threshold = scores.mean() - 0.625 * scores.std()
    below = [i for i, s in enumerate(scores) if s < threshold]
    if len(below) < 1:
        sel = order[:1].tolist()
    elif len(below) > max_n:
        below.sort(key=lambda i: scores[i])
        sel = below[:max_n]
    else:
        sel = below
    return sorted(int(i) for i in sel)


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(scores.shape[0], device=scores.device)
    return ranks


def _below_threshold(scores: torch.Tensor):
    thr = scores.mean() - 0.625 * scores.std(correction=0)
    below = scores < thr
    return below, below.sum()


def select_mask_wan_device(scores: torch.Tensor, step) -> torch.Tensor:
    """The Wan schedule as a float mask [C] on the scores' device (1 = hand
    the channel back). Below-threshold channels are exactly the lowest
    ranked, so the min-2 / max-6 clamps are rank comparisons."""
    c = scores.shape[0]
    ranks = _ranks(scores)
    below, nbelow = _below_threshold(scores)
    sel_late = torch.where(nbelow < 2, ranks < 2,
                           torch.where(nbelow > 6, below & (ranks < 6), below))
    none = torch.zeros((c,), dtype=torch.bool, device=scores.device)
    step = torch.as_tensor(step, device=scores.device)
    mask = torch.where(step <= 5, none,
                       torch.where(step <= 10, ranks < 1, sel_late))
    return torch.where(step < 2, none, mask).float()


def select_mask_longcat_device(scores: torch.Tensor, step, distill: bool,
                               max_replace: Optional[int] = None
                               ) -> torch.Tensor:
    """The LongCat schedule as a float mask [C] on the scores' device."""
    c = scores.shape[0]
    ranks = _ranks(scores)
    n_late = max_replace if max_replace is not None else (3 if distill else 1)
    step = torch.as_tensor(step, device=scores.device)
    early = step <= (3 if distill else 5)
    below, nbelow = _below_threshold(scores)
    sel_late = torch.where(
        nbelow < 1, ranks < 1,
        torch.where(nbelow > n_late, below & (ranks < n_late), below))
    mask = torch.where(early, ranks < 1, sel_late)
    none = torch.zeros((c,), dtype=torch.bool, device=scores.device)
    return torch.where(step < 2, none, mask).float()


def apply_channel_replacement(encoded_ref: torch.Tensor,
                              pred_x0: torch.Tensor,
                              channels: Sequence[int]) -> torch.Tensor:
    """Give the selected (low-similarity) channels of the fused reference
    back to the generated latents."""
    if not channels:
        return encoded_ref
    mask = np.zeros((encoded_ref.shape[1],), np.float32)
    mask[list(channels)] = 1.0
    m = torch.from_numpy(mask).to(encoded_ref.device)[None, :, None, None,
                                                       None]
    return encoded_ref * (1.0 - m) + pred_x0.to(encoded_ref.dtype) * m
