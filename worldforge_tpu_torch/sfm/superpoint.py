"""SuperPoint keypoint detector and descriptor.

Counterpart of ``worldforge_tpu/sfm/superpoint.py`` (the MagicLeap
architecture as the ``lightglue`` package ships it): a VGG-style encoder
to stride 8, a 65-way detector head (64 cells and a dustbin) unshuffled
to a full-resolution heat map, iterated max-pool NMS, a 4-pixel border,
a threshold and a fixed ``max_num_keypoints`` (padded entries are (-1, -1)
with score -1), and L2-normalised descriptors sampled bilinearly at the
keypoints.

The top-k is a stable descending sort, which keeps ``jax.lax.top_k``'s
order on ties (the lower flat index first); ``torch.topk`` promises no
order there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import conv as _sd_conv
from worldforge_tpu_torch.ops.sampling import bilinear_sample

_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    channels: Tuple[int, ...] = (64, 64, 64, 64, 128, 128, 128, 128)
    descriptor_dim: int = 256
    nms_radius: int = 4
    detection_threshold: float = 0.005
    max_num_keypoints: int = 2048

    @classmethod
    def tiny(cls) -> "SuperPointConfig":
        return cls(channels=(8, 8, 8, 8, 16, 16, 16, 16), descriptor_dim=32,
                   max_num_keypoints=32)


def init_superpoint(gen: torch.Generator, cfg: SuperPointConfig,
                    dtype=torch.float32) -> dict:
    c = cfg.channels
    shapes = ((1, c[0], 3), (c[0], c[1], 3), (c[1], c[2], 3),
              (c[2], c[3], 3), (c[3], c[4], 3), (c[4], c[5], 3),
              (c[5], c[6], 3), (c[6], c[7], 3), (c[7], 256, 3),
              (256, 65, 1), (c[7], 256, 3), (256, cfg.descriptor_dim, 1))
    return {name: P.conv_init(gen, cin, cout, (k, k), dtype=dtype)
            for name, (cin, cout, k) in zip(_CONVS, shapes)}


def _conv(p, x, relu=True):
    y = P.conv(p, x, padding=p["w"].shape[0] // 2)
    return F.relu(y) if relu else y


def _pool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Iterated max-pool suppression of scores [B, H, W]."""
    k = 2 * radius + 1

    def maxpool(x):
        return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == maxpool(scores)
    for _ in range(2):
        supp = maxpool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp, zeros, scores)
        new_max = supp_scores == maxpool(supp_scores)
        max_mask = max_mask | (new_max & (~supp))
    return torch.where(max_mask, scores, zeros)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of x [B, M] and their indices, ties in
    ``jax.lax.top_k``'s order (the lower index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def superpoint_forward(params, cfg: SuperPointConfig, image: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """image [B, H, W, 1] grey in [0, 1] -> keypoints [B, K, 2] (x, y;
    padding (-1, -1)), scores [B, K] (padding -1), descriptors [B, K, D]
    (padding rows 0). The heat map covers the largest multiple of 8."""
    b = image.shape[0]
    x = _conv(params["conv1a"], image.float())
    x = _pool2(_conv(params["conv1b"], x))
    x = _conv(params["conv2a"], x)
    x = _pool2(_conv(params["conv2b"], x))
    x = _conv(params["conv3a"], x)
    x = _pool2(_conv(params["conv3b"], x))
    x = _conv(params["conv4a"], x)
    feat = _conv(params["conv4b"], x)                     # [B, H/8, W/8, C]

    det = _conv(params["convPb"], _conv(params["convPa"], feat), relu=False)
    det = torch.softmax(det, dim=-1)[..., :64]
    gh, gw = det.shape[1:3]
    heat = det.reshape(b, gh, gw, 8, 8).permute(0, 1, 3, 2, 4)
    heat = simple_nms(heat.reshape(b, gh * 8, gw * 8), cfg.nms_radius)
    bd = 4
    border = torch.zeros((gh * 8, gw * 8), dtype=torch.bool,
                         device=heat.device)
    border[bd:gh * 8 - bd, bd:gw * 8 - bd] = True
    heat = torch.where(border[None], heat, torch.zeros_like(heat))
    flat = heat.reshape(b, -1)
    flat = torch.where(flat > cfg.detection_threshold, flat,
                       torch.full_like(flat, -1.0))
    scores, idx = top_k(flat, min(cfg.max_num_keypoints, flat.shape[1]))
    xy = torch.stack([(idx % (gw * 8)).float(),
                      torch.div(idx, gw * 8, rounding_mode="floor").float()],
                     dim=-1)
    valid = scores > 0
    kpts = torch.where(valid[..., None], xy, torch.full_like(xy, -1.0))

    desc = _conv(params["convDb"], _conv(params["convDa"], feat), relu=False)
    desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    # keypoint pixel -> the coarse grid (cell centres, stride 8)
    d = bilinear_sample(desc, (xy - 3.5) / 8.0, padding="border")
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    d = torch.where(valid[..., None], d, torch.zeros_like(d))
    return {"keypoints": kpts,
            "scores": torch.where(valid, scores, torch.full_like(scores,
                                                                 -1.0)),
            "descriptors": d}


def convert_superpoint(sd, cfg: SuperPointConfig, dtype=torch.float32,
                       device=None) -> dict:
    """A lightglue / MagicLeap state dict (``convNx.weight`` [out, in, k,
    k]) -> the tree (JAX :155)."""
    dev = resolve_device(device)
    return {name: _sd_conv(sd, name, dtype, dev) for name in _CONVS}
