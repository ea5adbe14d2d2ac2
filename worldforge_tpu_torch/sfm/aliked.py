"""ALIKED keypoint detector and descriptor (the tracking path's default
extractor).

Counterpart of ``worldforge_tpu/sfm/aliked.py`` (the published ALIKED as
the ``lightglue`` package ships it), NHWC, fp32:

  backbone   conv / residual blocks at scales 1, /2, /8, /32; blocks 3
             and 4 use 3x3 deformable convs; SELU; inference BatchNorm
  neck       1x1 convs to dim/4, align-corners bilinear upsampling, concat
  score head 1x1 -> 3x3 -> 3x3 -> 3x3 -> sigmoid
  DKD        NMS (radius 2), border and threshold mask, top-k, 5x5
             soft-argmax refinement (T = 0.1)
  SDDH       per keypoint a 3x3 patch -> offsets -> M deformable samples
             -> 1x1 conv, SELU -> aggregation -> L2

The deformable conv is JAX's gather and product, not
``torchvision.ops.deform_conv2d``: offsets clamped to +-max(H, W)/4, the
[dy, dx] pair layout, each bilinear corner outside the map read as 0. The
threshold falls back to an image's own mean score when nothing in that
image clears it. Static shapes: ``max_num_keypoints`` entries, padding
(-1, -1) with score -1; the top-k keeps ``jax.lax.top_k``'s tie order
(``superpoint.top_k``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.sfm.superpoint import simple_nms, top_k


@dataclasses.dataclass(frozen=True)
class ALIKEDConfig:
    # (c1, c2, c3, c4, dim, K, M) from the published configs
    c1: int = 16
    c2: int = 32
    c3: int = 64
    c4: int = 128
    dim: int = 128
    kernel_size: int = 3      # SDDH patch kernel K
    n_pos: int = 16           # SDDH sample positions M
    max_num_keypoints: int = 2048
    detection_threshold: float = 0.005
    nms_radius: int = 2

    @classmethod
    def n16(cls, **kw) -> "ALIKEDConfig":
        return cls(**kw)

    @classmethod
    def t16(cls, **kw) -> "ALIKEDConfig":
        return cls(c1=8, c2=16, c3=32, c4=64, dim=64, n_pos=16, **kw)

    @classmethod
    def n32(cls, **kw) -> "ALIKEDConfig":
        return cls(n_pos=32, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ALIKEDConfig":
        kw = {"max_num_keypoints": 64, **kw}
        return cls(c1=4, c2=8, c3=8, c4=8, dim=8, n_pos=4, **kw)


# ------------------------------------------------------------------ init


def _conv_init(gen, cin, cout, k, dtype, bias=True):
    p = {"w": P.normal(gen, (k, k, cin, cout),
                       1.0 / np.sqrt(cin * k * k)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=gen.device)
    return p


def _bn_init(c, dtype, dev):
    return {"scale": torch.ones((c,), dtype=dtype, device=dev),
            "bias": torch.zeros((c,), dtype=dtype, device=dev),
            "mean": torch.zeros((c,), dtype=dtype, device=dev),
            "var": torch.ones((c,), dtype=dtype, device=dev)}


def _convblock_init(gen, cin, cout, dtype, dcn=False):
    def mk(a, b):
        if dcn:
            return {"offset": _conv_init(gen, a, 18, 3, dtype),
                    "w": _conv_init(gen, a, b, 3, dtype, bias=False)["w"]}
        return _conv_init(gen, a, b, 3, dtype, bias=False)

    return {"conv1": mk(cin, cout), "bn1": _bn_init(cout, dtype, gen.device),
            "conv2": mk(cout, cout), "bn2": _bn_init(cout, dtype, gen.device)}


def _resblock_init(gen, cin, cout, dtype, dcn=False):
    p = _convblock_init(gen, cin, cout, dtype, dcn)
    p["downsample"] = _conv_init(gen, cin, cout, 1, dtype)
    return p


def init_aliked(gen: torch.Generator, cfg: ALIKEDConfig,
                dtype=torch.float32) -> dict:
    d4 = cfg.dim // 4
    return {
        "block1": _convblock_init(gen, 3, cfg.c1, dtype),
        "block2": _resblock_init(gen, cfg.c1, cfg.c2, dtype),
        "block3": _resblock_init(gen, cfg.c2, cfg.c3, dtype, dcn=True),
        "block4": _resblock_init(gen, cfg.c3, cfg.c4, dtype, dcn=True),
        # the neck and score-head convs have no bias
        "conv1": _conv_init(gen, cfg.c1, d4, 1, dtype, bias=False),
        "conv2": _conv_init(gen, cfg.c2, d4, 1, dtype, bias=False),
        "conv3": _conv_init(gen, cfg.c3, d4, 1, dtype, bias=False),
        "conv4": _conv_init(gen, cfg.c4, d4, 1, dtype, bias=False),
        "score_head": {
            "0": _conv_init(gen, cfg.dim, 8, 1, dtype, bias=False),
            "2": _conv_init(gen, 8, 4, 3, dtype, bias=False),
            "4": _conv_init(gen, 4, 4, 3, dtype, bias=False),
            "6": _conv_init(gen, 4, 1, 3, dtype, bias=False)},
        "desc_head": {
            "offset_conv1": _conv_init(gen, cfg.dim, 2 * cfg.n_pos,
                                       cfg.kernel_size, dtype),
            "offset_conv2": _conv_init(gen, 2 * cfg.n_pos, 2 * cfg.n_pos, 1,
                                       dtype),
            "sf_conv": _conv_init(gen, cfg.dim, cfg.dim, 1, dtype,
                                  bias=False),
            "convM": _conv_init(gen, cfg.dim * cfg.n_pos, cfg.dim, 1, dtype,
                                bias=False)},
    }


# ---------------------------------------------------------------- pieces


def _conv(p, x):
    return P.conv(p, x, padding=p["w"].shape[0] // 2)


def _bn(p, x, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return (x - p["mean"]) * inv + p["bias"]


def _avg_pool(x, k):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    zero_pad: bool = True) -> torch.Tensor:
    """x [B, H, W, C]; ys, xs [B, ...] pixel coordinates -> [B, ..., C].
    A corner outside the map reads 0 (``deform_conv2d``'s and
    ``grid_sample``'s zeros) unless ``zero_pad`` is False (clamped)."""
    b, hh, ww, c = x.shape
    flat = x.reshape(b, hh * ww, c)
    shape = ys.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]

    def g(yi, xi):
        yc = yi.clamp(0, hh - 1).nan_to_num(0.0).long()
        xc = xi.clamp(0, ww - 1).nan_to_num(0.0).long()
        idx = (yc * ww + xc).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(*shape, c)
        if zero_pad:
            valid = (yi >= 0) & (yi <= hh - 1) & (xi >= 0) & (xi <= ww - 1)
            v = torch.where(valid[..., None], v, torch.zeros_like(v))
        return v

    return ((1 - wy) * ((1 - wx) * g(y0, x0) + wx * g(y0, x0 + 1))
            + wy * ((1 - wx) * g(y0 + 1, x0) + wx * g(y0 + 1, x0 + 1)))


def deform_conv(p, x: torch.Tensor) -> torch.Tensor:
    """3x3 deformable conv, stride 1, no bias: the offset conv, offsets
    clamped to +-max(H, W)/4, channel pairs [dy_k, dx_k] with k = ky*3 +
    kx, each tap sampled bilinearly (zeros outside), then the product with
    the regular 3x3 kernel."""
    b, hh, ww, cin = x.shape
    off = _conv(p["offset"], x)                       # [B, H, W, 18]
    mo = max(hh, ww) / 4.0
    off = off.clamp(-mo, mo).reshape(b, hh, ww, 9, 2)
    dev = x.device
    yy, xx = torch.meshgrid(torch.arange(hh, dtype=x.dtype, device=dev),
                            torch.arange(ww, dtype=x.dtype, device=dev),
                            indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(-1, 2, dtype=x.dtype, device=dev),
                            torch.arange(-1, 2, dtype=x.dtype, device=dev),
                            indexing="ij")
    pos_y = yy[None, :, :, None] + ky.reshape(-1) + off[..., 0]
    pos_x = xx[None, :, :, None] + kx.reshape(-1) + off[..., 1]
    sampled = bilinear_gather(x, pos_y, pos_x)       # [B, H, W, 9, Cin]
    wk = p["w"].reshape(9, cin, -1)                  # HWIO, ky-major
    return torch.einsum("bhwkc,kco->bhwo", sampled, wk)


def _conv_or_dcn(p, x):
    return deform_conv(p, x) if "offset" in p else _conv(p, x)


def _convblock(p, x):
    x = F.selu(_bn(p["bn1"], _conv_or_dcn(p["conv1"], x)))
    return F.selu(_bn(p["bn2"], _conv_or_dcn(p["conv2"], x)))


def _resblock(p, x):
    h = F.selu(_bn(p["bn1"], _conv_or_dcn(p["conv1"], x)))
    h = _bn(p["bn2"], _conv_or_dcn(p["conv2"], h))
    return F.selu(h + _conv(p["downsample"], x))


def upsample_ac(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsampling of [B, H, W, C] with align_corners=True, the
    source index i (n_in - 1) / (n_out - 1) in fp32 as JAX computes it."""
    b, hh, ww, c = x.shape

    def axis_idx(n_in, n_out):
        if n_in == 1:
            return torch.zeros((n_out,), dtype=x.dtype, device=x.device)
        return (torch.arange(n_out, dtype=x.dtype, device=x.device)
                * (n_in - 1) / (n_out - 1))

    def interp(arr, idx, axis):
        i0 = torch.floor(idx).long()
        i1 = torch.clamp(i0 + 1, max=arr.shape[axis] - 1)
        w1 = idx - i0.to(x.dtype)
        a0 = torch.index_select(arr, axis, i0)
        a1 = torch.index_select(arr, axis, i1)
        shape = [1] * arr.ndim
        shape[axis] = -1
        w1 = w1.reshape(shape)
        return a0 * (1 - w1) + a1 * w1

    x = interp(x, axis_idx(hh, hh * factor), 1)
    return interp(x, axis_idx(ww, ww * factor), 2)


def _l2(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


# ---------------------------------------------------------------- forward


def aliked_dense(params, cfg: ALIKEDConfig, image: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image [B, H, W, 3] in [0, 1], H and W multiples of 32 ->
    (L2-normalised features [B, H, W, dim], scores [B, H, W])."""
    x1 = _convblock(params["block1"], image.float())     # 1,  c1
    x2 = _resblock(params["block2"], _avg_pool(x1, 2))   # /2, c2
    x3 = _resblock(params["block3"], _avg_pool(x2, 4))   # /8, c3
    x4 = _resblock(params["block4"], _avg_pool(x3, 4))   # /32, c4
    x1 = F.selu(_conv(params["conv1"], x1))
    x2 = F.selu(_conv(params["conv2"], x2))
    x3 = F.selu(_conv(params["conv3"], x3))
    x4 = F.selu(_conv(params["conv4"], x4))
    cat = torch.cat([x1, upsample_ac(x2, 2), upsample_ac(x3, 8),
                     upsample_ac(x4, 32)], dim=-1)
    sh = params["score_head"]
    s = F.selu(_conv(sh["0"], cat))
    s = F.selu(_conv(sh["2"], s))
    s = F.selu(_conv(sh["4"], s))
    score = torch.sigmoid(_conv(sh["6"], s))[..., 0]
    return _l2(cat), score


def dkd_detect(score_map: torch.Tensor, cfg: ALIKEDConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores [B, H, W] -> keypoints [B, K, 2] (x, y; padding (-1, -1)) and
    their scores [B, K] (padding -1): NMS, the border and the threshold
    (an image with no peak above it falls back to its own mean score), the
    top K, and a 5x5 soft-argmax refinement."""
    b, hh, ww = score_map.shape
    r = cfg.nms_radius
    dev = score_map.device
    nms = simple_nms(score_map, r)
    border = torch.zeros((hh, ww), dtype=torch.bool, device=dev)
    border[r:hh - r, r:ww - r] = True
    nms = torch.where(border[None], nms, torch.zeros_like(nms))
    has_peak = (nms > cfg.detection_threshold).reshape(b, -1).any(dim=-1)
    th = torch.where(has_peak.reshape(b, 1, 1),
                     torch.full((b, 1, 1), cfg.detection_threshold,
                                dtype=score_map.dtype, device=dev),
                     score_map.reshape(b, -1).mean(dim=-1).reshape(b, 1, 1))
    masked = torch.where(nms > th, nms, torch.full_like(nms, -1.0))
    scores, idx = top_k(masked.reshape(b, -1),
                        min(cfg.max_num_keypoints, hh * ww))
    valid = scores > 0
    iy = torch.div(idx, ww, rounding_mode="floor")
    ix = idx % ww

    # the soft-argmax over the raw scores (selected peaks lie >= r from the
    # border, so the patch stays inside)
    rng = torch.arange(-r, r + 1, device=dev)
    dy, dx = torch.meshgrid(rng, rng, indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    py = (iy[..., None] + dy).clamp(0, hh - 1)
    px = (ix[..., None] + dx).clamp(0, ww - 1)
    patch = torch.gather(score_map.reshape(b, -1), 1,
                         (py * ww + px).reshape(b, -1)).reshape(py.shape)
    e = torch.exp((patch - patch.amax(dim=-1, keepdim=True)) / 0.1)
    denom = e.sum(dim=-1)
    ky = iy.float() + (e * dy).sum(-1) / denom
    kx = ix.float() + (e * dx).sum(-1) / denom
    kscore = bilinear_gather(score_map[..., None], ky, kx,
                             zero_pad=False)[..., 0]
    kpts = torch.where(valid[..., None], torch.stack([kx, ky], dim=-1),
                       torch.full((b, idx.shape[1], 2), -1.0, device=dev))
    return kpts, torch.where(valid, kscore, torch.full_like(kscore, -1.0))


def sddh_describe(params, cfg: ALIKEDConfig, feat: torch.Tensor,
                  kpts: torch.Tensor) -> torch.Tensor:
    """The sparse deformable descriptor head: feat [B, H, W, dim],
    keypoints [B, K, 2] (x, y) -> descriptors [B, K, dim]."""
    p = params["desc_head"]
    b, hh, ww, c = feat.shape
    kk = cfg.kernel_size
    r = kk // 2
    mo = max(hh, ww) / 4.0
    dev = feat.device
    rng = torch.arange(-r, r + 1, device=dev)
    dy, dx = torch.meshgrid(rng, rng, indexing="ij")
    ix = kpts[..., 0].long().clamp(0, ww - 1)        # truncation, as astype
    iy = kpts[..., 1].long().clamp(0, hh - 1)
    py = (iy[..., None] + dy.reshape(-1)).clamp(0, hh - 1)   # [B, K, k*k]
    px = (ix[..., None] + dx.reshape(-1)).clamp(0, ww - 1)
    idx = (py * ww + px).reshape(b, -1, 1).expand(-1, -1, c)
    patch = torch.gather(feat.reshape(b, hh * ww, c), 1, idx)
    patch = patch.reshape(b, -1, kk, kk, c)
    off = torch.einsum("bnkld,kldo->bno", patch, p["offset_conv1"]["w"]) \
        + p["offset_conv1"]["b"]
    off = F.selu(off)
    off = off @ p["offset_conv2"]["w"][0, 0] + p["offset_conv2"]["b"]
    off = off.clamp(-mo, mo).reshape(b, -1, cfg.n_pos, 2)    # (dx, dy)
    pos_x = kpts[..., 0:1] + off[..., 0]
    pos_y = kpts[..., 1:2] + off[..., 1]
    samp = bilinear_gather(feat, pos_y, pos_x)               # [B, K, M, C]
    samp = F.selu(samp @ p["sf_conv"]["w"][0, 0])
    desc = samp.reshape(b, samp.shape[1], -1) @ p["convM"]["w"][0, 0]
    return _l2(desc)


def aliked_forward(params, cfg: ALIKEDConfig, image: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """image [B, H, W, 3] in [0, 1], H and W multiples of 32 -> keypoints
    [B, K, 2] (x, y; padding (-1, -1)), scores [B, K], descriptors [B, K,
    dim] (padding rows 0)."""
    feat, score = aliked_dense(params, cfg, image)
    kpts, kscores = dkd_detect(score, cfg)
    desc = sddh_describe(params, cfg, feat, kpts)
    desc = torch.where((kscores > 0)[..., None], desc, torch.zeros_like(desc))
    return {"keypoints": kpts, "scores": kscores, "descriptors": desc}


def pad_to_multiple(image: np.ndarray, div: int = 32) -> np.ndarray:
    """Replicate-pad H and W (bottom / right) of [H, W, C] to multiples of
    ``div``; the caller drops keypoints that land in the margin."""
    hh, ww = image.shape[:2]
    ph = (-hh) % div
    pw = (-ww) % div
    if ph == 0 and pw == 0:
        return image
    return np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
