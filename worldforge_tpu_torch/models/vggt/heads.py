"""VGGT heads: the iterative camera head and the DPT depth head.

Counterpart of ``worldforge_tpu/models/vggt/heads.py``
(``camera_head_forward`` :56-86: 4 refinements through a 4-block trunk;
``dpt_head_forward`` :211 with ``_conv2d`` :110, ``_deconv2d`` :121,
``_fusion`` :180 and ``_uv_pos_embed`` :190), fp32, the same param tree;
the DPT head with every option of JAX's: the depth head (``exp`` /
``expp1``), the world-point head (``inv_log``) and the track head's
feature extractor (``feature_only``, ``down_ratio`` 2, no position
embedding).

Two layouts differ from PyTorch's habits and are handled here:
  - ``_deconv2d`` is ``jax.lax.conv_transpose`` with kernel = stride, VALID
    and an HWIO kernel that is not flipped: output pixel (i s + r) takes
    ``w[s-1-r]``, so it is computed as one matmul onto the flipped kernel
    (``F.conv_transpose2d`` would need it flipped and IOHW);
  - the ``SAME`` 3x3 and 1x1 convs are symmetric, and ``resize3`` pads
    (1, 1) explicitly, as JAX does.
The trunk's attention (over the S frames, 1 for a single image) goes
through kernel 1 (fp32, head dim 128) on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.models.vggt.vit import (_vit_block_init,
                                                  vit_block_forward)
from worldforge_tpu_torch.ops.sampling import resize_align_corners


# ---------------------------------------------------------------- camera


@dataclasses.dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 0.01
    target_dim: int = 9  # absT(3) + quatR(4) + FoV(2)

    @classmethod
    def tiny(cls, dim_in=64) -> "CameraHeadConfig":
        return cls(dim_in=dim_in, trunk_depth=2, num_heads=2)


def init_camera_head(gen: torch.Generator, cfg: CameraHeadConfig,
                     dtype=torch.float32) -> dict:
    dev = gen.device
    d = cfg.dim_in
    return {
        "trunk": [_vit_block_init(gen, d, cfg.num_heads, cfg.mlp_ratio,
                                  cfg.layerscale_init, dtype)
                  for _ in range(cfg.trunk_depth)],
        "token_norm": P.layer_norm_init(d, dtype=dtype, device=dev),
        "trunk_norm": P.layer_norm_init(d, dtype=dtype, device=dev),
        "empty_pose": torch.zeros((1, 1, cfg.target_dim), dtype=dtype,
                                  device=dev),
        "embed_pose": P.dense_init(gen, cfg.target_dim, d, dtype=dtype),
        "mod": P.dense_init(gen, d, 3 * d, dtype=dtype),
        "branch_fc1": P.dense_init(gen, d, d // 2, dtype=dtype),
        "branch_fc2": P.dense_init(gen, d // 2, cfg.target_dim, dtype=dtype),
    }


def camera_head_forward(params, cfg: CameraHeadConfig,
                        camera_tokens: torch.Tensor,
                        num_iterations: int = 4) -> torch.Tensor:
    """camera_tokens [B, S, 2C] (token 0 of the last aggregator layer) ->
    the last iteration's pose encodings [B, S, 9]: translation and
    quaternion linear, field of view through a ReLU."""
    x = P.layer_norm(params["token_norm"], camera_tokens.float(), eps=1e-5)
    b, s, _ = x.shape
    pred = None
    for _ in range(num_iterations):
        inp = pred if pred is not None else params["empty_pose"].float(
        ).expand(b, s, cfg.target_dim)
        mod = P.dense(params["mod"], F.silu(P.dense(params["embed_pose"],
                                                    inp)))
        shift, scale, gate = mod.chunk(3, dim=-1)
        h = P.layer_norm({}, x, eps=1e-6)
        h = gate * (h * (1 + scale) + shift) + x
        for blk in params["trunk"]:
            h = vit_block_forward(blk, h, cfg.num_heads, eps=1e-5)
        delta = P.dense(params["branch_fc2"], F.gelu(P.dense(
            params["branch_fc1"],
            P.layer_norm(params["trunk_norm"], h, eps=1e-5))))
        pred = delta if pred is None else pred + delta
    return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], dim=-1)


# ---------------------------------------------------------------- DPT


@dataclasses.dataclass(frozen=True)
class DPTHeadConfig:
    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 2            # depth + conf
    activation: str = "exp"        # or "inv_log" (the world-point head)
    conf_activation: str = "expp1"  # or "expp0"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    pos_embed: bool = True
    feature_only: bool = False     # full-width features, no output head
    down_ratio: int = 1            # output at (H, W) / down_ratio

    @classmethod
    def tiny(cls, dim_in=64) -> "DPTHeadConfig":
        return cls(dim_in=dim_in, features=16, out_channels=(8, 16, 32, 32))


def _conv2d_init(gen, cin, cout, k, dtype, bias=True):
    return P.conv_init(gen, cin, cout, (k, k), bias=bias, dtype=dtype)


def _conv2d(p, x, stride=1, padding=None):
    """NHWC conv, HWIO kernel; SAME (symmetric for the odd kernels here)
    unless ``padding`` is given."""
    if padding is None:
        padding = p["w"].shape[0] // 2
    return P.conv(p, x, stride=stride, padding=padding)


def _deconv2d(p, x, stride):
    """``jax.lax.conv_transpose`` with kernel = stride, VALID, HWIO and no
    flip: out[i s + r, j s + q] = x[i, j] . w[s-1-r, s-1-q]."""
    n, h, w_, c = x.shape
    k = p["w"].float().flip(0, 1)                       # [s, s, C, O]
    o = k.shape[-1]
    y = x.float().reshape(-1, c) @ k.permute(2, 0, 1, 3).reshape(c, -1)
    y = y.reshape(n, h, w_, stride, stride, o).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, h * stride, w_ * stride, o)
    if "b" in p:
        y = y + p["b"].float()
    return y


def init_dpt_head(gen: torch.Generator, cfg: DPTHeadConfig,
                  dtype=torch.float32) -> dict:
    dev = gen.device
    f = cfg.features
    oc = cfg.out_channels
    p = {
        "norm": P.layer_norm_init(cfg.dim_in, dtype=dtype, device=dev),
        "projects": [_conv2d_init(gen, cfg.dim_in, o, 1, dtype) for o in oc],
        "resize0": P.conv_init(gen, oc[0], oc[0], (4, 4), dtype=dtype),
        "resize1": P.conv_init(gen, oc[1], oc[1], (2, 2), dtype=dtype),
        "resize3": _conv2d_init(gen, oc[3], oc[3], 3, dtype),
        "layer_rn": [_conv2d_init(gen, o, f, 3, dtype, bias=False)
                     for o in oc],
        "out_conv1": _conv2d_init(gen, f, f if cfg.feature_only else f // 2,
                                  3, dtype),
    }
    if not cfg.feature_only:
        p["out_conv2a"] = _conv2d_init(gen, f // 2, 32, 3, dtype)
        p["out_conv2b"] = _conv2d_init(gen, 32, cfg.output_dim, 1, dtype)
    for i in range(1, 5):
        rcu = {}
        for j in (1, 2):
            rcu[f"rcu{j}_conv1"] = _conv2d_init(gen, f, f, 3, dtype)
            rcu[f"rcu{j}_conv2"] = _conv2d_init(gen, f, f, 3, dtype)
        rcu["out"] = _conv2d_init(gen, f, f, 1, dtype)
        p[f"refine{i}"] = rcu
    return p


def _rcu(p, prefix, x):
    """ResidualConvUnit; the reference's ReLU is in place, so the skip adds
    relu(x), not x."""
    xr = F.relu(x)
    h = _conv2d(p[f"{prefix}_conv1"], xr)
    h = _conv2d(p[f"{prefix}_conv2"], F.relu(h))
    return xr + h


def _fusion(p, x, residual, size_hw):
    """FeatureFusionBlock with align_corners=True resizes."""
    out = x
    if residual is not None:
        out = out + _rcu(p, "rcu1", residual)
    out = _rcu(p, "rcu2", out)
    out = resize_align_corners(out, *size_hw)
    return _conv2d(p["out"], out)


def _uv_pos_embed(gh, gw, aspect, channels, device, ratio=0.1):
    """sincos embedding of a normalised uv grid, built in float64 on the
    host and cast to fp32."""
    diag = math.sqrt(aspect ** 2 + 1.0)
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (gw - 1) / gw, span_x * (gw - 1) / gw, gw)
    ys = np.linspace(-span_y * (gh - 1) / gh, span_y * (gh - 1) / gh, gh)
    uu, vv = np.meshgrid(xs, ys, indexing="xy")

    def sincos(posv, dim):
        omega = 1.0 / (100.0 ** (np.arange(dim // 2, dtype=np.float64)
                                 / (dim / 2.0)))
        out = np.einsum("m,d->md", posv.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    half = channels // 2
    emb = np.concatenate([sincos(uu, half), sincos(vv, half)], axis=-1)
    return torch.as_tensor(emb.reshape(gh, gw, channels) * ratio,
                           dtype=torch.float32, device=device)


def dpt_head_forward(params, cfg: DPTHeadConfig,
                     tapped_tokens: List[torch.Tensor],
                     img_hw: Tuple[int, int], patch_start_idx: int
                     ):
    """tapped_tokens: 4 tensors [B, S, P, 2C] (taps in order). Returns
    (pred [B, S, h, w, out-1], conf [B, S, h, w]) at (h, w) = image size /
    ``down_ratio``, or with ``feature_only`` the features [B, S, h, w,
    features]."""
    hh, ww = img_hw
    ps = cfg.patch_size
    gh, gw = hh // ps, ww // ps
    b, s = tapped_tokens[0].shape[:2]
    dev = tapped_tokens[0].device
    feats = []
    for i, tok in enumerate(tapped_tokens):
        x = tok[:, :, patch_start_idx:].reshape(b * s, gh * gw, cfg.dim_in)
        x = P.layer_norm(params["norm"], x.float(), eps=1e-5)
        x = _conv2d(params["projects"][i], x.reshape(b * s, gh, gw, -1))
        if cfg.pos_embed:
            x = x + _uv_pos_embed(gh, gw, ww / hh, x.shape[3], dev)
        if i == 0:
            x = _deconv2d(params["resize0"], x, 4)
        elif i == 1:
            x = _deconv2d(params["resize1"], x, 2)
        elif i == 3:
            x = _conv2d(params["resize3"], x, stride=2, padding=1)
        feats.append(x)

    rn = [_conv2d(params["layer_rn"][i], feats[i]) for i in range(4)]
    out = _fusion(params["refine4"], rn[3], None, rn[2].shape[1:3])
    out = _fusion(params["refine3"], out, rn[2], rn[1].shape[1:3])
    out = _fusion(params["refine2"], out, rn[1], rn[0].shape[1:3])
    out = _fusion(params["refine1"], out, rn[0],
                  (rn[0].shape[1] * 2, rn[0].shape[2] * 2))
    out = _conv2d(params["out_conv1"], out)
    oh, ow = gh * ps // cfg.down_ratio, gw * ps // cfg.down_ratio
    out = resize_align_corners(out, oh, ow)
    if cfg.pos_embed:
        out = out + _uv_pos_embed(oh, ow, ww / hh, out.shape[3], dev)
    if cfg.feature_only:
        return out.reshape(b, s, oh, ow, -1)
    out = _conv2d(params["out_conv2b"],
                  F.relu(_conv2d(params["out_conv2a"], out)))
    vals, conf = out[..., :-1], out[..., -1]
    if cfg.activation == "exp":
        vals = torch.exp(vals)
    elif cfg.activation == "inv_log":
        vals = torch.sign(vals) * torch.expm1(vals.abs())
    if cfg.conf_activation == "expp1":
        conf = 1.0 + torch.exp(conf)
    elif cfg.conf_activation == "expp0":
        conf = torch.exp(conf)
    return vals.reshape(b, s, oh, ow, -1), conf.reshape(b, s, oh, ow)
