"""SVD VAE (AutoencoderKLTemporalDecoder): 2-D encoder + temporal decoder.

Counterpart of ``worldforge_tpu/models/depthcrafter/vae.py``: the encoder
is the SD VAE encoder run on every frame; the decoder's resnets are
spatio-temporal (the UNet's SpatioTemporalResBlock, no timestep), followed
by a temporal conv over the frames (``time_conv_out``). Scaling factor
0.18215. The mid-block attention of both is one head of the full width
(512 at ``svd()``), which runs on kernel 1's fp32 d 512 instantiation on
the card. The convs take the UNet's routes (``unet._conv2d`` /
``unet._conv_t``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.models.depthcrafter.unet import (
    _attn, _attn_init, _conv, _conv2d, _conv_t, _res2d, _res2d_init,
    _st_res, _st_res_init, _upsample2, _xla_conv)

SVD_VAE_SCALING = 0.18215


@dataclasses.dataclass(frozen=True)
class SVDVAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    eps: float = 1e-6

    @classmethod
    def svd(cls) -> "SVDVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SVDVAEConfig":
        return cls(block_out_channels=(8, 8, 16, 16), layers_per_block=1)


def _res2d_no_t_init(gen, cin, cout, dtype):
    p = _res2d_init(gen, cin, cout, 1, dtype)
    p.pop("time_emb_proj")
    return p


def init_svd_vae(gen: torch.Generator, cfg: SVDVAEConfig,
                 dtype=torch.float32) -> dict:
    """Random parameters drawn from ``gen`` on its device (the tree of
    ``worldforge_tpu``'s ``init_svd_vae``)."""
    boc = cfg.block_out_channels
    dev = gen.device
    enc = {"conv_in": _conv(gen, cfg.in_channels, boc[0], 3, dtype),
           "down": []}
    for i, c in enumerate(boc):
        cin = boc[max(i - 1, 0)]
        blk = {"resnets": [
            _res2d_no_t_init(gen, cin if j == 0 else c, c, dtype)
            for j in range(cfg.layers_per_block)]}
        if i < len(boc) - 1:
            blk["down"] = _conv(gen, c, c, 3, dtype)
        enc["down"].append(blk)
    enc["mid"] = {
        "res1": _res2d_no_t_init(gen, boc[-1], boc[-1], dtype),
        "attn_norm": P.group_norm_init(boc[-1], dtype, dev),
        "attn": _attn_init(gen, boc[-1], boc[-1], dtype),
        "res2": _res2d_no_t_init(gen, boc[-1], boc[-1], dtype),
    }
    enc["norm_out"] = P.group_norm_init(boc[-1], dtype, dev)
    enc["conv_out"] = _conv(gen, boc[-1], 2 * cfg.latent_channels, 3, dtype)
    enc["quant_conv"] = _conv(gen, 2 * cfg.latent_channels,
                              2 * cfg.latent_channels, 1, dtype)

    rev = list(reversed(boc))
    dec = {"conv_in": _conv(gen, cfg.latent_channels, rev[0], 3, dtype),
           "up": []}
    dec["mid"] = {
        "res1": _st_res_init(gen, rev[0], rev[0], 0, dtype),
        "attn_norm": P.group_norm_init(rev[0], dtype, dev),
        "attn": _attn_init(gen, rev[0], rev[0], dtype),
        "res2": _st_res_init(gen, rev[0], rev[0], 0, dtype),
    }
    for i, c in enumerate(rev):
        cin = rev[max(i - 1, 0)]
        blk = {"resnets": [
            _st_res_init(gen, cin if j == 0 else c, c, 0, dtype)
            for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            blk["up"] = _conv(gen, c, c, 3, dtype)
        dec["up"].append(blk)
    dec["norm_out"] = P.group_norm_init(rev[-1], dtype, dev)
    dec["conv_out"] = _conv(gen, rev[-1], cfg.in_channels, 3, dtype)
    dec["time_conv_out"] = P.conv_init(gen, cfg.in_channels, cfg.in_channels,
                                       (3, 1, 1), dtype=dtype)
    return {"encoder": enc, "decoder": dec}


def _res2d_no_t(p, x, eps):
    return _res2d(p, x, None, eps)


def _vae_attn(pn, pa, x, eps):
    n, hh, ww, c = x.shape
    h = P.group_norm(pn, x, eps=eps).reshape(n, hh * ww, c)
    return x + _attn(pa, h, h, heads=1).reshape(n, hh, ww, c)


@torch.inference_mode()
def svd_vae_encode(params, cfg: SVDVAEConfig, frames: torch.Tensor,
                   scale: bool = True) -> torch.Tensor:
    """frames [T, 3, H, W] in [-1,1] -> latent means [T, 4, H/8, W/8],
    times 0.18215 with ``scale`` (DepthCrafter's conditioning takes them
    raw)."""
    e = params["encoder"]
    x = frames.permute(0, 2, 3, 1).contiguous()
    x = _conv2d(e["conv_in"], x)
    for blk in e["down"]:
        for r in blk["resnets"]:
            x = _res2d_no_t(r, x, cfg.eps)
        if "down" in blk:
            # pad one row and column at the end, then a VALID stride-2 conv
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = _xla_conv(blk["down"], x, stride=2)
    x = _res2d_no_t(e["mid"]["res1"], x, cfg.eps)
    x = _vae_attn(e["mid"]["attn_norm"], e["mid"]["attn"], x, cfg.eps)
    x = _res2d_no_t(e["mid"]["res2"], x, cfg.eps)
    x = F.silu(P.group_norm(e["norm_out"], x, eps=cfg.eps))
    x = _conv2d(e["conv_out"], x)
    x = _conv2d(e["quant_conv"], x)
    out = x[..., :cfg.latent_channels].permute(0, 3, 1, 2)
    return out * SVD_VAE_SCALING if scale else out


@torch.inference_mode()
def svd_vae_decode(params, cfg: SVDVAEConfig,
                   latents: torch.Tensor) -> torch.Tensor:
    """latents [T, 4, h, w] (scaled) -> frames [T, 3, H, W] in [-1,1].
    The whole chunk is one temporal group (num_frames = T)."""
    d = params["decoder"]
    t = latents.shape[0]
    x = (latents / SVD_VAE_SCALING).permute(0, 2, 3, 1).contiguous()
    x = _conv2d(d["conv_in"], x)
    x = _st_res(d["mid"]["res1"], x, None, t, cfg.eps)
    x = _vae_attn(d["mid"]["attn_norm"], d["mid"]["attn"], x, cfg.eps)
    x = _st_res(d["mid"]["res2"], x, None, t, cfg.eps)
    for blk in d["up"]:
        for r in blk["resnets"]:
            x = _st_res(r, x, None, t, cfg.eps)
        if "up" in blk:
            x = _conv2d(blk["up"], _upsample2(x))
    x = F.silu(P.group_norm(d["norm_out"], x, eps=cfg.eps))
    x = _conv2d(d["conv_out"], x)
    # final temporal conv over the frames (TemporalDecoder.time_conv_out)
    x = _conv_t(d["time_conv_out"], x[None])[0]
    return x.permute(0, 3, 1, 2)
