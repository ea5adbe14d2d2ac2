"""Streaming Wan-VAE encode / decode with carried causal-conv caches.

Counterpart of ``worldforge_tpu/models/wan/vae_stream.py``. The encoder
takes [1, 4, 4, ...] input frames per chunk and the decoder ``chunk`` latent
frames per chunk; each causal conv keeps the last 2 frames of its padded
input as a cache for the next chunk (zero caches are the reference's front
zero padding and 'Rep' sentinel). The result equals the single pass of
``vae.py``, which holds full-length activations: at the LongCat refine shape
(61 frames at 704 x 1280) the encoder's first conv output alone is 21 GB in
fp32, while a chunk here is at most 6 frames. The JAX ``lax.scan`` over
chunks is a Python loop.

Every 3x3x3 conv of a cell goes through ``vae._causal_conv3d`` with
``front_pad=0`` (the cache is the causal padding), so it launches kernel 4
(``ops/conv3d``) on the card exactly where the single pass does; the
mid-block attention launches kernel 1.

A cache kept from a slice is copied (``_keep``) so that it does not hold
the whole padded input of its chunk alive. The H-strip tiling of the
spatial convs (``spatial_chunks`` > 1), a capacity knob for a 16 GB chip,
is a later slice of the port and raises.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig, _attn_block,
                                                 _causal_conv3d, _conv2d,
                                                 _latent_stats, _rms_norm_c)

CACHE_T = 2
SPATIAL_CHUNKS_NOT_PORTED = (
    "the streaming VAE's H-strip tiling (spatial_chunks > 1) is a later "
    "slice of the port; spatial_chunks=1 streams whole frames")


def _check_spatial(spatial_chunks: int) -> None:
    if spatial_chunks != 1:
        raise NotImplementedError(SPATIAL_CHUNKS_NOT_PORTED)


def _keep(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` frames as a cache of their own: a copy, since the
    slice of a contiguous batch-1 tensor is itself contiguous and would keep
    the whole input alive."""
    return x[:, -n:].clone()


# ---------------------------------------------------------------- cells
#
# Every temporal-causal op is a cell: (params, x, cache) -> (y, new_cache).


def _cconv_cell(p, x, cache):
    """Causal conv3d k=(3,kh,kw) over [cache(2) || x]; the new cache is the
    last 2 frames of that padded input."""
    xin = torch.cat([cache, x], dim=1)
    return _causal_conv3d(p, xin, front_pad=0), _keep(xin, CACHE_T)


def _conv1_cell(p, x, cache):
    """1x1x1 causal conv: temporally pointwise, no cache needed."""
    return _causal_conv3d(p, x, front_pad=0), cache


def _res_cell(p, x, caches):
    c1, c2 = caches
    h = _rms_norm_c(p["norm1"], x)
    h, c1 = _cconv_cell(p["conv1"], F.silu(h), c1)
    h = _rms_norm_c(p["norm2"], h)
    h, c2 = _cconv_cell(p["conv2"], F.silu(h), c2)
    s = _conv1_cell(p["shortcut"], x, None)[0] if "shortcut" in p else x
    return h + s, (c1, c2)


def _down_cell(p, x, cache, temporal, is_first):
    """Encoder resample: spatial stride 2 per frame, then, when temporal and
    not the first chunk, the time conv over [cache(1) || x] with stride 2.
    First chunk: identity in time, cache = its last frame."""
    b, t, h, w, c = x.shape
    flat = F.pad(x.reshape(b * t, h, w, c), (0, 0, 0, 1, 0, 1))
    y = _conv2d(p["conv"], flat, stride=2)
    y = y.reshape(b, t, y.shape[1], y.shape[2], c)
    if not temporal:
        return y, cache
    if is_first:
        return y, _keep(y, 1)
    xin = torch.cat([cache, y], dim=1)
    z = _causal_conv3d(p["time_conv"], xin, stride_t=2, front_pad=0)
    return z, _keep(y, 1)


def _up_cell(p, x, cache, temporal, is_first):
    """Decoder resample: when temporal and not the first latent frame, the
    time conv over [cache(2) || x] -> 2C channels -> 2 frames; the first
    frame passes through (the zero cache is the 'Rep' zero padding). Then
    nearest 2x in space and a 3x3 conv C -> C/2."""
    b, t, h, w, c = x.shape
    if temporal and not is_first:
        xin = torch.cat([cache, x], dim=1)
        z = _causal_conv3d(p["time_conv"], xin, front_pad=0)  # [B,t,..,2C]
        a, bb = torch.chunk(z, 2, dim=-1)
        x2 = torch.stack([a, bb], dim=2).reshape(b, 2 * t, h, w, c)
        new_cache = _keep(xin, CACHE_T)
    else:
        x2 = x
        new_cache = torch.zeros_like(cache) if temporal else cache
    t2 = x2.shape[1]
    flat = x2.reshape(b * t2, h, w, c).permute(0, 3, 1, 2)
    up = F.interpolate(flat, scale_factor=2, mode="nearest").permute(
        0, 2, 3, 1)
    y = _conv2d(p["conv"], up, padding=1)
    return y.reshape(b, t2, 2 * h, 2 * w, y.shape[-1]), new_cache


# ---------------------------------------------------------------- caches


def _zeros_cache(b, h, w, c, n=CACHE_T, dtype=torch.float32, device=None):
    return torch.zeros((b, n, h, w, c), dtype=dtype, device=device)


def init_encoder_caches(params, cfg: WanVAEConfig, b, h, w,
                        dtype=torch.float32, device=None) -> Dict:
    z = lambda hh, ww, c, n=CACHE_T: _zeros_cache(b, hh, ww, c, n, dtype,
                                                  device)
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    caches = {"conv_in": z(h, w, 3)}
    ch, cw = h, w
    stages = []
    for i, st in enumerate(params["stages"]):
        cout = dims[i + 1]
        blocks = []
        c = dims[i]
        for _ in st["blocks"]:
            # conv1 caches the block input (c channels), conv2 the
            # intermediate (cout)
            blocks.append((z(ch, cw, c), z(ch, cw, cout)))
            c = cout
        sd = {"blocks": blocks}
        if "down" in st:
            ch, cw = (ch + 1) // 2, (cw + 1) // 2
            sd["down"] = z(ch, cw, cout, 1)
        stages.append(sd)
    cm = dims[-1]
    caches["stages"] = stages
    caches["mid"] = {"res1": (z(ch, cw, cm), z(ch, cw, cm)),
                     "res2": (z(ch, cw, cm), z(ch, cw, cm))}
    caches["conv_out"] = z(ch, cw, cm)
    return caches


def init_decoder_caches(params, cfg: WanVAEConfig, b, h, w,
                        dtype=torch.float32, device=None) -> Dict:
    """h, w: latent spatial size."""
    z = lambda hh, ww, c: _zeros_cache(b, hh, ww, c, CACHE_T, dtype, device)
    dec_dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(
        reversed(cfg.dim_mult))]
    caches = {"conv_in": z(h, w, cfg.z_dim)}
    cm = dec_dims[0]
    caches["mid"] = {"res1": (z(h, w, cm), z(h, w, cm)),
                     "res2": (z(h, w, cm), z(h, w, cm))}
    ch, cw = h, w
    stages = []
    for i, st in enumerate(params["stages"]):
        cout = dec_dims[i + 1]
        c = dec_dims[i] // 2 if i in (1, 2, 3) else dec_dims[i]
        blocks = []
        for _ in st["blocks"]:
            blocks.append((z(ch, cw, c), z(ch, cw, cout)))
            c = cout
        sd = {"blocks": blocks}
        if "up" in st:
            sd["up"] = z(ch, cw, cout)
            ch, cw = ch * 2, cw * 2
        stages.append(sd)
    caches["stages"] = stages
    caches["conv_out"] = z(ch, cw, dec_dims[-1])
    return caches


# ---------------------------------------------------------------- passes


def _encoder_chunk(params, cfg: WanVAEConfig, x, caches, is_first: bool):
    c = dict(caches)
    h, c["conv_in"] = _cconv_cell(params["conv_in"], x, caches["conv_in"])
    stages = []
    for i, st in enumerate(params["stages"]):
        sc = dict(caches["stages"][i])
        blocks = []
        for j, blk in enumerate(st["blocks"]):
            h, bc = _res_cell(blk, h, caches["stages"][i]["blocks"][j])
            blocks.append(bc)
        sc["blocks"] = blocks
        if "down" in st:
            h, sc["down"] = _down_cell(st["down"], h,
                                       caches["stages"][i]["down"],
                                       cfg.temporal_downsample[i], is_first)
        stages.append(sc)
    c["stages"] = stages
    mid = {}
    h, mid["res1"] = _res_cell(params["mid"]["res1"], h,
                               caches["mid"]["res1"])
    h = _attn_block(params["mid"]["attn"], h)
    h, mid["res2"] = _res_cell(params["mid"]["res2"], h,
                               caches["mid"]["res2"])
    c["mid"] = mid
    h = F.silu(_rms_norm_c(params["norm_out"], h))
    h, c["conv_out"] = _cconv_cell(params["conv_out"], h, caches["conv_out"])
    return h, c


def _decoder_chunk(params, cfg: WanVAEConfig, z, caches, is_first: bool):
    c = dict(caches)
    h, c["conv_in"] = _cconv_cell(params["conv_in"], z, caches["conv_in"])
    mid = {}
    h, mid["res1"] = _res_cell(params["mid"]["res1"], h,
                               caches["mid"]["res1"])
    h = _attn_block(params["mid"]["attn"], h)
    h, mid["res2"] = _res_cell(params["mid"]["res2"], h,
                               caches["mid"]["res2"])
    c["mid"] = mid
    stages = []
    for i, st in enumerate(params["stages"]):
        sc = dict(caches["stages"][i])
        blocks = []
        for j, blk in enumerate(st["blocks"]):
            h, bc = _res_cell(blk, h, caches["stages"][i]["blocks"][j])
            blocks.append(bc)
        sc["blocks"] = blocks
        if "up" in st:
            h, sc["up"] = _up_cell(st["up"], h, caches["stages"][i]["up"],
                                   cfg.temporal_upsample[i], is_first)
        stages.append(sc)
    c["stages"] = stages
    h = F.silu(_rms_norm_c(params["norm_out"], h))
    h, c["conv_out"] = _cconv_cell(params["conv_out"], h, caches["conv_out"])
    return h, c


# ---------------------------------------------------------------- API


@torch.inference_mode()
def vae_encode_streaming(params, cfg: WanVAEConfig, video, mean=None,
                         std=None, spatial_chunks: int = 1) -> torch.Tensor:
    """Streaming equivalent of ``vae_encode``: video [B,3,T,H,W] (T = 1+4k)
    in [-1, 1] -> normalized latents [B, z, 1+k, H/8, W/8]. Chunks of
    [1, 4, 4, ...] input frames. Compute dtype follows the param dtype."""
    _check_spatial(spatial_chunks)
    b, _, t, h, w = video.shape
    x = video.permute(0, 2, 3, 4, 1).to(params["conv1"]["w"].dtype)
    caches = init_encoder_caches(params["encoder"], cfg, b, h, w, x.dtype,
                                 x.device)
    outs = []
    for i in range(1 + (t - 1) // 4):
        chunk = x[:, :1] if i == 0 else x[:, 1 + 4 * (i - 1):1 + 4 * i]
        y, caches = _encoder_chunk(params["encoder"], cfg, chunk, caches,
                                   is_first=i == 0)
        outs.append(y)
    enc = torch.cat(outs, dim=1)
    mu = _causal_conv3d(params["conv1"], enc)[..., :cfg.z_dim]
    mean, std = _latent_stats(cfg, mean, std, mu)
    if mean is not None:
        mu = (mu - mean) / std
    return mu.permute(0, 4, 1, 2, 3)


@torch.inference_mode()
def vae_decode_streaming(params, cfg: WanVAEConfig, latents, mean=None,
                         std=None, chunk: int = 1,
                         spatial_chunks: int = 1) -> torch.Tensor:
    """Streaming equivalent of ``vae_decode``: ``chunk`` latent frames per
    step after the first (any chunk gives the same result: the caches carry
    the same state); ``chunk`` must divide T' - 1, else 1 is used.
    Returns video [B, 3, T, H, W] in [-1, 1]."""
    _check_spatial(spatial_chunks)
    b, _, t, h, w = latents.shape
    if chunk < 1 or (t - 1) % chunk:
        chunk = 1
    z = latents.permute(0, 2, 3, 4, 1)
    mean, std = _latent_stats(cfg, mean, std, z)
    if mean is not None:
        z = z * std + mean
    z = _causal_conv3d(params["conv2"], z.to(params["conv2"]["w"].dtype))
    caches = init_decoder_caches(params["decoder"], cfg, b, h, w, z.dtype,
                                 z.device)
    outs = []
    for i, s0 in enumerate([0] + list(range(1, t, chunk))):
        zf = z[:, :1] if i == 0 else z[:, s0:s0 + chunk]
        y, caches = _decoder_chunk(params["decoder"], cfg, zf, caches,
                                   is_first=i == 0)
        outs.append(y)
    dec = torch.cat(outs, dim=1)
    return torch.clamp(dec.permute(0, 4, 1, 2, 3), -1.0, 1.0)
