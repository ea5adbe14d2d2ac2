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
mid-block attention launches kernel 1; the 3x3 resample convs go through
``vae._conv2d`` (kernel 4's one-tap instantiation on the card) as in the
single pass.

A cache kept from a slice is copied (``_keep``) so that it does not hold
the whole padded input of its chunk alive.

``spatial_chunks`` > 1 tiles each stage's spatial convs over that many H
strips (see the section below); every strip's 3x3x3 conv still launches
kernel 4 and every upsample strip's 3x3 conv kernel 4's one-tap
instantiation.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig, _attn_block,
                                                 _causal_conv3d, _conv2d,
                                                 _latent_stats, _rms_norm_c)

CACHE_T = 2


def _keep(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` frames as a cache of their own: a copy, since the
    slice of a contiguous batch-1 tensor is itself contiguous and would keep
    the whole input alive."""
    return x[:, -n:].clone()


# ---------------------------------------------------------------- cells
#
# Every temporal-causal op is a cell: (params, x, cache) -> (y, new_cache).


def _cconv_cell(p, x, cache, spatial_chunks: int = 1):
    """Causal conv3d k=(3,kh,kw) over [cache(2) || x]; the new cache is the
    last 2 frames of that padded input."""
    xin = torch.cat([cache, x], dim=1)
    return _conv3d_strips(p, xin, spatial_chunks), _keep(xin, CACHE_T)


# ------------------------------------------------- H-strip spatial tiling
#
# Every op of a stage is spatially local (the RMS norm is per position, a
# conv reads kh//2 rows either side; the mid-block attention, the one
# global op, runs at latent size and is never tiled), so the spatial convs
# tile exactly over H strips. A strip is read with its halo rows and run
# through the same conv as the untiled path, SAME-padded; the rows its SAME
# padding touches are the halo's and are dropped, so the rows kept are the
# VALID-H conv of the strip, the untiled conv's rows exactly.
#
# Memory: no full-size temporary beyond the untiled path's. Each output is
# allocated once and every strip written into it in place; a strip is a
# slice of its input with zero rows only at the true borders (no padded
# copy of the whole array, no restacking).


def _gather_h(x, lo, size):
    """Rows [lo, lo + size) of axis 2 of x, zero outside [0, H): the strip
    with its halo, padded only where it crosses a true border."""
    a, b = max(lo, 0), min(lo + size, x.shape[2])
    strip = x[:, :, a:b]
    if a - lo or lo + size - b:
        strip = F.pad(strip, (0, 0, 0, 0, a - lo, lo + size - b))
    return strip


def _conv3d_strips(p, xin, n: int):
    """The causal conv of [B, T', H, W, C] (front padding already in xin)
    in n H-strips with halo kh//2, each through ``_causal_conv3d`` (kernel 4
    on the card). Untiled when n <= 1, H % n != 0 or the kernel is
    spatially pointwise."""
    kh = p["w"].shape[1]
    h = xin.shape[2]
    if n <= 1 or kh == 1 or h % n:
        return _causal_conv3d(p, xin, front_pad=0)
    hs, r = h // n, kh // 2
    out = None
    for i in range(n):
        lo = i * hs
        y = _causal_conv3d(p, _gather_h(xin, lo - r, hs + 2 * r),
                           front_pad=0)[:, :, r:r + hs]
        if out is None:
            out = y.new_empty((*y.shape[:2], h, *y.shape[3:]))
        out[:, :, lo:lo + hs] = y
    return out


def _down_spatial_strips(p, x, n: int):
    """The encoder's spatial downsample (zero pad right and bottom by 1,
    3x3 stride-2 VALID) in n H-strips. An output strip of hso rows reads
    input rows [2 lo, 2 lo + 2 hso + 1): no top halo (the stride-2 window
    of output row o starts at input row 2o); the bottom zero row comes from
    ``_gather_h`` at the last strip, the right one from a pad of the strip.
    """
    b, t, h, w, c = x.shape
    hso = (h // 2) // n
    out = None
    for i in range(n):
        lo = i * hso
        strip = _gather_h(x, 2 * lo, 2 * hso + 1)
        flat = F.pad(strip.reshape(b * t, 2 * hso + 1, w, c),
                     (0, 0, 0, 1))
        y = _conv2d(p["conv"], flat, stride=2)
        y = y.reshape(b, t, hso, y.shape[2], c)
        if out is None:
            out = y.new_empty((b, t, n * hso, y.shape[3], c))
        out[:, :, lo:lo + hso] = y
    return out


def _up_spatial_strips(p, x2, n: int):
    """Nearest 2x + 3x3 conv (C -> C/2) in n H-strips. Strip i reads x rows
    [i hs - 1, (i + 1) hs + 1) (halo 1, zero at the borders), upsamples
    them, keeps the up rows [1, 2 hs + 3) (the output rows' halo-1 window)
    and runs the untiled path's SAME conv (``_conv2d``: kernel 4's one-tap
    instantiation on the card) over them, keeping its rows [1, 2 hs + 1):
    output rows [2 i hs, 2 (i + 1) hs), the untiled conv's exactly."""
    b, t2, h, w, c = x2.shape
    hs = h // n
    out = None
    for i in range(n):
        lo = i * hs
        strip = _gather_h(x2, lo - 1, hs + 2).reshape(b * t2, hs + 2, w, c)
        up = F.interpolate(strip.permute(0, 3, 1, 2), scale_factor=2,
                           mode="nearest").permute(0, 2, 3, 1)
        y = _conv2d(p, up[:, 1:2 * hs + 3], padding=1)[:, 1:2 * hs + 1]
        y = y.reshape(b, t2, 2 * hs, 2 * w, y.shape[-1])
        if out is None:
            out = y.new_empty((b, t2, 2 * h, 2 * w, y.shape[-1]))
        out[:, :, 2 * lo:2 * lo + 2 * hs] = y
    return out


def _conv1_cell(p, x, cache):
    """1x1x1 causal conv: temporally pointwise, no cache needed."""
    return _causal_conv3d(p, x, front_pad=0), cache


def _res_cell(p, x, caches, spatial_chunks: int = 1):
    c1, c2 = caches
    h = _rms_norm_c(p["norm1"], x)
    h, c1 = _cconv_cell(p["conv1"], F.silu(h), c1, spatial_chunks)
    h = _rms_norm_c(p["norm2"], h)
    h, c2 = _cconv_cell(p["conv2"], F.silu(h), c2, spatial_chunks)
    s = _conv1_cell(p["shortcut"], x, None)[0] if "shortcut" in p else x
    return h + s, (c1, c2)


def _down_cell(p, x, cache, temporal, is_first, spatial_chunks: int = 1):
    """Encoder resample: spatial stride 2 per frame (in H-strips when h is
    even and its half divides by ``spatial_chunks``), then, when temporal
    and not the first chunk, the time conv over [cache(1) || x] with
    stride 2. First chunk: identity in time, cache = its last frame."""
    b, t, h, w, c = x.shape
    if (spatial_chunks > 1 and h % 2 == 0
            and (h // 2) % spatial_chunks == 0):
        y = _down_spatial_strips(p, x, spatial_chunks)
    else:
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


def _up_cell(p, x, cache, temporal, is_first, spatial_chunks: int = 1):
    """Decoder resample: when temporal and not the first latent frame, the
    time conv over [cache(2) || x] -> 2C channels -> 2 frames; the first
    frame passes through (the zero cache is the 'Rep' zero padding). Then
    nearest 2x in space and a 3x3 conv C -> C/2, in H-strips when h divides
    by ``spatial_chunks`` (the time conv is spatially pointwise and stays
    whole)."""
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
    if spatial_chunks > 1 and h % spatial_chunks == 0:
        return _up_spatial_strips(p["conv"], x2, spatial_chunks), new_cache
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


def _encoder_chunk(params, cfg: WanVAEConfig, x, caches, is_first: bool,
                   spatial_chunks: int = 1):
    c = dict(caches)
    h, c["conv_in"] = _cconv_cell(params["conv_in"], x, caches["conv_in"],
                                  spatial_chunks)
    stages = []
    for i, st in enumerate(params["stages"]):
        sc = dict(caches["stages"][i])
        blocks = []
        for j, blk in enumerate(st["blocks"]):
            h, bc = _res_cell(blk, h, caches["stages"][i]["blocks"][j],
                              spatial_chunks)
            blocks.append(bc)
        sc["blocks"] = blocks
        if "down" in st:
            h, sc["down"] = _down_cell(st["down"], h,
                                       caches["stages"][i]["down"],
                                       cfg.temporal_downsample[i], is_first,
                                       spatial_chunks)
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


def _decoder_chunk(params, cfg: WanVAEConfig, z, caches, is_first: bool,
                   spatial_chunks: int = 1):
    c = dict(caches)
    # conv_in and the mid block run at latent size, untiled (the mid
    # attention sees the whole frame)
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
            h, bc = _res_cell(blk, h, caches["stages"][i]["blocks"][j],
                              spatial_chunks)
            blocks.append(bc)
        sc["blocks"] = blocks
        if "up" in st:
            h, sc["up"] = _up_cell(st["up"], h, caches["stages"][i]["up"],
                                   cfg.temporal_upsample[i], is_first,
                                   spatial_chunks)
        stages.append(sc)
    c["stages"] = stages
    h = F.silu(_rms_norm_c(params["norm_out"], h))
    h, c["conv_out"] = _cconv_cell(params["conv_out"], h, caches["conv_out"],
                                   spatial_chunks)
    return h, c


# ---------------------------------------------------------------- API


@torch.inference_mode()
def vae_encode_streaming(params, cfg: WanVAEConfig, video, mean=None,
                         std=None, spatial_chunks: int = 1) -> torch.Tensor:
    """Streaming equivalent of ``vae_encode``: video [B,3,T,H,W] (T = 1+4k)
    in [-1, 1] -> normalized latents [B, z, 1+k, H/8, W/8]. Chunks of
    [1, 4, 4, ...] input frames. Compute dtype follows the param dtype.
    ``spatial_chunks``: the H-strips of each stage's spatial convs (the
    same result; see the decode)."""
    b, _, t, h, w = video.shape
    x = video.permute(0, 2, 3, 4, 1).to(params["conv1"]["w"].dtype)
    caches = init_encoder_caches(params["encoder"], cfg, b, h, w, x.dtype,
                                 x.device)
    outs = []
    for i in range(1 + (t - 1) // 4):
        chunk = x[:, :1] if i == 0 else x[:, 1 + 4 * (i - 1):1 + 4 * i]
        y, caches = _encoder_chunk(params["encoder"], cfg, chunk, caches,
                                   is_first=i == 0,
                                   spatial_chunks=spatial_chunks)
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
    Returns video [B, 3, T, H, W] in [-1, 1].

    ``spatial_chunks`` > 1 runs each stage's spatial convs over that many
    H strips, the same arithmetic row for row: a stage whose H it does not
    divide runs whole (pick a divisor of the latent height, as 2 or 4 at
    480p and 704p, so that every stage tiles)."""
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
                                   is_first=i == 0,
                                   spatial_chunks=spatial_chunks)
        outs.append(y)
    dec = torch.cat(outs, dim=1)
    return torch.clamp(dec.permute(0, 4, 1, 2, 3), -1.0, 1.0)
