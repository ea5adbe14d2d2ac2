"""Wan causal 3D video VAE (z=16, stride t4 x s8) in PyTorch, single pass.

Counterpart of ``worldforge_tpu/models/wan/vae.py`` (same config, param
tree, layouts and the same single-pass math as the reference's streaming
encoder/decoder): channels-last ``[B, T, H, W, C]`` inside, the reference's
``[B, C, T, H, W]`` at ``vae_encode`` / ``vae_decode``.

Kernels on this path (CUDA tensors launch them; CPU tensors take each
kernel's plain version):
  - every 3x3x3 stride-1 causal conv -> ``ops/conv3d.conv3d_causal``
    (kernel 4), exactly where the JAX ``_causal_conv3d`` takes its
    ``"pallas"`` branch: inputs rounded to bf16, fp32 accumulation;
  - on the card, the decoder's stride-1 3x3 resample convs (after the
    nearest x2) -> ``ops/conv3d.conv2d_3x3``, kernel 4 with one temporal
    tap;
  - the mid-block single-head attention -> flash attention (kernel 1), fp32.
The other convs (the 3x1x1 time convs, 1x1x1 shortcuts and projections, the
encoder's stride-2 convs) stay XLA convs in JAX, which passes them no
precision: on its chip they run bf16 operands with fp32 sums. On the card
they run so here too (``_xla_conv``: cuDNN's TF32 algorithms on operands
rounded to bf16, exact products, fp32 sums and result), which also keeps
cuDNN off the fp32 algorithm that took a 36.77 GB workspace and 280-358
ms a call for one 480p resample conv (``chip_smoke.py``'s
vae_conv2d_workspace line, NVIDIA H100 80GB HBM3 at 700 W). On the CPU they, and the
resample convs, stay full fp32 (TF32 off), as the JAX package's CPU tests
run them.

The streaming encoder and decoder are in ``vae_stream.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.conv3d import conv2d_3x3, conv3d_causal

# Per-channel latent statistics (model metadata).
WAN_LATENTS_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], dtype=np.float32)
WAN_LATENTS_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temporal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temporal_downsample))

    @classmethod
    def wan_2_1(cls) -> "WanVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "WanVAEConfig":
        return cls(dim=8, z_dim=4, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


# --------------------------------------------------------------- primitives


def _causal_conv3d(p, x, *, stride_t: int = 1, spatial_same: bool = True,
                   front_pad: Optional[int] = None):
    """x: [B,T,H,W,C]; kernel p['w']: [kt,kh,kw,in,out]. Temporal padding is
    causal: (kt-1) zeros in front by default."""
    if front_pad is None:
        front_pad = p["w"].shape[0] - 1
    if front_pad:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, front_pad, 0))
    if (tuple(p["w"].shape[:3]) == (3, 3, 3) and stride_t == 1
            and spatial_same and x.shape[1] >= 3):
        return conv3d_causal(x, p["w"], p.get("b"), out_dtype=x.dtype)
    kh = p["w"].shape[1]
    pad_hw = kh // 2 if spatial_same and kh > 1 else 0
    return _xla_conv(p, x, stride=(stride_t, 1, 1),
                     padding=(0, pad_hw, pad_hw))


def _conv2d(p, x, *, stride: int = 1, padding: int = 0):
    """x: [N,H,W,C], kernel [kh,kw,in,out]."""
    if (x.device.type == "cuda" and stride == 1 and padding == 1
            and tuple(p["w"].shape[:2]) == (3, 3)):
        return conv2d_3x3(x, p["w"], p.get("b"), out_dtype=x.dtype)
    return _xla_conv(p, x, stride=stride, padding=padding)


def _xla_conv(p, x, *, stride, padding):
    """A conv the JAX package leaves to XLA: bf16 operands with fp32 sums
    on the card, full fp32 on the CPU (``P.conv``)."""
    return P.conv(p, x, stride=stride, padding=padding,
                  bf16_operands=x.device.type == "cuda")


def _rms_norm_c(p, x, eps: float = 1e-12):
    """F.normalize(x, dim=C)*sqrt(C)*gamma over the last axis."""
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    y = xf / torch.clamp(n, min=eps) * math.sqrt(x.shape[-1])
    return (y * p["gamma"].float()).to(x.dtype)


# --------------------------------------------------------------- blocks


def _res_block_init(gen, cin, cout, dtype):
    dev = gen.device
    p = {
        "norm1": {"gamma": torch.ones((cin,), dtype=dtype, device=dev)},
        "conv1": P.conv_init(gen, cin, cout, (3, 3, 3), dtype=dtype),
        "norm2": {"gamma": torch.ones((cout,), dtype=dtype, device=dev)},
        "conv2": P.conv_init(gen, cout, cout, (3, 3, 3), dtype=dtype),
    }
    if cin != cout:
        p["shortcut"] = P.conv_init(gen, cin, cout, (1, 1, 1), dtype=dtype)
    return p


def _res_block(p, x):
    h = _rms_norm_c(p["norm1"], x)
    h = _causal_conv3d(p["conv1"], F.silu(h))
    h = _rms_norm_c(p["norm2"], h)
    h = _causal_conv3d(p["conv2"], F.silu(h))
    s = _causal_conv3d(p["shortcut"], x) if "shortcut" in p else x
    return h + s


def _attn_block_init(gen, c, dtype):
    dev = gen.device
    return {
        "norm": {"gamma": torch.ones((c,), dtype=dtype, device=dev)},
        "qkv": P.conv_init(gen, c, c * 3, (1, 1), dtype=dtype),
        "proj": {"w": torch.zeros((1, 1, c, c), dtype=dtype, device=dev),
                 "b": torch.zeros((c,), dtype=dtype, device=dev)},
    }


def _attn_block(p, x):
    """Per-frame single-head spatial attention."""
    b, t, h, w, c = x.shape
    xn = _rms_norm_c(p["norm"], x)
    flat = xn.reshape(b * t, h, w, c)
    qkv = _conv2d(p["qkv"], flat).reshape(b * t, h * w, 3, 1, c)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [bt, hw, 1, c]
    o = attention(q, k, v)  # single head
    o = _conv2d(p["proj"], o.reshape(b * t, h, w, c))
    return x + o.reshape(b, t, h, w, c)


def _downsample_init(gen, c, temporal, dtype):
    p = {"conv": P.conv_init(gen, c, c, (3, 3), dtype=dtype)}
    if temporal:
        p["time_conv"] = P.conv_init(gen, c, c, (3, 1, 1), dtype=dtype)
    return p


def _downsample(p, x, temporal: bool):
    b, t, h, w, c = x.shape
    # spatial: ZeroPad2d(right=1, bottom=1) + 3x3 stride-2 valid
    flat = F.pad(x.reshape(b * t, h, w, c), (0, 0, 0, 1, 0, 1))
    y = _conv2d(p["conv"], flat, stride=2)
    y = y.reshape(b, t, y.shape[1], y.shape[2], c)
    if temporal and t > 1:
        # frame 0 identity; frame j>=1 = conv(y[2j-2 : 2j+1])
        rest = _causal_conv3d(p["time_conv"], y, stride_t=2, front_pad=0)
        y = torch.cat([y[:, :1], rest], dim=1)
    return y


def _upsample_init(gen, c, temporal, dtype):
    p = {"conv": P.conv_init(gen, c, c // 2, (3, 3), dtype=dtype)}
    if temporal:
        p["time_conv"] = P.conv_init(gen, c, c * 2, (3, 1, 1), dtype=dtype)
    return p


def _upsample(p, x, temporal: bool):
    b, t, h, w, c = x.shape
    if temporal and t > 1:
        # frame 0 emits itself; frame i>=1 emits two frames from the time
        # conv over [m[i-2], m[i-1], m[i]] with m[0] = m[-1] = 0
        m = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:]], dim=1)
        xp = F.pad(m, (0, 0, 0, 0, 0, 0, 1, 0))
        y2 = _causal_conv3d(p["time_conv"], xp, front_pad=0)
        a, bb = torch.chunk(y2, 2, dim=-1)  # first half ch = frame 2i-1
        inter = torch.stack([a, bb], dim=2).reshape(b, 2 * (t - 1), h, w, c)
        x = torch.cat([x[:, :1], inter], dim=1)
        t = x.shape[1]
    # spatial nearest 2x (one pass over the channels-last buffer) + 3x3 conv
    # c -> c/2
    flat = x.reshape(b * t, h, w, x.shape[-1]).permute(0, 3, 1, 2)
    up = F.interpolate(flat, scale_factor=2, mode="nearest").permute(
        0, 2, 3, 1)
    y = _conv2d(p["conv"], up, padding=1)
    return y.reshape(b, t, 2 * h, 2 * w, y.shape[-1])


# --------------------------------------------------------------- model


def init_wan_vae(gen: torch.Generator, cfg: WanVAEConfig = WanVAEConfig(),
                 dtype=torch.float32) -> dict:
    """Random init on ``gen.device`` (the JAX init's shapes and
    distributions)."""
    d = cfg.dim
    dev = gen.device
    dims = [d * u for u in (1,) + tuple(cfg.dim_mult)]
    z2 = cfg.z_dim * 2

    enc: dict = {"conv_in": P.conv_init(gen, 3, dims[0], (3, 3, 3),
                                        dtype=dtype)}
    stages = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        blocks = []
        c = cin
        for _ in range(cfg.num_res_blocks):
            blocks.append(_res_block_init(gen, c, cout, dtype))
            c = cout
        st = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            st["down"] = _downsample_init(gen, cout,
                                          cfg.temporal_downsample[i], dtype)
        stages.append(st)
    enc["stages"] = stages
    cmid = dims[-1]
    enc["mid"] = {
        "res1": _res_block_init(gen, cmid, cmid, dtype),
        "attn": _attn_block_init(gen, cmid, dtype),
        "res2": _res_block_init(gen, cmid, cmid, dtype),
    }
    enc["norm_out"] = {"gamma": torch.ones((cmid,), dtype=dtype, device=dev)}
    enc["conv_out"] = P.conv_init(gen, cmid, z2, (3, 3, 3), dtype=dtype)

    dec_dims = [d * u for u in
                (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    dec: dict = {"conv_in": P.conv_init(gen, cfg.z_dim, dec_dims[0],
                                        (3, 3, 3), dtype=dtype)}
    dec["mid"] = {
        "res1": _res_block_init(gen, dec_dims[0], dec_dims[0], dtype),
        "attn": _attn_block_init(gen, dec_dims[0], dtype),
        "res2": _res_block_init(gen, dec_dims[0], dec_dims[0], dtype),
    }
    stages = []
    for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2  # the preceding upsample halved the channels
        blocks = []
        c = cin
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_res_block_init(gen, c, cout, dtype))
            c = cout
        st = {"blocks": blocks}
        if i != len(cfg.dim_mult) - 1:
            st["up"] = _upsample_init(gen, cout, cfg.temporal_upsample[i],
                                      dtype)
        stages.append(st)
    dec["stages"] = stages
    dec["norm_out"] = {"gamma": torch.ones((dec_dims[-1],), dtype=dtype,
                                           device=dev)}
    dec["conv_out"] = P.conv_init(gen, dec_dims[-1], 3, (3, 3, 3),
                                  dtype=dtype)
    return {
        "encoder": enc,
        "conv1": P.conv_init(gen, z2, z2, (1, 1, 1), dtype=dtype),
        "conv2": P.conv_init(gen, cfg.z_dim, cfg.z_dim, (1, 1, 1),
                             dtype=dtype),
        "decoder": dec,
    }


def _encoder(p, cfg: WanVAEConfig, x):
    h = _causal_conv3d(p["conv_in"], x)
    for i, st in enumerate(p["stages"]):
        for blk in st["blocks"]:
            h = _res_block(blk, h)
        if "down" in st:
            h = _downsample(st["down"], h, cfg.temporal_downsample[i])
    h = _res_block(p["mid"]["res1"], h)
    h = _attn_block(p["mid"]["attn"], h)
    h = _res_block(p["mid"]["res2"], h)
    h = F.silu(_rms_norm_c(p["norm_out"], h))
    return _causal_conv3d(p["conv_out"], h)


def _decoder(p, cfg: WanVAEConfig, z):
    h = _causal_conv3d(p["conv_in"], z)
    h = _res_block(p["mid"]["res1"], h)
    h = _attn_block(p["mid"]["attn"], h)
    h = _res_block(p["mid"]["res2"], h)
    for i, st in enumerate(p["stages"]):
        for blk in st["blocks"]:
            h = _res_block(blk, h)
        if "up" in st:
            h = _upsample(st["up"], h, cfg.temporal_upsample[i])
    h = F.silu(_rms_norm_c(p["norm_out"], h))
    return _causal_conv3d(p["conv_out"], h)


def _latent_stats(cfg: WanVAEConfig, mean, std, like: torch.Tensor):
    if mean is None and cfg.z_dim == 16:
        mean, std = WAN_LATENTS_MEAN, WAN_LATENTS_STD
    if mean is None:
        return None, None
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return as_t(mean), as_t(std)


@torch.inference_mode()
def vae_encode(params, cfg: WanVAEConfig, video, mean=None, std=None
               ) -> torch.Tensor:
    """video [B,3,T,H,W] in [-1,1] -> normalized latents [B,z,T',H/8,W/8]
    (the deterministic mu head). Compute dtype follows the param dtype."""
    x = video.permute(0, 2, 3, 4, 1).to(params["conv1"]["w"].dtype)
    out = _encoder(params["encoder"], cfg, x)
    mu = _causal_conv3d(params["conv1"], out)[..., :cfg.z_dim]
    mean, std = _latent_stats(cfg, mean, std, mu)
    if mean is not None:
        mu = (mu - mean) / std
    return mu.permute(0, 4, 1, 2, 3)


@torch.inference_mode()
def vae_decode(params, cfg: WanVAEConfig, latents, mean=None, std=None
               ) -> torch.Tensor:
    """normalized latents [B,z,T',H',W'] -> video [B,3,T,H,W] in [-1,1].
    Compute dtype follows the param dtype."""
    z = latents.permute(0, 2, 3, 4, 1)
    mean, std = _latent_stats(cfg, mean, std, z)
    if mean is not None:
        z = z * std + mean
    z = _causal_conv3d(params["conv2"], z.to(params["conv2"]["w"].dtype))
    x = _decoder(params["decoder"], cfg, z)
    return torch.clamp(x.permute(0, 4, 1, 2, 3), -1.0, 1.0)
