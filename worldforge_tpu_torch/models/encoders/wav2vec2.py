"""Wav2Vec2-base audio encoder (for the LongCat avatar).

Counterpart of ``worldforge_tpu/models/encoders/wav2vec2.py``:
  - a 7-layer Conv1d feature extractor (dims 512, kernels 10/3/3/3/3/2/2,
    strides 5/2/2/2/2/2/2, GroupNorm after layer 0 only, exact GELU);
  - the conv features linearly resampled (align corners) to the video frame
    count;
  - the feature projection LayerNorm(512) -> Linear(512 -> 768);
  - the grouped positional conv (kernel 128, 16 groups; padded k // 2 on
    both sides, the last sample trimmed for an even kernel) + LayerNorm;
  - 12 post-LN transformer layers (12 heads, FFN 3072, GELU).
``wav2vec2_forward`` returns the stack of the encoder layers' outputs,
[B, T, layers, hidden], which the avatar's audio projection consumes.

The attention is a plain fp32 softmax over matmuls, as the JAX package
computes it with an einsum, and the 1-D convs are ``F.conv1d`` in fp32 with
TF32 off (XLA convs in the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.sampling import interp1d_align_corners


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    eps: float = 1e-5

    @classmethod
    def base(cls) -> "Wav2Vec2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "Wav2Vec2Config":
        return cls(conv_dim=(8,) * 3, conv_kernel=(10, 3, 2),
                   conv_stride=(5, 2, 2), hidden_size=16, num_layers=2,
                   num_heads=2, intermediate_size=32,
                   num_conv_pos_embeddings=8,
                   num_conv_pos_embedding_groups=2)


# ------------------------------------------------------------------ init


def _conv1d_init(gen, cin, cout, k, groups=1, bias=False,
                 dtype=torch.float32):
    """A [k, cin / groups, cout] kernel, N(0, 1 / (k * cin / groups))."""
    w = P.normal(gen, (k, cin // groups, cout)) * (
        1.0 / math.sqrt(k * cin // groups))
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=gen.device)
    return p


def _conv1d(p, x, stride=1, groups=1):
    """x [B, T, C] -> [B, T', C'] (VALID), fp32 with TF32 off."""
    w = p["w"].to(x.dtype).permute(2, 1, 0)        # [cout, cin / g, k]
    with P.no_tf32():
        y = F.conv1d(x.transpose(1, 2), w, stride=stride, groups=groups)
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_wav2vec2(gen: torch.Generator, cfg: Wav2Vec2Config,
                  dtype=torch.float32) -> dict:
    """Random init on ``gen.device`` (the JAX init's shapes and
    distributions)."""
    dev = gen.device
    convs = []
    cin = 1
    for i, (co, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        layer = {"conv": _conv1d_init(gen, cin, co, k)}
        if i == 0:
            layer["norm"] = P.group_norm_init(co, dtype=dtype, device=dev)
        convs.append(layer)
        cin = co
    h = cfg.hidden_size
    ln = lambda d: P.layer_norm_init(d, dtype=dtype, device=dev)
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "q": P.dense_init(gen, h, h, dtype=dtype),
            "k": P.dense_init(gen, h, h, dtype=dtype),
            "v": P.dense_init(gen, h, h, dtype=dtype),
            "o": P.dense_init(gen, h, h, dtype=dtype),
            "ln": ln(h),
            "ff1": P.dense_init(gen, h, cfg.intermediate_size, dtype=dtype),
            "ff2": P.dense_init(gen, cfg.intermediate_size, h, dtype=dtype),
            "final_ln": ln(h),
        })
    return {
        "convs": convs,
        "fp_norm": ln(cfg.conv_dim[-1]),
        "fp_proj": P.dense_init(gen, cfg.conv_dim[-1], h, dtype=dtype),
        "pos_conv": _conv1d_init(gen, h, h, cfg.num_conv_pos_embeddings,
                                 groups=cfg.num_conv_pos_embedding_groups,
                                 bias=True),
        "enc_norm": ln(h),
        "layers": layers,
    }


# --------------------------------------------------------------- forward


def linear_interpolate(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Align-corners linear resample of [B, T, C] along T."""
    return interp1d_align_corners(x, seq_len, axis=1)


def wav2vec2_features(params, cfg: Wav2Vec2Config,
                      audio: torch.Tensor) -> torch.Tensor:
    """Raw waveform [B, L] -> conv features [B, T_conv, conv_dim]."""
    x = audio[..., None].float()
    for i, layer in enumerate(params["convs"]):
        x = _conv1d(layer["conv"], x, stride=cfg.conv_stride[i])
        if i == 0:
            x = P.group_norm(layer["norm"], x, groups=cfg.conv_dim[0],
                             eps=cfg.eps)
        x = F.gelu(x)
    return x


def wav2vec2_encode(params, cfg: Wav2Vec2Config,
                    feats: torch.Tensor) -> torch.Tensor:
    """Conv features -> the stacked encoder-layer outputs
    [B, T, num_layers, hidden]."""
    x = P.dense(params["fp_proj"],
                P.layer_norm(params["fp_norm"], feats, eps=cfg.eps))
    k = cfg.num_conv_pos_embeddings
    pos = _conv1d(params["pos_conv"], F.pad(x, (0, 0, k // 2, k // 2)),
                  groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos)
    x = P.layer_norm(params["enc_norm"], x, eps=cfg.eps)

    b, t, _ = x.shape
    h = cfg.num_heads
    hd = cfg.hidden_size // h
    outs = []
    for layer in params["layers"]:
        q = P.dense(layer["q"], x).reshape(b, t, h, hd).transpose(1, 2)
        kk = P.dense(layer["k"], x).reshape(b, t, h, hd).transpose(1, 2)
        v = P.dense(layer["v"], x).reshape(b, t, h, hd).transpose(1, 2)
        att = torch.softmax((q @ kk.transpose(-1, -2)) / math.sqrt(hd),
                            dim=-1)
        o = (att @ v).transpose(1, 2).reshape(x.shape)
        x = P.layer_norm(layer["ln"], x + P.dense(layer["o"], o),
                         eps=cfg.eps)
        ff = P.dense(layer["ff2"], F.gelu(P.dense(layer["ff1"], x)))
        x = P.layer_norm(layer["final_ln"], x + ff, eps=cfg.eps)
        outs.append(x)
    return torch.stack(outs, dim=2)


@torch.inference_mode()
def wav2vec2_forward(params, cfg: Wav2Vec2Config, audio: torch.Tensor,
                     seq_len: int) -> torch.Tensor:
    """Waveform [B, L] -> [B, seq_len, num_layers, hidden]: the conv
    features resampled to the video frame count, then encoded."""
    feats = wav2vec2_features(params, cfg, audio)
    return wav2vec2_encode(params, cfg, linear_interpolate(feats, seq_len))


def get_audio_windows(features: torch.Tensor, window: int = 5
                      ) -> torch.Tensor:
    """[B, T, S, C] per-frame features -> sliding windows
    [B, T, window, S, C], clamped at the edges, centred on each frame."""
    t = features.shape[1]
    mid = window // 2
    idx = np.clip(np.arange(t)[:, None] + np.arange(-mid, window - mid)[None],
                  0, t - 1)
    return features[:, torch.from_numpy(idx).to(features.device)]
