"""Wav2Vec2 checkpoint conversion (HF torch state dict -> the port's tree).

Counterpart of ``worldforge_tpu/io/convert_wav2vec2.py``; the reference
loads an HF Wav2Vec2Model with a weight-normed positional conv
(``longcat_video/audio_process/wav2vec2.py:38-71``).
"""

from __future__ import annotations

import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import dense, layer_norm, to_leaf
from worldforge_tpu_torch.models.encoders.wav2vec2 import Wav2Vec2Config


def _conv1d_w(w: torch.Tensor) -> torch.Tensor:
    """torch [out, in / groups, k] -> [k, in / groups, out]."""
    return w.permute(2, 1, 0)


def _weight_norm_conv(sd, name: str) -> torch.Tensor:
    """The weight-normed conv's weight (``dim=2`` per the reference's init:
    the norm over every axis but the kernel axis), resolved in float64 and
    rounded to fp32 as JAX's ``_weight_norm_conv`` (:33-45); from
    ``weight_g`` / ``weight_v`` or the parametrization spelling
    ``parametrizations.weight.original0`` / ``original1``; a plain
    ``weight`` as stored."""
    for gk, vk in ((f"{name}.weight_g", f"{name}.weight_v"),
                   (f"{name}.parametrizations.weight.original0",
                    f"{name}.parametrizations.weight.original1")):
        if gk in sd:
            g = sd[gk].to(torch.float64)
            v = sd[vk].to(torch.float64)
            norm = (v * v).sum(dim=(0, 1), keepdim=True).sqrt()
            return (g * v / norm).to(torch.float32)
    return sd[f"{name}.weight"]


def convert_wav2vec2(sd, cfg: Wav2Vec2Config, prefix: str = "",
                     dtype=torch.float32, device=None) -> dict:
    """HF Wav2Vec2Model state dict -> ``init_wav2vec2``'s tree (JAX
    ``convert_wav2vec2``, :47): the conv feature extractor (its GroupNorm
    after layer 0), the feature projection, the positional conv and the
    post-LN encoder layers."""
    dev = resolve_device(device)
    fe = f"{prefix}feature_extractor.conv_layers"
    convs = []
    for i in range(len(cfg.conv_dim)):
        layer = {"conv": {"w": to_leaf(sd[f"{fe}.{i}.conv.weight"], dtype,
                                       dev, _conv1d_w)}}
        if f"{fe}.{i}.conv.bias" in sd:
            layer["conv"]["b"] = to_leaf(sd[f"{fe}.{i}.conv.bias"], dtype,
                                         dev)
        if i == 0:
            layer["norm"] = layer_norm(sd, f"{fe}.0.layer_norm", dtype, dev)
        convs.append(layer)

    enc = f"{prefix}encoder"

    def block(i):
        lp = f"{enc}.layers.{i}"
        return {
            "q": dense(sd, f"{lp}.attention.q_proj", dtype, dev),
            "k": dense(sd, f"{lp}.attention.k_proj", dtype, dev),
            "v": dense(sd, f"{lp}.attention.v_proj", dtype, dev),
            "o": dense(sd, f"{lp}.attention.out_proj", dtype, dev),
            "ln": layer_norm(sd, f"{lp}.layer_norm", dtype, dev),
            "ff1": dense(sd, f"{lp}.feed_forward.intermediate_dense", dtype,
                         dev),
            "ff2": dense(sd, f"{lp}.feed_forward.output_dense", dtype, dev),
            "final_ln": layer_norm(sd, f"{lp}.final_layer_norm", dtype, dev),
        }

    pos = f"{enc}.pos_conv_embed.conv"
    return {
        "convs": convs,
        "fp_norm": layer_norm(sd, f"{prefix}feature_projection.layer_norm",
                              dtype, dev),
        "fp_proj": dense(sd, f"{prefix}feature_projection.projection", dtype,
                         dev),
        "pos_conv": {"w": to_leaf(_weight_norm_conv(sd, pos), dtype, dev,
                                  _conv1d_w),
                     "b": to_leaf(sd[f"{pos}.bias"], dtype, dev)},
        "enc_norm": layer_norm(sd, f"{enc}.layer_norm", dtype, dev),
        "layers": [block(i) for i in range(cfg.num_layers)],
    }
