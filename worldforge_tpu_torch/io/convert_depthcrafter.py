"""DepthCrafter checkpoint conversion: the SVD UNet and temporal VAE from
the diffusers state-dict layout (tencent/DepthCrafter + the stabilityai
SVD VAE), and the CLIP image encoder with its visual projection.

Counterpart of ``worldforge_tpu/io/convert_depthcrafter.py``. Both
converters are strict by default: a missing name raises from
``StrictStateDict`` and a name never consumed raises after the walk, each
a ``ValueError`` in the JAX wording.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import (StrictStateDict, conv, dense,
                                                layer_norm, load_state_dict,
                                                to_leaf)
from worldforge_tpu_torch.models.depthcrafter.unet import SVDUNetConfig
from worldforge_tpu_torch.models.depthcrafter.vae import SVDVAEConfig

_SVD_CTX = ("expected the diffusers layout frozen in "
            "tests/fixtures/svd_unet_manifest.json - regenerate with "
            "tests/test_svd_manifest.py if the upstream layout moved")


class _Walk:
    """The converters' shared pieces over one strict state dict, dtype and
    device."""

    def __init__(self, sd, dtype, dev):
        self.sd, self.dtype, self.dev = sd, dtype, dev

    def d(self, name, bias=True):
        return dense(self.sd, name, self.dtype, self.dev, bias)

    def c(self, name):
        return conv(self.sd, name, self.dtype, self.dev)

    def gn(self, name):
        return layer_norm(self.sd, name, self.dtype, self.dev)

    def res2d(self, pre):
        sd = self.sd
        p = {"norm1": self.gn(f"{pre}.norm1"), "conv1": self.c(f"{pre}.conv1"),
             "norm2": self.gn(f"{pre}.norm2"), "conv2": self.c(f"{pre}.conv2")}
        if f"{pre}.time_emb_proj.weight" in sd:
            p["time_emb_proj"] = self.d(f"{pre}.time_emb_proj")
        if f"{pre}.conv_shortcut.weight" in sd:
            p["conv_shortcut"] = self.c(f"{pre}.conv_shortcut")
        return p

    def mix(self, pre):
        return {"mix_factor": to_leaf(self.sd[f"{pre}.time_mixer.mix_factor"],
                                      torch.float32, self.dev,
                                      lambda m: m.reshape(-1))}

    def st_res(self, pre):
        return {"spatial_res_block": self.res2d(f"{pre}.spatial_res_block"),
                "temporal_res_block": self.res2d(f"{pre}.temporal_res_block"),
                "time_mixer": self.mix(pre)}

    def attn(self, pre):
        return {"to_q": self.d(f"{pre}.to_q", bias=False),
                "to_k": self.d(f"{pre}.to_k", bias=False),
                "to_v": self.d(f"{pre}.to_v", bias=False),
                "to_out": self.d(f"{pre}.to_out.0")}

    def geglu(self, pre):
        return {"proj": self.d(f"{pre}.net.0.proj"),
                "out": self.d(f"{pre}.net.2")}

    def basic(self, pre):
        return {"norm1": self.gn(f"{pre}.norm1"),
                "attn1": self.attn(f"{pre}.attn1"),
                "norm2": self.gn(f"{pre}.norm2"),
                "attn2": self.attn(f"{pre}.attn2"),
                "norm3": self.gn(f"{pre}.norm3"),
                "ff": self.geglu(f"{pre}.ff")}

    def temporal_basic(self, pre):
        return {"norm_in": self.gn(f"{pre}.norm_in"),
                "ff_in": self.geglu(f"{pre}.ff_in"), **self.basic(pre)}

    def st_transformer(self, pre, layers):
        return {
            "norm": self.gn(f"{pre}.norm"),
            "proj_in": self.d(f"{pre}.proj_in"),
            "blocks": [self.basic(f"{pre}.transformer_blocks.{i}")
                       for i in range(layers)],
            "temporal_blocks": [
                self.temporal_basic(f"{pre}.temporal_transformer_blocks.{i}")
                for i in range(layers)],
            "time_pos_embed": {
                "fc1": self.d(f"{pre}.time_pos_embed.linear_1"),
                "fc2": self.d(f"{pre}.time_pos_embed.linear_2")},
            "time_mixer": self.mix(pre),
            "proj_out": self.d(f"{pre}.proj_out"),
        }


def convert_svd_unet(sd, cfg: SVDUNetConfig, dtype=torch.float32,
                     strict: bool = True, device=None) -> dict:
    """diffusers UNetSpatioTemporalConditionModel state dict ->
    ``init_svd_unet``'s tree (JAX ``convert_svd_unet``, :111). ``strict``:
    raise if the checkpoint holds names the walk never consumed (a sign of
    a layout drift)."""
    sd = StrictStateDict(sd, _SVD_CTX)
    w = _Walk(sd, dtype, resolve_device(device))
    n, lpb, tl = (len(cfg.block_out_channels), cfg.layers_per_block,
                  cfg.transformer_layers)

    def block(pre, n_res, sampler, key):
        blk = {"resnets": [w.st_res(f"{pre}.resnets.{j}")
                           for j in range(n_res)], "attentions": []}
        if f"{pre}.attentions.0.proj_in.weight" in sd:
            blk["attentions"] = [w.st_transformer(f"{pre}.attentions.{j}", tl)
                                 for j in range(n_res)]
        if f"{pre}.{sampler}.0.conv.weight" in sd:
            blk[key] = w.c(f"{pre}.{sampler}.0.conv")
        return blk

    params = {
        "conv_in": w.c("conv_in"),
        "time_embedding": {"fc1": w.d("time_embedding.linear_1"),
                           "fc2": w.d("time_embedding.linear_2")},
        "add_embedding": {"fc1": w.d("add_embedding.linear_1"),
                          "fc2": w.d("add_embedding.linear_2")},
        "down_blocks": [block(f"down_blocks.{i}", lpb, "downsamplers",
                              "downsampler") for i in range(n)],
        "mid_block": {
            "resnets": [w.st_res(f"mid_block.resnets.{j}") for j in range(2)],
            "attentions": [w.st_transformer("mid_block.attentions.0", tl)]},
        "up_blocks": [block(f"up_blocks.{i}", lpb + 1, "upsamplers",
                            "upsampler") for i in range(n)],
        "conv_norm_out": w.gn("conv_norm_out"),
        "conv_out": w.c("conv_out"),
    }
    if strict and sd.unused():
        unused = sd.unused()
        raise ValueError(
            f"SVD checkpoint layout mismatch: {len(unused)} keys were "
            f"never consumed (first 10: {unused[:10]})")
    return params


def convert_svd_vae(sd, cfg: SVDVAEConfig, dtype=torch.float32,
                    strict: bool = True, device=None) -> dict:
    """diffusers AutoencoderKLTemporalDecoder state dict ->
    ``init_svd_vae``'s tree (JAX ``convert_svd_vae``, :171): the encoder in
    the standard SD names, the decoder's temporal blocks. ``strict``: raise
    on names never consumed."""
    sd = StrictStateDict(sd, _SVD_CTX)
    w = _Walk(sd, dtype, resolve_device(device))
    boc, lpb = cfg.block_out_channels, cfg.layers_per_block

    def down(i):
        pre = f"encoder.down_blocks.{i}"
        blk = {"resnets": [w.res2d(f"{pre}.resnets.{j}")
                           for j in range(lpb)]}
        if f"{pre}.downsamplers.0.conv.weight" in sd:
            blk["down"] = w.c(f"{pre}.downsamplers.0.conv")
        return blk

    def up(i):
        pre = f"decoder.up_blocks.{i}"
        blk = {"resnets": [w.st_res(f"{pre}.resnets.{j}")
                           for j in range(lpb + 1)]}
        if f"{pre}.upsamplers.0.conv.weight" in sd:
            blk["up"] = w.c(f"{pre}.upsamplers.0.conv")
        return blk

    def mid(pre, res):
        return {"res1": res(f"{pre}.resnets.0"),
                "attn_norm": w.gn(f"{pre}.attentions.0.group_norm"),
                "attn": w.attn(f"{pre}.attentions.0"),
                "res2": res(f"{pre}.resnets.1")}

    enc = {"conv_in": w.c("encoder.conv_in"),
           "down": [down(i) for i in range(len(boc))],
           "mid": mid("encoder.mid_block", w.res2d),
           "norm_out": w.gn("encoder.conv_norm_out"),
           "conv_out": w.c("encoder.conv_out"),
           "quant_conv": w.c("quant_conv")}
    dec = {"conv_in": w.c("decoder.conv_in"),
           "mid": mid("decoder.mid_block", w.st_res),
           "up": [up(i) for i in range(len(boc))],
           "norm_out": w.gn("decoder.conv_norm_out"),
           "conv_out": w.c("decoder.conv_out"),
           "time_conv_out": w.c("decoder.time_conv_out")}
    if strict and sd.unused():
        unused = sd.unused()
        raise ValueError(
            f"SVD VAE checkpoint layout mismatch: {len(unused)} keys "
            f"never consumed (first 10: {unused[:10]})")
    return {"encoder": enc, "decoder": dec}


def load_converted_depthcrafter(checkpoint_dir: str, *, device=None,
                                unet_cfg: Optional[SVDUNetConfig] = None,
                                vae_cfg: Optional[SVDVAEConfig] = None,
                                clip_cfg=None):
    """The DepthCrafter pipeline from ``<dir>/unet``, ``<dir>/vae`` and,
    when present, ``<dir>/image_encoder`` (a CLIP vision model with its
    ``visual_projection``; JAX ``load_converted_depthcrafter``, :224),
    full SVD / CLIP-H configs by default, fp32 on ``device``."""
    from worldforge_tpu_torch.io.convert_encoders import convert_clip_vision
    from worldforge_tpu_torch.models.encoders.clip_vision import \
        CLIPVisionConfig
    from worldforge_tpu_torch.pipelines.depthcrafter import (
        DepthCrafterPipeline, clip_frame_encoder)

    dev = resolve_device(device)
    unet_cfg = unet_cfg or SVDUNetConfig.svd()
    vae_cfg = vae_cfg or SVDVAEConfig.svd()
    unet = convert_svd_unet(load_state_dict(
        os.path.join(checkpoint_dir, "unet")), unet_cfg, device=dev)
    vae = convert_svd_vae(load_state_dict(
        os.path.join(checkpoint_dir, "vae")), vae_cfg, device=dev)
    encode_frames = None
    enc_dir = os.path.join(checkpoint_dir, "image_encoder")
    if os.path.exists(enc_dir):
        clip_cfg = clip_cfg or CLIPVisionConfig.vit_h_14()
        sd = load_state_dict(enc_dir)
        encode_frames = clip_frame_encoder(
            convert_clip_vision(sd, clip_cfg, device=dev),
            {"proj": dense(sd, "visual_projection", torch.float32, dev,
                           bias=False)},
            clip_cfg)
    return DepthCrafterPipeline(unet_params=unet, unet_cfg=unet_cfg,
                                vae_params=vae, vae_cfg=vae_cfg,
                                encode_frames_clip=encode_frames)
