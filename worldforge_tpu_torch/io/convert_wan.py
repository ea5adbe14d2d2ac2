"""Wan2.1 checkpoint conversion: upstream state dicts -> the port's trees.

Counterpart of ``worldforge_tpu/io/convert_wan.py``: the vendored WanModel
layout (``wan/modules/model.py`` names, the official Wan2.1 release) for
the DiT (t2v, i2v, flf2v) and VACE, and the Wan causal VAE
(``wan/modules/vae.py``). Every leaf is made by ``to_leaf``: read, moved to
the device, laid out and cast there, one at a time. The DiT's blocks are
built as the port's per-layer list directly (JAX stacks them to
``[L, ...]`` at ``:83``; stacking and unstacking 14B parameters would
double the peak).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from worldforge_tpu_torch.core.dtypes import (DEFAULT_POLICY, Policy,
                                              resolve_device)
from worldforge_tpu_torch.io.torch_load import (conv, conv3d_to_patch_dense,
                                                dense, load_state_dict,
                                                rms_norm, to_leaf)
from worldforge_tpu_torch.io.torch_load import layer_norm as _layer_norm
from worldforge_tpu_torch.models.wan.dit import WanDiTConfig
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig

F32 = torch.float32


def _ln(sd, name, dtype, dev):
    """An affine LayerNorm when the checkpoint has one, else {} (``norm3``
    without ``cross_attn_norm``)."""
    if f"{name}.weight" in sd:
        return _layer_norm(sd, name, dtype, dev)
    return {}


def _attn(sd, prefix, dtype, dev, img_branch=False):
    p = {k: dense(sd, f"{prefix}.{k}", dtype, dev) for k in "qkvo"}
    p["norm_q"] = rms_norm(sd, f"{prefix}.norm_q", dtype, dev)
    p["norm_k"] = rms_norm(sd, f"{prefix}.norm_k", dtype, dev)
    if img_branch:
        p["k_img"] = dense(sd, f"{prefix}.k_img", dtype, dev)
        p["v_img"] = dense(sd, f"{prefix}.v_img", dtype, dev)
        p["norm_k_img"] = rms_norm(sd, f"{prefix}.norm_k_img", dtype, dev)
    return p


def _block(sd, b, dtype, dev, img_branch):
    return {
        "self_attn": _attn(sd, f"{b}.self_attn", dtype, dev),
        "cross_attn": _attn(sd, f"{b}.cross_attn", dtype, dev, img_branch),
        "norm3": _ln(sd, f"{b}.norm3", dtype, dev),
        "ffn": {"fc1": dense(sd, f"{b}.ffn.0", dtype, dev),
                "fc2": dense(sd, f"{b}.ffn.2", dtype, dev)},
        "modulation": to_leaf(sd[f"{b}.modulation"], F32, dev),
    }


def _patch(sd, name, dtype, dev):
    return {"w": to_leaf(sd[f"{name}.weight"], dtype, dev,
                         conv3d_to_patch_dense),
            "b": to_leaf(sd[f"{name}.bias"], dtype, dev)}


def convert_wan_dit(sd, cfg: WanDiTConfig, dtype=torch.bfloat16,
                    device=None) -> dict:
    """Vendored WanModel state dict -> ``init_wan_dit``'s tree (JAX
    ``convert_wan_dit``, ``io/convert_wan.py:41``). The time embedding,
    time projection and modulations are fp32, the rest ``dtype``; i2v and
    flf2v carry the image branch, flf2v ``img_emb.emb_pos``."""
    dev = resolve_device(device)
    img = cfg.model_type in ("i2v", "flf2v")
    params = {
        "patch_embedding": _patch(sd, "patch_embedding", dtype, dev),
        "text_embedding": {"fc1": dense(sd, "text_embedding.0", dtype, dev),
                           "fc2": dense(sd, "text_embedding.2", dtype, dev)},
        "time_embedding": {"fc1": dense(sd, "time_embedding.0", F32, dev),
                           "fc2": dense(sd, "time_embedding.2", F32, dev)},
        "time_projection": dense(sd, "time_projection.1", F32, dev),
        "blocks": [_block(sd, f"blocks.{i}", dtype, dev, img)
                   for i in range(cfg.num_layers)],
        "head": {"head": dense(sd, "head.head", dtype, dev),
                 "modulation": to_leaf(sd["head.modulation"], F32, dev)},
    }
    if img:
        params["img_emb"] = {
            "norm_in": _ln(sd, "img_emb.proj.0", dtype, dev),
            "fc1": dense(sd, "img_emb.proj.1", dtype, dev),
            "fc2": dense(sd, "img_emb.proj.3", dtype, dev),
            "norm_out": _ln(sd, "img_emb.proj.4", dtype, dev),
        }
        if "img_emb.emb_pos" in sd:   # flf2v (model.py:359-367)
            params["img_emb"]["emb_pos"] = to_leaf(sd["img_emb.emb_pos"],
                                                   dtype, dev)
    return params


def convert_vace(sd, cfg, dtype=torch.bfloat16, device=None) -> dict:
    """VaceWanModel state dict (``wan/modules/vace_model.py:65-135``) ->
    ``models/wan/vace.py``'s tree (JAX ``convert_vace``, :106): the base
    trunk, ``vace_blocks`` (block 0 with ``before_proj``, all with
    ``after_proj``) and ``vace_patch_embedding``. ``cfg`` is a
    ``VaceConfig``."""
    dev = resolve_device(device)
    params = convert_wan_dit(sd, cfg.base, dtype, dev)
    vace_blocks = []
    for n in range(len(cfg.layers)):
        b = f"vace_blocks.{n}"
        blk = _block(sd, b, dtype, dev, img_branch=False)
        blk["after_proj"] = dense(sd, f"{b}.after_proj", dtype, dev)
        if n == 0:
            blk["before_proj"] = dense(sd, f"{b}.before_proj", dtype, dev)
        vace_blocks.append(blk)
    params["vace_blocks"] = vace_blocks
    params["vace_patch_embedding"] = _patch(sd, "vace_patch_embedding",
                                            dtype, dev)
    return params


# ------------------------------------------------------------------ VAE


def _vae_rms(sd, name, dtype, dev):
    return {"gamma": to_leaf(sd[f"{name}.gamma"], dtype, dev,
                             lambda g: g.reshape(-1))}


def convert_wan_vae(sd, cfg: WanVAEConfig = WanVAEConfig(),
                    dtype=F32, device=None) -> dict:
    """``wan/modules/vae.py`` WanVAE_ state dict -> ``init_wan_vae``'s tree
    (JAX ``convert_wan_vae``, :159): the torch module flattens residual,
    attention and resample layers into ``nn.Sequential`` indices, walked
    here in the same order."""
    dev = resolve_device(device)

    def cv(name):
        return conv(sd, name, dtype, dev)

    def res_block(prefix):
        p = {"norm1": _vae_rms(sd, f"{prefix}.residual.0", dtype, dev),
             "conv1": cv(f"{prefix}.residual.2"),
             "norm2": _vae_rms(sd, f"{prefix}.residual.3", dtype, dev),
             "conv2": cv(f"{prefix}.residual.6")}
        if f"{prefix}.shortcut.weight" in sd:
            p["shortcut"] = cv(f"{prefix}.shortcut")
        return p

    def attn_block(prefix):
        return {"norm": _vae_rms(sd, f"{prefix}.norm", dtype, dev),
                "qkv": cv(f"{prefix}.to_qkv"), "proj": cv(f"{prefix}.proj")}

    def mid(prefix):
        return {"res1": res_block(f"{prefix}.0"),
                "attn": attn_block(f"{prefix}.1"),
                "res2": res_block(f"{prefix}.2")}

    def stages(prefix, per_stage, resample):
        out, seq = [], 0
        for i in range(len(cfg.dim_mult)):
            st = {"blocks": []}
            for _ in range(per_stage):
                st["blocks"].append(res_block(f"{prefix}.{seq}"))
                seq += 1
            if i != len(cfg.dim_mult) - 1:
                pre = f"{prefix}.{seq}"
                r = {"conv": cv(f"{pre}.resample.1")}
                if f"{pre}.time_conv.weight" in sd:
                    r["time_conv"] = cv(f"{pre}.time_conv")
                st[resample] = r
                seq += 1
            out.append(st)
        return out

    enc = {"conv_in": cv("encoder.conv1"),
           "stages": stages("encoder.downsamples", cfg.num_res_blocks,
                            "down"),
           "mid": mid("encoder.middle"),
           "norm_out": _vae_rms(sd, "encoder.head.0", dtype, dev),
           "conv_out": cv("encoder.head.2")}
    dec = {"conv_in": cv("decoder.conv1"), "mid": mid("decoder.middle"),
           "stages": stages("decoder.upsamples", cfg.num_res_blocks + 1,
                            "up"),
           "norm_out": _vae_rms(sd, "decoder.head.0", dtype, dev),
           "conv_out": cv("decoder.head.2")}
    return {"encoder": enc, "conv1": cv("conv1"), "conv2": cv("conv2"),
            "decoder": dec}


def load_converted_wan(models_dir: str, variant: str = "480p", *,
                       device=None, dit_cfg: Optional[WanDiTConfig] = None,
                       vae_cfg: Optional[WanVAEConfig] = None,
                       umt5_cfg=None, clip_cfg=None,
                       policy: Policy = DEFAULT_POLICY):
    """The Wan i2v pipeline from a models directory laid out as upstream
    (``transformer/``, ``vae/``, ``text_encoder/``, ``tokenizer/``,
    ``image_encoder/``; JAX ``load_converted_wan``, :250). Returns
    (pipeline, encode_text, encode_image). The configs default to
    Wan2.1-I2V-14B, the Wan2.1 VAE, UMT5-XXL and CLIP-H; the DiT is made in
    ``policy.param_dtype`` (bf16 by default, as JAX), the VAE in fp32.
    ``variant`` is the JAX loader's and, as there, selects nothing."""
    del variant
    from worldforge_tpu_torch.io.convert_encoders import (
        load_clip_vision_encoder, load_umt5_encoder)
    from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline

    dev = resolve_device(device)
    dit_cfg = dit_cfg or WanDiTConfig.wan_14b_i2v()
    vae_cfg = vae_cfg or WanVAEConfig.wan_2_1()
    dit_params = convert_wan_dit(
        load_state_dict(os.path.join(models_dir, "transformer")), dit_cfg,
        policy.param_dtype, dev)
    vae_params = convert_wan_vae(
        load_state_dict(os.path.join(models_dir, "vae")), vae_cfg,
        device=dev)
    pipe = WanI2VPipeline(dit_params=dit_params, dit_cfg=dit_cfg,
                          vae_params=vae_params, vae_cfg=vae_cfg,
                          policy=policy)
    encode_text = load_umt5_encoder(os.path.join(models_dir, "text_encoder"),
                                    os.path.join(models_dir, "tokenizer"),
                                    cfg=umt5_cfg, device=dev)
    encode_image = load_clip_vision_encoder(
        os.path.join(models_dir, "image_encoder"), cfg=clip_cfg, device=dev)
    return pipe, encode_text, encode_image
