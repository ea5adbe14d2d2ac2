"""LongCat-Video checkpoint conversion (``longcat_video_dit.py`` names), its
LoRA adapters, and the LongCat-Video-Avatar DiT.

Counterpart of ``worldforge_tpu/io/convert_longcat.py``. The blocks are
built as the port's per-layer list directly, and ``merge_lora_stacked``
indexes that list where JAX writes ``.at[i].set`` into the stacked leaf;
its arithmetic is ``models/longcat/dit.py::lora_merged_weight`` (the fp32
product ``down @ up`` with TF32 off on the card, added to the fp32 weight
and rounded once to the leaf's dtype).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from worldforge_tpu_torch.core.dtypes import (DEFAULT_POLICY, Policy,
                                              resolve_device)
from worldforge_tpu_torch.io.torch_load import (conv3d_to_patch_dense, dense,
                                                layer_norm, load_state_dict,
                                                rms_norm, to_leaf)
from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                     lora_merged_weight)
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig

F32 = torch.float32


def _longcat_block(sd, b, dtype, dev):
    return {
        "adaln": dense(sd, f"{b}.adaLN_modulation.1", F32, dev),
        "qkv": dense(sd, f"{b}.attn.qkv", dtype, dev),
        "q_norm": rms_norm(sd, f"{b}.attn.q_norm", F32, dev),
        "k_norm": rms_norm(sd, f"{b}.attn.k_norm", F32, dev),
        "attn_proj": dense(sd, f"{b}.attn.proj", dtype, dev),
        "pre_crs_norm": layer_norm(sd, f"{b}.pre_crs_attn_norm", dtype, dev),
        "x_q": dense(sd, f"{b}.cross_attn.q_linear", dtype, dev),
        "x_kv": dense(sd, f"{b}.cross_attn.kv_linear", dtype, dev),
        "x_q_norm": rms_norm(sd, f"{b}.cross_attn.q_norm", F32, dev),
        "x_k_norm": rms_norm(sd, f"{b}.cross_attn.k_norm", F32, dev),
        "x_proj": dense(sd, f"{b}.cross_attn.proj", dtype, dev),
        "w1": dense(sd, f"{b}.ffn.w1", dtype, dev, bias=False),
        "w3": dense(sd, f"{b}.ffn.w3", dtype, dev, bias=False),
        "w2": dense(sd, f"{b}.ffn.w2", dtype, dev, bias=False),
    }


def _longcat_trunk(sd, dtype, dev) -> dict:
    """Everything of the DiT but the blocks."""
    return {
        "x_embedder": {
            "w": to_leaf(sd["x_embedder.proj.weight"], dtype, dev,
                         conv3d_to_patch_dense),
            "b": to_leaf(sd["x_embedder.proj.bias"], dtype, dev)},
        "t_embedder": {"fc1": dense(sd, "t_embedder.mlp.0", F32, dev),
                       "fc2": dense(sd, "t_embedder.mlp.2", F32, dev)},
        "y_embedder": {"fc1": dense(sd, "y_embedder.y_proj.0", dtype, dev),
                       "fc2": dense(sd, "y_embedder.y_proj.2", dtype, dev)},
        "final": {"adaln": dense(sd, "final_layer.adaLN_modulation.1", F32,
                                 dev),
                  "linear": dense(sd, "final_layer.linear", dtype, dev)},
    }


def convert_longcat_dit(sd, cfg: LongCatDiTConfig, dtype=torch.bfloat16,
                        device=None) -> dict:
    """LongCat-Video DiT state dict -> ``init_longcat_dit``'s tree (JAX
    ``convert_longcat_dit``, :33): adaLN and the q/k RMSNorms fp32, the
    rest ``dtype``."""
    dev = resolve_device(device)
    params = _longcat_trunk(sd, dtype, dev)
    params["blocks"] = [_longcat_block(sd, f"blocks.{i}", dtype, dev)
                        for i in range(cfg.depth)]
    return params


def convert_longcat_lora(sd, network_alpha: float = 64.0,
                         multiplier: float = 1.0) -> Dict[str, dict]:
    """LoRA state dict (``lora_utils`` naming) -> {module path: {down
    [in, r] fp32, up [r, out] fp32, alpha, multiplier}} (JAX
    ``convert_longcat_lora``, :74), on the device the tensors are on.

    - ``lora_up.blocks.N`` (``n_seperate`` > 1, ``lora_utils.py:15-24``):
      the per-chunk ups become one block-diagonal up, so that
      ``down @ up`` reproduces ``LoRAUPParallel(chunk(down(x)))``;
    - alpha: the merge divides it by the total down rank (n * r), so it is
      stored as the ``alpha_scale`` buffer times that rank, or else as
      ``alpha`` (``network_alpha`` without one) times n;
    - ``lora___lorahyphen___`` is dropped and ``___lorahyphen___`` becomes
      '.'."""
    out: Dict[str, dict] = {}
    for dkey in [k for k in sd if k.endswith("lora_down.weight")]:
        base = dkey[: -len(".lora_down.weight")]
        down = sd[dkey].float()
        total = down.shape[0]
        if f"{base}.lora_up.weight" in sd:
            up = sd[f"{base}.lora_up.weight"].float().t()   # [r, out]
            rank = total
        else:
            blocks = []
            while f"{base}.lora_up.blocks.{len(blocks)}.weight" in sd:
                blocks.append(sd[f"{base}.lora_up.blocks.{len(blocks)}"
                                 f".weight"].float().t())
            n = len(blocks)
            rank = total // n
            od = blocks[0].shape[1]
            up = torch.zeros((total, od * n), dtype=F32,
                             device=down.device)
            for j, blk in enumerate(blocks):
                up[j * rank:(j + 1) * rank, j * od:(j + 1) * od] = blk
        if f"{base}.alpha_scale" in sd:   # the buffer (= alpha / dim)
            alpha = float(sd[f"{base}.alpha_scale"]) * total
        else:
            alpha = float(sd[f"{base}.alpha"]) if f"{base}.alpha" in sd \
                else float(network_alpha)
            alpha *= total // rank
        name = base.replace("lora___lorahyphen___", "").replace(
            "___lorahyphen___", ".")
        out[name] = {"down": down.t().contiguous(), "up": up.contiguous(),
                     "alpha": alpha, "multiplier": multiplier}
    return out


_TORCH_TO_TREE = {
    "attn.qkv": "qkv", "attn.proj": "attn_proj",
    "cross_attn.q_linear": "x_q", "cross_attn.kv_linear": "x_kv",
    "cross_attn.proj": "x_proj", "ffn.w1": "w1", "ffn.w2": "w2",
    "ffn.w3": "w3", "adaLN_modulation.1": "adaln",
}


def merge_lora_stacked(params: dict, lora: Dict[str, dict],
                       scale: float = 1.0) -> dict:
    """Merge LoRA adapters into the DiT's blocks (JAX
    ``merge_lora_stacked``, :123-168; the inference equivalent of the
    reference's forward patching, ``longcat_video_dit.py:197-270``).
    Returns a new tree that shares every leaf it does not change. Adapters
    without a block leaf (not under ``blocks.``, an unmapped submodule, or
    a block index past the depth) are printed, not dropped silently."""
    blocks = [dict(b) for b in params["blocks"]]
    skipped = []
    for name, ad in lora.items():
        parts = name.split(".")
        key = _TORCH_TO_TREE.get(".".join(parts[2:]))
        if (parts[0] != "blocks" or key is None
                or int(parts[1]) >= len(blocks) or key not in blocks[0]):
            skipped.append(name)
            continue
        blk = blocks[int(parts[1])]
        blk[key] = dict(blk[key], w=lora_merged_weight(blk[key]["w"], ad,
                                                         scale))
    if skipped:
        # the reference's LoRANetwork prints "Cannot find module" per miss
        # (lora_utils.py); a silently partial merge would give wrong
        # distill outputs with no trace
        print(f"merge_lora_stacked: {len(skipped)} adapter(s) had no "
              f"matching block leaf and were NOT merged: {skipped[:8]}"
              + (" ..." if len(skipped) > 8 else ""))
    return dict(params, blocks=blocks)


def longcat_text_encoder(checkpoint_dir, umt5_cfg, dev):
    """encode_text(str) -> (embeds [1, 512, 4096], mask: the rows with any
    non-zero entry), from ``text_encoder/`` and ``tokenizer/``."""
    from worldforge_tpu_torch.io.convert_encoders import load_umt5_encoder
    encode = load_umt5_encoder(os.path.join(checkpoint_dir, "text_encoder"),
                               os.path.join(checkpoint_dir, "tokenizer"),
                               cfg=umt5_cfg, device=dev)

    def encode_text(text: str):
        emb = encode(text)
        return emb, (emb.abs().sum(-1) > 0).to(torch.int32)

    return encode_text


def load_converted_longcat(checkpoint_dir: str, use_distill: bool = False,
                           *, device=None,
                           dit_cfg: Optional[LongCatDiTConfig] = None,
                           vae_cfg: Optional[WanVAEConfig] = None,
                           umt5_cfg=None, policy: Policy = DEFAULT_POLICY):
    """The LongCat pipeline from ``<dir>/dit``, ``<dir>/vae``,
    ``<dir>/text_encoder`` and ``<dir>/tokenizer`` (JAX
    ``load_converted_longcat``, :171); with ``use_distill`` the distill
    LoRA ``<dir>/lora/cfg_step_lora.safetensors`` is merged when it is
    there. Returns (pipeline, encode_text)."""
    from worldforge_tpu_torch.io.convert_wan import convert_wan_vae
    from worldforge_tpu_torch.pipelines.longcat import LongCatPipeline

    dev = resolve_device(device)
    cfg = dit_cfg or LongCatDiTConfig.longcat_13b()
    params = convert_longcat_dit(
        load_state_dict(os.path.join(checkpoint_dir, "dit")), cfg,
        policy.param_dtype, dev)
    lora_path = os.path.join(checkpoint_dir, "lora",
                             "cfg_step_lora.safetensors")
    if use_distill and os.path.exists(lora_path):
        params = merge_lora_stacked(
            params, convert_longcat_lora(load_state_dict(lora_path)))
    vae_cfg = vae_cfg or WanVAEConfig.wan_2_1()
    vae_params = convert_wan_vae(
        load_state_dict(os.path.join(checkpoint_dir, "vae")), vae_cfg,
        device=dev)
    pipe = LongCatPipeline(dit_params=params, dit_cfg=cfg,
                           vae_params=vae_params, vae_cfg=vae_cfg,
                           policy=policy)
    return pipe, longcat_text_encoder(checkpoint_dir, umt5_cfg, dev)


def convert_avatar_dit(sd, cfg, dtype=torch.bfloat16, device=None) -> dict:
    """Avatar DiT state dict -> ``init_avatar_dit``'s tree (JAX
    ``convert_avatar_dit``, :203): the LongCat blocks with their audio
    pieces (``audio_adaLN_modulation``, the pre-video / pre-audio
    cross-attention norms, the SingleStreamAttention q / kv / norms /
    proj; ``longcat_video_dit_avatar.py:52-96``) and the fp32
    AudioProjModel (``avatar/blocks.py:33-37``). Without
    ``cfg.audio_prenorm`` the reference has an ``nn.Identity`` there: an
    inert LayerNorm keeps the tree's shape. ``cfg`` is an
    ``AvatarConfig``."""
    dev = resolve_device(device)
    params = _longcat_trunk(sd, dtype, dev)
    blocks = []
    for i in range(cfg.base.depth):
        b = f"blocks.{i}"
        blk = _longcat_block(sd, b, dtype, dev)
        a = f"{b}.audio_cross_attn"
        blk.update({
            "audio_adaln": dense(sd, f"{b}.audio_adaLN_modulation.1", F32,
                                 dev),
            "pre_video_norm": layer_norm(sd, f"{b}.pre_video_crs_attn_norm",
                                         dtype, dev),
            "a_q": dense(sd, f"{a}.q_linear", dtype, dev),
            "a_kv": dense(sd, f"{a}.kv_linear", dtype, dev),
            "a_q_norm": rms_norm(sd, f"{a}.q_norm", F32, dev),
            "a_k_norm": rms_norm(sd, f"{a}.k_norm", F32, dev),
            "a_proj": dense(sd, f"{a}.proj", dtype, dev),
        })
        if cfg.audio_prenorm:
            blk["pre_audio_norm"] = layer_norm(
                sd, f"{b}.pre_audio_crs_attn_norm", dtype, dev)
        else:
            blk["pre_audio_norm"] = {
                "scale": torch.ones(cfg.output_dim, dtype=dtype, device=dev),
                "bias": torch.zeros(cfg.output_dim, dtype=dtype, device=dev)}
        blocks.append(blk)
    params["blocks"] = blocks
    params["audio_proj"] = {
        k: dense(sd, f"audio_proj.{k}", F32, dev)
        for k in ("proj1", "proj1_vf", "proj2", "proj3")}
    params["audio_proj"]["norm"] = layer_norm(sd, "audio_proj.norm", F32,
                                              dev)
    return params
