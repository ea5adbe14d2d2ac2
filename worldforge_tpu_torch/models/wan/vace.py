"""VACE: the video-editing variant of the Wan DiT (a context-block adapter).

Counterpart of ``worldforge_tpu/models/wan/vace.py``. A second stack of Wan
blocks (the "vace blocks", one for each main layer in ``cfg.layers``)
runs over the patch-embedded ``vace_context`` (VAE latents of the source's
inactive and reactive parts and the pixel-shuffled mask,
``pipelines/wan_vace.py``): block 0 adds the main tokens through its
``before_proj``, and every vace block emits ``after_proj(c)``, its hint.
Main layer ``i`` adds ``hint[mapping[i]] * vace_context_scale`` in fp32
after it runs. ``before_proj`` and ``after_proj`` start at zero, so a
randomly initialised model's hints are exactly zero.

Every block is the port's ``wan_dit_layer_forward``, so its kernels are the
Wan DiT's: the modulated LayerNorm (kernel 3), q/k RoPE (kernel 2) and
flash attention (kernel 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig, dit_head,
                                                 embed_text, embed_time,
                                                 init_wan_dit,
                                                 init_wan_dit_layer,
                                                 patchify,
                                                 wan_dit_layer_forward)
from worldforge_tpu_torch.ops.rope import rope_cos_sin


@dataclasses.dataclass(frozen=True)
class VaceConfig:
    base: WanDiTConfig = dataclasses.field(
        default_factory=lambda: WanDiTConfig(model_type="t2v", in_dim=16))
    vace_layers: Optional[Tuple[int, ...]] = None  # default: every 2nd
    vace_in_dim: int = 96

    @property
    def layers(self) -> Tuple[int, ...]:
        if self.vace_layers is not None:
            return self.vace_layers
        return tuple(range(0, self.base.num_layers, 2))

    @classmethod
    def tiny(cls) -> "VaceConfig":
        return cls(base=WanDiTConfig.tiny(model_type="t2v"), vace_in_dim=12)


def init_vace(gen: torch.Generator, cfg: VaceConfig,
              dtype=torch.bfloat16) -> dict:
    """Random init on ``gen.device``: the base DiT, one Wan block per vace
    layer (block 0 with a zero ``before_proj``, each with a zero
    ``after_proj``) and ``vace_patch_embedding``."""
    params = init_wan_dit(gen, cfg.base, dtype)
    d = cfg.base.dim
    dev = gen.device

    def zeros_dense():
        return {"w": torch.zeros((d, d), dtype=dtype, device=dev),
                "b": torch.zeros((d,), dtype=dtype, device=dev)}

    blocks = []
    for n, _ in enumerate(cfg.layers):
        blk = init_wan_dit_layer(gen, cfg.base, dtype)
        if n == 0:
            blk["before_proj"] = zeros_dense()
        blk["after_proj"] = zeros_dense()
        blocks.append(blk)
    params["vace_blocks"] = blocks
    params["vace_patch_embedding"] = P.dense_init(
        gen, cfg.vace_in_dim * math.prod(cfg.base.patch_size), d, dtype=dtype)
    return params


@torch.inference_mode()
def vace_forward(params, cfg: VaceConfig, x, t, vace_context, context,
                 vace_context_scale: float = 1.0,
                 policy: Policy = DEFAULT_POLICY):
    """x: [B, 16, F, H, W]; t: [B]; vace_context: [B, vace_in_dim, F, H, W];
    context: [B, text_len, text_dim]. Returns [B, 16, F, H, W] fp32."""
    bcfg = cfg.base
    cdt = policy.compute_dtype
    pt, ph, pw = bcfg.patch_size
    grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)

    tokens = P.dense(params["patch_embedding"],
                     patchify(x.to(cdt), bcfg.patch_size), compute_dtype=cdt)
    c_tok = P.dense(params["vace_patch_embedding"],
                    patchify(vace_context.to(cdt), bcfg.patch_size),
                    compute_dtype=cdt)
    e, e0 = embed_time(params, bcfg, t)
    ctx = embed_text(params, context, policy)
    cos, sin = rope_cos_sin(*grid, bcfg.head_dim, device=x.device)

    # the hint stack: block 0 takes the main tokens through before_proj,
    # every block emits after_proj(c)
    hints = []
    c = c_tok.float()
    for n, blk in enumerate(params["vace_blocks"]):
        if n == 0:
            c = (P.dense(blk["before_proj"], c.to(cdt)).float()
                 + tokens.float())
        c = wan_dit_layer_forward(blk, bcfg, c, e0, ctx, cos, sin, 0, policy)
        hints.append(P.dense(blk["after_proj"], c.to(cdt)))

    mapping = {layer: n for n, layer in enumerate(cfg.layers)}
    h = tokens.float()
    for i, layer in enumerate(params["blocks"]):
        h = wan_dit_layer_forward(layer, bcfg, h, e0, ctx, cos, sin, 0,
                                  policy)
        if i in mapping:
            h = h + hints[mapping[i]].float() * vace_context_scale
    return dit_head(params, bcfg, h, e, grid)
