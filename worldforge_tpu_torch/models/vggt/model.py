"""VGGT aggregator: the alternating-attention geometry transformer.

Counterpart of ``worldforge_tpu/models/vggt/model.py`` (``VGGTConfig``,
``rope2d_rotate`` :70, ``make_positions`` :97, ``vggt_aggregator_forward``
:135-203), fp32 throughout:

  - DINOv2-L/14 patch tokens per frame (``vit.py``);
  - a camera token and 4 register tokens, one set for frame 0 and one for
    the rest;
  - 24 dual blocks: attention within each frame over (B*S, P, C), then
    global attention over (B, S*P, C), both with qk LayerNorm, LayerScale
    0.01 and the 2D RoPE (base 100) on the patch tokens;
  - only the tapped layers' outputs [frame_out || global_out] are kept.

JAX scans a segment of layers between taps; here the layers are a Python
loop over a list. Every attention goes through kernel 1 (fp32, head dim
64) on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.models.vggt.vit import (DinoViTConfig,
                                                  _vit_block_init,
                                                  dino_vit_patch_tokens,
                                                  init_dino_vit,
                                                  vit_block_forward)

_RESNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_RESNET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    layerscale_init: float = 0.01
    eps: float = 1e-5   # the aggregator blocks' LayerNorm (DINO uses 1e-6)
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    backbone: DinoViTConfig = dataclasses.field(
        default_factory=DinoViTConfig.vit_large)

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @classmethod
    def vggt_1b(cls) -> "VGGTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VGGTConfig":
        return cls(img_size=28, embed_dim=32, depth=4, num_heads=2,
                   num_register_tokens=2, intermediate_layer_idx=(0, 1, 2, 3),
                   backbone=DinoViTConfig.tiny())


# ------------------------------------------------------------------ 2D RoPE


def rope2d_tables(pos: np.ndarray, d: int, freq: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [S, D] of the 2D RoPE at positions ``pos`` [S, 2] (y, x):
    the angles in float64 on the host, cast to fp32, as JAX computes them;
    each half's quarter-width angles repeated twice."""
    half = d // 2
    inv = 1.0 / (freq ** (np.arange(0, half, 2, dtype=np.float64) / half))
    posf = np.asarray(pos, np.float64)
    ang = [torch.as_tensor(posf[:, i:i + 1] * inv[None], dtype=torch.float32,
                           device=device) for i in (0, 1)]
    ang = torch.cat([ang[0], ang[0], ang[1], ang[1]], dim=-1)
    return ang.cos(), ang.sin()


def rope2d_apply(x: torch.Tensor, tables) -> torch.Tensor:
    """x [B, S, H, D] rotated by ``rope2d_tables``: the y half and the x
    half each GPT-NeoX style, [-t2, t1] on its own halves."""
    cos, sin = (t[None, :, None] for t in tables)
    quarter = x.shape[-1] // 4
    y1, y2, x1, x2 = x.split(quarter, dim=-1)
    rot = torch.cat([-y2, y1, -x2, x1], dim=-1)
    return x * cos + rot * sin


def rope2d_rotate(x: torch.Tensor, pos: np.ndarray,
                  freq: float = 100.0) -> torch.Tensor:
    """VGGT 2D RoPE on x [B, S, H, D] at positions ``pos`` [S, 2] int
    (y, x)."""
    return rope2d_apply(x, rope2d_tables(pos, x.shape[-1], freq, x.device))


def make_positions(gh: int, gw: int, patch_start: int) -> np.ndarray:
    """[patch_start + gh*gw, 2]: zeros for the special tokens, (y+1, x+1)
    for the patches."""
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    pos = np.stack([yy.ravel() + 1, xx.ravel() + 1], axis=-1)
    return np.concatenate([np.zeros((patch_start, 2), np.int64), pos], axis=0)


# ------------------------------------------------------------------ init


def init_vggt_aggregator(gen: torch.Generator, cfg: VGGTConfig,
                         dtype=torch.float32) -> dict:
    """Random init on ``gen.device``, block by block (the JAX init's shapes
    and distributions; the blocks as per-layer lists)."""
    frame_blocks, global_blocks = [], []
    for _ in range(cfg.depth):
        for blocks in (frame_blocks, global_blocks):
            blocks.append(_vit_block_init(
                gen, cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                cfg.layerscale_init, dtype, qk_norm=True))
    return {
        "backbone": init_dino_vit(gen, cfg.backbone, dtype),
        "camera_token": P.normal(gen, (1, 2, 1, cfg.embed_dim), 1e-6
                                 ).to(dtype),
        "register_token": P.normal(
            gen, (1, 2, cfg.num_register_tokens, cfg.embed_dim), 1e-6
        ).to(dtype),
        "frame_blocks": frame_blocks,
        "global_blocks": global_blocks,
    }


# ------------------------------------------------------------------ forward


def vggt_aggregator_forward(params, cfg: VGGTConfig, images: torch.Tensor,
                            taps: Optional[Tuple[int, ...]] = None
                            ) -> Dict[int, torch.Tensor]:
    """images [B, S, 3, H, W] in [0, 1]. Returns {layer: [B, S, P, 2C]} for
    the layers in ``taps`` (default: the intermediate taps and the last)."""
    b, s, _, hh, ww = images.shape
    gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
    if taps is None:
        taps = tuple(sorted(set(cfg.intermediate_layer_idx)
                            | {cfg.depth - 1}))
    dev = images.device
    mean = torch.as_tensor(_RESNET_MEAN, device=dev)[None, None, :, None, None]
    std = torch.as_tensor(_RESNET_STD, device=dev)[None, None, :, None, None]
    imgs = (images.float() - mean) / std
    patch_tokens = dino_vit_patch_tokens(params["backbone"], cfg.backbone,
                                         imgs.reshape(b * s, 3, hh, ww))
    c = cfg.embed_dim

    def expand_special(tok):  # [1, 2, X, C] -> [B*S, X, C]
        tok = tok.float()
        first = tok[:, :1].expand(b, 1, -1, -1)
        rest = tok[:, 1:2].expand(b, s - 1, -1, -1)
        return torch.cat([first, rest], dim=1).reshape(b * s, -1, c)

    tokens = torch.cat([expand_special(params["camera_token"]),
                        expand_special(params["register_token"]),
                        patch_tokens], dim=1)           # [B*S, P, C]
    p_tok = tokens.shape[1]
    pos = make_positions(gh, gw, cfg.patch_start_idx)
    hd = c // cfg.num_heads
    rope_f = rope2d_tables(pos, hd, cfg.rope_freq, dev)
    rope_g = rope2d_tables(np.tile(pos, (s, 1)), hd, cfg.rope_freq, dev)
    outputs: Dict[int, torch.Tensor] = {}
    for layer in range(max(taps) + 1):
        tokens = vit_block_forward(
            params["frame_blocks"][layer], tokens, cfg.num_heads,
            eps=cfg.eps, qk_norm=True,
            rope_fn=lambda t: rope2d_apply(t, rope_f))
        frame_out = tokens
        glob = vit_block_forward(
            params["global_blocks"][layer], tokens.reshape(b, s * p_tok, c),
            cfg.num_heads, eps=cfg.eps, qk_norm=True,
            rope_fn=lambda t: rope2d_apply(t, rope_g))
        tokens = glob.reshape(b * s, p_tok, c)
        if layer in taps:
            outputs[layer] = torch.cat(
                [frame_out.reshape(b, s, p_tok, c),
                 tokens.reshape(b, s, p_tok, c)], dim=-1)
    return outputs
