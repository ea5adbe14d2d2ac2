"""DINOv2 ViT backbone (the VGGT patch embed) in PyTorch.

Counterpart of ``worldforge_tpu/models/vggt/vit.py`` (``DinoViTConfig``,
``vit_block_forward`` :66-90, ``dino_vit_patch_tokens`` :125-148): the same
param tree and fp32 math. Tokens are [cls | position-added patches] with the
register tokens inserted after cls without a position embedding; the
position embedding is resized to the patch grid with ``jax.image.resize``'s
bicubic (Keys, a = -0.5, antialiased when shrinking), which
``F.interpolate`` (a = -0.75, no antialias) does not compute. Attention
goes through ``ops/attention.py``: kernel 1 (fp32, head dim 64) on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.sampling import jax_cubic_weights, jax_resize2d


@dataclasses.dataclass(frozen=True)
class DinoViTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layerscale_init: float = 1.0
    eps: float = 1e-6

    @classmethod
    def vit_large(cls) -> "DinoViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DinoViTConfig":
        return cls(img_size=28, patch_size=14, embed_dim=32, depth=2,
                   num_heads=2, num_register_tokens=2)


def _vit_block_init(gen, dim, heads, mlp_ratio, ls_init, dtype,
                    qk_norm=False):
    dev = gen.device
    hidden = int(dim * mlp_ratio)
    p = {
        "norm1": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "qkv": P.dense_init(gen, dim, dim * 3, dtype=dtype),
        "proj": P.dense_init(gen, dim, dim, dtype=dtype),
        "ls1": {"gamma": torch.full((dim,), ls_init, dtype=dtype, device=dev)},
        "norm2": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "fc1": P.dense_init(gen, dim, hidden, dtype=dtype),
        "fc2": P.dense_init(gen, hidden, dim, dtype=dtype),
        "ls2": {"gamma": torch.full((dim,), ls_init, dtype=dtype, device=dev)},
    }
    if qk_norm:
        p["q_norm"] = P.layer_norm_init(dim // heads, dtype=dtype, device=dev)
        p["k_norm"] = P.layer_norm_init(dim // heads, dtype=dtype, device=dev)
    return p


def vit_block_forward(p, x, heads, *, eps=1e-6, rope_fn=None, qk_norm=False):
    """Pre-LN block with LayerScale; ``rope_fn`` rotates q and k heads
    [B, S, H, D] when given."""
    b, s, c = x.shape
    h = P.layer_norm(p["norm1"], x, eps=eps)
    q, k, v = P.dense(p["qkv"], h).reshape(b, s, 3, heads, c // heads
                                            ).unbind(dim=2)
    if qk_norm:
        q = P.layer_norm(p["q_norm"], q, eps=eps)
        k = P.layer_norm(p["k_norm"], k, eps=eps)
    if rope_fn is not None:
        q, k = rope_fn(q), rope_fn(k)
    o = attention(q, k, v).reshape(b, s, c)
    x = x + P.dense(p["proj"], o) * p["ls1"]["gamma"]
    h = P.layer_norm(p["norm2"], x, eps=eps)
    h = P.dense(p["fc2"], F.gelu(P.dense(p["fc1"], h)))
    return x + h * p["ls2"]["gamma"]


def init_dino_vit(gen: torch.Generator, cfg: DinoViTConfig,
                  dtype=torch.float32) -> dict:
    """Random init on ``gen.device`` (the JAX init's shapes and
    distributions)."""
    dev = gen.device
    g = cfg.img_size // cfg.patch_size
    pdim = cfg.patch_size * cfg.patch_size * 3
    return {
        "patch": P.dense_init(gen, pdim, cfg.embed_dim, dtype=dtype),
        "cls": P.normal(gen, (1, 1, cfg.embed_dim), 0.02).to(dtype),
        "registers": torch.zeros((1, cfg.num_register_tokens, cfg.embed_dim),
                                 dtype=dtype, device=dev),
        "pos": P.normal(gen, (1, g * g + 1, cfg.embed_dim), 0.02).to(dtype),
        "blocks": [_vit_block_init(gen, cfg.embed_dim, cfg.num_heads,
                                   cfg.mlp_ratio, cfg.layerscale_init, dtype)
                   for _ in range(cfg.depth)],
        "norm": P.layer_norm_init(cfg.embed_dim, dtype=dtype, device=dev),
    }


def interp_pos_embed(pos: torch.Tensor, g_h: int, g_w: int) -> torch.Tensor:
    """pos [1, M*M + 1, D] -> [1, g_h*g_w + 1, D]: the grid resized with
    JAX's bicubic, the cls position kept."""
    n = pos.shape[1] - 1
    m = int(round(n ** 0.5))
    if (g_h, g_w) == (m, m):
        return pos
    grid = pos[:, 1:].reshape(1, m, m, pos.shape[-1])
    grid = jax_resize2d(grid, g_h, g_w, jax_cubic_weights)
    return torch.cat([pos[:, :1], grid.reshape(1, g_h * g_w, -1)], dim=1)


def dino_vit_patch_tokens(params, cfg: DinoViTConfig, images: torch.Tensor
                          ) -> torch.Tensor:
    """images [N, 3, H, W] (ImageNet-normalised by the caller) ->
    x_norm_patchtokens [N, (H/14)*(W/14), embed_dim]."""
    n, _, hh, ww = images.shape
    ps = cfg.patch_size
    gh, gw = hh // ps, ww // ps
    x = images.permute(0, 2, 3, 1).reshape(n, gh, ps, gw, ps, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, ps * ps * 3)
    x = P.dense(params["patch"], x.float())
    cls = params["cls"].float().expand(n, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + interp_pos_embed(params["pos"].float(), gh, gw)
    regs = params["registers"].float().expand(n, cfg.num_register_tokens,
                                              cfg.embed_dim)
    x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    for blk in params["blocks"]:
        x = vit_block_forward(blk, x, cfg.num_heads, eps=cfg.eps)
    x = P.layer_norm(params["norm"], x, eps=cfg.eps)
    return x[:, 1 + cfg.num_register_tokens:]
