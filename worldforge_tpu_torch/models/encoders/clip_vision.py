"""CLIP ViT-H/14 vision encoder (the Wan i2v image conditioning) in PyTorch.

Counterpart of ``worldforge_tpu/models/encoders/clip_vision.py``
(``CLIPVisionConfig``, ``preprocess_clip`` :81, ``clip_vision_hidden``
:91-128, ``init_clip_projection`` / ``clip_vision_image_embeds`` :131-145):
a pre-LN ViT with a 14x14 patchify, a class token, learned positions and
quick-GELU MLPs, fp32. The Wan pipeline takes the penultimate hidden state
(the last block's input), 257 tokens x 1280. Attention goes through kernel
1 on the card: fp32, 16 heads of 80.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.attention import attention

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1  # 257

    @classmethod
    def vit_h_14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=2, heads=2)


def init_clip_vision(gen: torch.Generator, cfg: CLIPVisionConfig,
                     dtype=torch.float32) -> dict:
    """Random init on ``gen.device`` (the JAX init's shapes and
    distributions; the blocks as a list)."""
    d = cfg.width
    dev = gen.device
    hidden = int(d * cfg.mlp_ratio)
    blocks = [{
        "ln1": P.layer_norm_init(d, dtype=dtype, device=dev),
        "q": P.dense_init(gen, d, d, dtype=dtype),
        "k": P.dense_init(gen, d, d, dtype=dtype),
        "v": P.dense_init(gen, d, d, dtype=dtype),
        "o": P.dense_init(gen, d, d, dtype=dtype),
        "ln2": P.layer_norm_init(d, dtype=dtype, device=dev),
        "fc1": P.dense_init(gen, d, hidden, dtype=dtype),
        "fc2": P.dense_init(gen, hidden, d, dtype=dtype),
    } for _ in range(cfg.layers)]
    return {
        "patch": P.dense_init(gen, cfg.patch_size ** 2 * 3, d, bias=False,
                              dtype=dtype),
        "cls": torch.zeros((1, 1, d), dtype=dtype, device=dev),
        "pos": P.normal(gen, (1, cfg.tokens, d), 0.02).to(dtype),
        "ln_pre": P.layer_norm_init(d, dtype=dtype, device=dev),
        "blocks": blocks,
        "ln_post": P.layer_norm_init(d, dtype=dtype, device=dev),
    }


def preprocess_clip(image: np.ndarray, size: int = 224) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> normalised [1, 3, size, size] (PIL
    bicubic on the uint8 image, as the JAX package)."""
    from PIL import Image
    img = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    img = img.resize((size, size), Image.BICUBIC)
    arr = np.asarray(img).astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)[None]


@torch.inference_mode()
def clip_vision_hidden(params, cfg: CLIPVisionConfig, pixels: torch.Tensor,
                       penultimate: bool = True) -> torch.Tensor:
    """pixels [B, 3, S, S] normalised -> hidden states [B, 257, width]:
    the last block's input (transformers' hidden_states[-2]) with
    ``penultimate``, else its output."""
    b = pixels.shape[0]
    ps = cfg.patch_size
    g = cfg.image_size // ps
    x = pixels.permute(0, 2, 3, 1).reshape(b, g, ps, g, ps, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, ps * ps * 3)
    x = P.dense(params["patch"], x.float())
    cls = params["cls"].float().expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos"].float()
    x = P.layer_norm(params["ln_pre"], x, eps=cfg.eps)
    hd = cfg.width // cfg.heads
    blocks = params["blocks"]
    for i, p in enumerate(blocks):
        if penultimate and i == len(blocks) - 1:
            return x
        y = P.layer_norm(p["ln1"], x, eps=cfg.eps)
        q, k, v = (P.dense(p[n], y).reshape(b, -1, cfg.heads, hd)
                   for n in ("q", "k", "v"))
        x = x + P.dense(p["o"], attention(q, k, v).reshape(b, -1, cfg.width))
        y = P.dense(p["fc1"], P.layer_norm(p["ln2"], x, eps=cfg.eps))
        x = x + P.dense(p["fc2"], y * torch.sigmoid(1.702 * y))
    return x


def init_clip_projection(gen: torch.Generator, cfg: CLIPVisionConfig,
                         projection_dim: int = 1024,
                         dtype=torch.float32) -> dict:
    return {"proj": P.dense_init(gen, cfg.width, projection_dim, bias=False,
                                 dtype=dtype)}


def clip_vision_image_embeds(params, proj_params, cfg: CLIPVisionConfig,
                             pixels: torch.Tensor) -> torch.Tensor:
    """The post-LN class token through the visual projection (CLIP's
    image_embeds): [B, 3, S, S] -> [B, projection_dim]."""
    h = clip_vision_hidden(params, cfg, pixels, penultimate=False)
    cls_tok = P.layer_norm(params["ln_post"], h[:, 0], eps=cfg.eps)
    return P.dense(proj_params["proj"], cls_tok)
