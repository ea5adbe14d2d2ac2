"""UMT5 and CLIP vision checkpoint conversion (transformers layouts).

Counterpart of ``worldforge_tpu/io/convert_encoders.py``. One departure:
``load_umt5_encoder`` converts the weights when it is called, as JAX does,
but imports ``transformers`` and builds the tokenizer only at the first
``encode_text(str)`` call, so a pipeline assembles on a machine without
``transformers``; there the first call raises ``ImportError``. Token ids go
through ``encode_ids`` without a tokenizer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import (dense, layer_norm,
                                                load_state_dict, rms_norm,
                                                to_leaf)
from worldforge_tpu_torch.models.encoders.clip_vision import (
    CLIPVisionConfig, clip_vision_hidden, preprocess_clip)
from worldforge_tpu_torch.models.encoders.umt5 import UMT5Config, umt5_encode


def convert_umt5(sd, cfg: UMT5Config, dtype=torch.bfloat16,
                 device=None) -> dict:
    """transformers UMT5EncoderModel state dict -> ``init_umt5``'s tree
    (JAX ``convert_umt5``, :18): ``encoder.block.N.layer.0`` the
    self-attention, ``.layer.1`` the gated FFN; the embedding from
    ``shared.weight`` or else ``encoder.embed_tokens.weight``."""
    dev = resolve_device(device)

    def d(name):
        return dense(sd, name, dtype, dev, bias=False)

    def block(i):
        b = f"encoder.block.{i}.layer"
        a = f"{b}.0.SelfAttention"
        ff = f"{b}.1.DenseReluDense"
        return {
            "ln1": rms_norm(sd, f"{b}.0.layer_norm", dtype, dev),
            "q": d(f"{a}.q"), "k": d(f"{a}.k"), "v": d(f"{a}.v"),
            "o": d(f"{a}.o"),
            "rel_bias": to_leaf(sd[f"{a}.relative_attention_bias.weight"],
                                dtype, dev),
            "ln2": rms_norm(sd, f"{b}.1.layer_norm", dtype, dev),
            "wi_0": d(f"{ff}.wi_0"), "wi_1": d(f"{ff}.wi_1"),
            "wo": d(f"{ff}.wo"),
        }

    emb = "shared.weight" if "shared.weight" in sd else \
        "encoder.embed_tokens.weight"
    return {"embed": to_leaf(sd[emb], dtype, dev),
            "blocks": [block(i) for i in range(cfg.num_layers)],
            "ln_f": rms_norm(sd, "encoder.final_layer_norm", dtype, dev)}


class UMT5TextEncoder:
    """``encode_text(str) -> [1, max_len, d_model]``, zero past the prompt
    (as WanModel expects, model.py:553-559), from converted UMT5 weights;
    the tokenizer is built at the first call."""

    def __init__(self, params: dict, cfg: UMT5Config, tokenizer_dir: str,
                 max_len: int = 512):
        self.params = params
        self.cfg = cfg
        self.tokenizer_dir = tokenizer_dir
        self.max_len = max_len
        self._tokenizer = None

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def encode_ids(self, input_ids, mask) -> torch.Tensor:
        """ids, mask [B, L] -> [B, L, d_model] fp32 (``umt5_encode``)."""
        return umt5_encode(
            self.params, self.cfg,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(mask, dtype=torch.int32, device=self.device))

    def __call__(self, text: str) -> torch.Tensor:
        if self._tokenizer is None:
            try:
                from transformers import AutoTokenizer
            except ImportError as e:
                raise ImportError(
                    "encoding a prompt needs the 'transformers' package for "
                    "the UMT5 tokenizer; without it pass token ids to "
                    "encode_ids") from e
            self._tokenizer = AutoTokenizer.from_pretrained(
                self.tokenizer_dir)
        ids = self._tokenizer(text, max_length=self.max_len,
                              truncation=True, return_tensors="np")
        n = ids["input_ids"].shape[1]
        input_ids = np.zeros((1, self.max_len), np.int64)
        mask = np.zeros((1, self.max_len), np.int32)
        input_ids[0, :n] = ids["input_ids"][0]
        mask[0, :n] = ids["attention_mask"][0]
        return self.encode_ids(input_ids, mask)


def load_umt5_encoder(model_dir: str, tokenizer_dir: str,
                      max_len: int = 512, *,
                      cfg: Optional[UMT5Config] = None,
                      device=None) -> UMT5TextEncoder:
    """Converted UMT5 (UMT5-XXL by default) on ``device`` as a text encoder
    (JAX ``load_umt5_encoder``, :55); the tokenizer waits for the first
    prompt."""
    cfg = cfg or UMT5Config.xxl()
    return UMT5TextEncoder(
        convert_umt5(load_state_dict(model_dir), cfg, device=device), cfg,
        tokenizer_dir, max_len)


def convert_clip_vision(sd, cfg: CLIPVisionConfig, dtype=torch.float32,
                        device=None) -> dict:
    """transformers CLIPVisionModel state dict -> ``init_clip_vision``'s
    tree (JAX ``convert_clip_vision``, :78): the patch conv [out, 3, 14,
    14] as a dense [(ph pw c), out] (:112-113); ``pre_layrnorm`` (the
    transformers spelling) or ``pre_layernorm``."""
    dev = resolve_device(device)
    pre = "vision_model"

    def d(name):
        return dense(sd, name, dtype, dev)

    def ln(name):
        return layer_norm(sd, name, dtype, dev)

    def block(i):
        b = f"{pre}.encoder.layers.{i}"
        return {"ln1": ln(f"{b}.layer_norm1"),
                "q": d(f"{b}.self_attn.q_proj"),
                "k": d(f"{b}.self_attn.k_proj"),
                "v": d(f"{b}.self_attn.v_proj"),
                "o": d(f"{b}.self_attn.out_proj"),
                "ln2": ln(f"{b}.layer_norm2"),
                "fc1": d(f"{b}.mlp.fc1"), "fc2": d(f"{b}.mlp.fc2")}

    emb = f"{pre}.embeddings"
    ln_pre = f"{pre}.pre_layrnorm" if f"{pre}.pre_layrnorm.weight" in sd \
        else f"{pre}.pre_layernorm"
    return {
        "patch": {"w": to_leaf(
            sd[f"{emb}.patch_embedding.weight"], dtype, dev,
            lambda w: w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]))},
        "cls": to_leaf(sd[f"{emb}.class_embedding"], dtype, dev,
                       lambda c: c.reshape(1, 1, -1)),
        "pos": to_leaf(sd[f"{emb}.position_embedding.weight"], dtype, dev,
                       lambda p: p[None]),
        "ln_pre": ln(ln_pre),
        "blocks": [block(i) for i in range(cfg.layers)],
        "ln_post": ln(f"{pre}.post_layernorm"),
    }


class CLIPImageEncoder:
    """``encode_image(img [H, W, 3] float [0, 1]) -> [1, 257, width]``, the
    penultimate hidden states (``pipeline_wan_i2v_clean.py:207-211``), from
    converted CLIP vision weights."""

    def __init__(self, params: dict, cfg: CLIPVisionConfig):
        self.params = params
        self.cfg = cfg

    def __call__(self, img: np.ndarray) -> torch.Tensor:
        px = preprocess_clip(img, self.cfg.image_size)
        return clip_vision_hidden(
            self.params, self.cfg,
            torch.from_numpy(px).to(self.params["pos"].device))


def load_clip_vision_encoder(model_dir: str, *,
                             cfg: Optional[CLIPVisionConfig] = None,
                             device=None) -> CLIPImageEncoder:
    """Converted CLIP vision weights (CLIP-H by default) on ``device`` as
    an image encoder (JAX ``load_clip_vision_encoder``, :124)."""
    cfg = cfg or CLIPVisionConfig.vit_h_14()
    return CLIPImageEncoder(
        convert_clip_vision(load_state_dict(model_dir), cfg, device=device),
        cfg)
