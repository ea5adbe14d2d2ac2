"""UMT5 text encoder (the Wan2.1 and LongCat text conditioning) in PyTorch.

Counterpart of ``worldforge_tpu/models/encoders/umt5.py`` (``UMT5Config``,
``rel_position_bucket_matrix`` :49-70, ``init_umt5`` :90, ``umt5_encode``
:163-207). T5 v1.1 conventions: no 1/sqrt(d) attention scale, pre-RMSNorm
blocks, a relative position bias per layer, keys masked with -1e9, a gated
tanh-GELU FFN, a final RMSNorm, and the output zeroed at padded positions.

The attention is an fp32 einsum with the bias folded into the logits, as in
JAX: kernel 1 takes no additive bias, and at 512 tokens it is a small part
of the encoder. umt5-xxl: d_model 4096, d_ff 10240, 24 layers, 64 heads of
64, a 256,384-token vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.quant import quantize_tree


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    d_head: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @classmethod
    def xxl(cls) -> "UMT5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "UMT5Config":
        return cls(vocab_size=128, d_model=32, d_ff=64, num_layers=2,
                   num_heads=2, d_head=16)


def _rel_bucket(relative_position: np.ndarray, num_buckets: int,
                max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative position buckets (a copy of the JAX
    package's, in numpy)."""
    nb = num_buckets // 2
    ret = (relative_position > 0).astype(np.int64) * nb
    n = np.abs(relative_position)
    max_exact = nb // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, nb - 1)
    return ret + np.where(is_small, n, val_large)


def rel_position_bucket_matrix(q_len: int, k_len: int, num_buckets: int = 32,
                               max_distance: int = 128) -> np.ndarray:
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    return _rel_bucket(mem - ctx, num_buckets, max_distance)


def init_umt5_layer(gen: torch.Generator, cfg: UMT5Config,
                    dtype=torch.float32) -> dict:
    dm, inner = cfg.d_model, cfg.num_heads * cfg.d_head
    dev = gen.device
    dense = lambda i, o: P.dense_init(gen, i, o, bias=False, dtype=dtype)
    return {
        "ln1": P.rms_norm_init(dm, dtype=dtype, device=dev),
        "q": dense(dm, inner), "k": dense(dm, inner), "v": dense(dm, inner),
        "o": dense(inner, dm),
        "rel_bias": P.dense_init(gen, cfg.rel_buckets, cfg.num_heads,
                                 bias=False, init="normal", dtype=dtype)["w"],
        "ln2": P.rms_norm_init(dm, dtype=dtype, device=dev),
        "wi_0": dense(dm, cfg.d_ff), "wi_1": dense(dm, cfg.d_ff),
        "wo": dense(cfg.d_ff, dm),
    }


def init_umt5(gen: torch.Generator, cfg: UMT5Config,
              dtype=torch.bfloat16) -> dict:
    """Random init on ``gen.device``, one layer at a time (each drawn in
    fp32 and cast, so the peak is the model plus one fp32 layer); the
    blocks as a list."""
    return init_umt5_layerwise(gen, cfg, dtype)


def init_umt5_layerwise(gen: torch.Generator, cfg: UMT5Config,
                        dtype=torch.bfloat16, layer_transform=None) -> dict:
    """``init_umt5`` with each layer passed through ``layer_transform(tree)
    -> tree`` as it is made; the draws run in the same order either way
    (the embedding, then the blocks), so a transformed build equals the
    transform of ``init_umt5``'s layers from a generator in the same
    state. The embedding and the final norm are not transformed."""
    tf = layer_transform or (lambda t: t)
    embed = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=gen.device)
    for r0 in range(0, cfg.vocab_size, 16384):      # fp32 draws in slices
        rows = min(16384, cfg.vocab_size - r0)
        embed[r0:r0 + rows] = P.normal(gen, (rows, cfg.d_model)).to(dtype)
    return {
        "embed": embed,
        "blocks": [tf(init_umt5_layer(gen, cfg, dtype))
                   for _ in range(cfg.num_layers)],
        "ln_f": P.rms_norm_init(cfg.d_model, dtype=dtype, device=gen.device),
    }


# UMT5's T5 leaf names (wi_0 / wi_1 / wo) are not in quant.DEFAULT_KEYS
UMT5_INT8_KEYS = ("q", "k", "v", "o", "wi_0", "wi_1", "wo")


def init_umt5_int8(gen: torch.Generator, cfg: UMT5Config,
                   dtype=torch.bfloat16) -> dict:
    """W8A8 build of the encoder, layer by layer: the attention and FFN
    products of every block in int8, the embedding (a gather) in
    ``dtype``."""
    return init_umt5_layerwise(
        gen, cfg, dtype, layer_transform=lambda t: quantize_tree(
            t, predicate=lambda path: path.split("/")[-1] in UMT5_INT8_KEYS))


@torch.inference_mode()
def umt5_encode(params, cfg: UMT5Config, input_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """input_ids [B, L] -> hidden states [B, L, d_model] fp32, zero past
    each row's mask."""
    b, L = input_ids.shape
    dev = input_ids.device
    x = params["embed"][input_ids].float()
    buckets = torch.as_tensor(rel_position_bucket_matrix(
        L, L, cfg.rel_buckets, cfg.rel_max_distance), device=dev)
    if attn_mask is None:
        attn_mask = torch.ones((b, L), dtype=torch.int32, device=dev)
    keep = attn_mask.float()
    neg = ((1.0 - keep) * -1e9)[:, None, None, :]             # [B,1,1,L]
    heads = lambda t: t.reshape(b, L, cfg.num_heads, cfg.d_head).float()
    for p in params["blocks"]:
        h = P.rms_norm(p["ln1"], x, eps=cfg.eps, out_dtype=compute_dtype)
        q, k, v = (heads(P.dense(p[n], h)) for n in ("q", "k", "v"))
        bias = p["rel_bias"].float()[buckets].permute(2, 0, 1)[None]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias + neg
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        o = o.reshape(b, L, cfg.num_heads * cfg.d_head).to(compute_dtype)
        x = x + P.dense(p["o"], o).float()
        h2 = P.rms_norm(p["ln2"], x, eps=cfg.eps, out_dtype=compute_dtype)
        gg = F.gelu(P.dense(p["wi_0"], h2), approximate="tanh")
        x = x + P.dense(p["wo"], gg * P.dense(p["wi_1"], h2)).float()
    x = P.rms_norm(params["ln_f"], x, eps=cfg.eps, out_dtype=torch.float32)
    return x * keep[..., None]
