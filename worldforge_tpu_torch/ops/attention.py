"""Attention dispatch (counterpart of ``worldforge_tpu/ops/attention.py``).

``attention`` goes to ``flash_attention``: kernel 1 for CUDA tensors, its
plain version for CPU tensors. ``sdpa_reference`` is the fp32 einsum the
JAX package uses off the TPU; the port keeps it only for tests to compare
against.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from worldforge_tpu_torch.ops.flash_attention import flash_attention


def sdpa_reference(q, k, v, *, kv_lens=None, scale=None):
    """Reference dot-product attention over [B, S, H, D]; fp32 softmax. A row
    whose keys are all masked gives the mean of V (softmax of equal
    scores), unlike the kernel, which gives zeros."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_lens is not None:
        mask = (torch.arange(sk, device=q.device)[None, None, None, :]
                < kv_lens.to(q.device)[:, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention(q, k, v, *, kv_lens: Optional[torch.Tensor] = None,
              scale: Optional[float] = None):
    """Multi-head attention over [B, S, H, D] tensors through
    ``flash_attention`` (the kernel on CUDA, its plain version on the CPU)."""
    return flash_attention(q, k, v, kv_lens=kv_lens, scale=scale)
