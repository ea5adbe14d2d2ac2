"""Flash attention (dense, non-causal, variable kv length) — kernel 1.

Counterpart of ``worldforge_tpu/ops/flash_attention.py::flash_attention``;
the Pallas TPU kernel ``_fa_kernel`` (:34, ``pallas_call`` :124) becomes the
CUDA C++ kernel in ``csrc/flash_attention.cu`` (the design note and what
bounds it on the H100 are at the top of that file).

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` only for tensors on the CPU. Both follow the
kernel's contract, which differs from ``ops/attention.py::sdpa_reference``
in one place: a row with ``kv_len = 0`` gives zeros (the reference gives the
mean of V).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from worldforge_tpu_torch.ops import _build

NEG_INF = -1e30  # finite "minus infinity": keeps exp() NaN-free on padding
_KERNEL_HEAD_DIMS = {torch.bfloat16: (64, 128),
                     torch.float32: (64, 80, 128, 384, 512)}


def flash_attention_plain(q, k, v, *, kv_lens=None, scale=None,
                          return_lse: bool = False, q_chunk: int = 0):
    """The kernel's function in plain PyTorch. q [B, Sq, H, D], k/v
    [B, Sk, H, D]; returns [B, Sq, H, D] (and m, l as [B, H, Sq] fp32).

    fp32 scores and softmax; the probabilities are cast to v's dtype before
    the P.V product (the Pallas kernel's ``p.astype(v.dtype)``). Queries run
    in chunks so the [B, H, chunk, Sk] score block stays near 256 MB."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().permute(0, 2, 3, 1)                    # [B, H, D, Sk]
    vt = v.permute(0, 2, 1, 3)                            # [B, H, Sk, D]
    mask = None
    if kv_lens is not None:
        kl = kv_lens.to(device=q.device, dtype=torch.int64)
        mask = torch.arange(sk, device=q.device)[None, :] < kl[:, None]
        mask = mask[:, None, None, :]                     # [B, 1, 1, Sk]
    if not q_chunk:
        q_chunk = max(1, (64 << 20) // max(1, b * h * sk))
    outs, ms, ls = [], [], []
    for s0 in range(0, sq, q_chunk):
        qc = q[:, s0:s0 + q_chunk].float().permute(0, 2, 1, 3)  # [B,H,c,D]
        s = (qc @ kf) * scale
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        if mask is not None:
            m = torch.where(mask.any(dim=-1, keepdim=True), m,
                            torch.full_like(m, NEG_INF))
        p = torch.exp(s - m)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).float() @ vt.float())
        o = o * torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
        outs.append(o.permute(0, 2, 1, 3).to(q.dtype))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    o = torch.cat(outs, dim=1)
    if return_lse:
        return o, torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)
    return o


def _launch(q, k, v, kv_lens, scale, return_lse):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _KERNEL_HEAD_DIMS or d not in _KERNEL_HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention kernel: no instantiation for "
                         f"dtype {q.dtype} and head dim {d}")
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention kernel: q, k and v must share a dtype")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: shapes {q.shape} "
                         f"{k.shape} {v.shape}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention kernel: tensors on two devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q, k and v must be 16-byte "
                         "aligned (the kernel copies 16-byte vectors)")
    if q.dtype == torch.bfloat16 and any(
            st * t.element_size() % 16 for t in (q, k, v)
            for st in t.stride()[:-1]):
        raise ValueError("flash_attention kernel: every stride of q, k and v "
                         "must be a multiple of 16 bytes (TMA)")
    if kv_lens is None:
        kv_lens = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    m = l = None
    if return_lse:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _lib()
    err = lib.wf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, b, sq, sk, h, d,
        float(scale), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.wf_flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    inst = f"{'bf16' if q.dtype == torch.bfloat16 else 'fp32'} d{d}"
    by = flash_attention.launches_by_instantiation
    by[inst] = by.get(inst, 0) + 1
    shape = flash_attention.launches_by_shape
    key = (inst, b * h, sq, sk)
    shape[key] = shape.get(key, 0) + 1
    return (o, m, l) if return_lse else o


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("flash_attention", {
        "wf_flash_attention": ([p, p, p, p, p, p, p, i, i, i, i, i,
                                ctypes.c_float, i, p], i),
        "wf_flash_attention_error_string": ([i], ctypes.c_char_p),
    })


def flash_attention(q, k, v, *, kv_lens: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Attention over [B, S, H, D] tensors; returns [B, Sq, H, D].

    kv_lens: optional [B] int true key lengths (keys past it are masked).
    return_lse: also return the running max ``m`` and softmax normaliser
    ``l`` per query row as [B, H, Sq] fp32 (the output stays normalised).
    CUDA tensors launch the kernel (bf16 with head dim 64 or 128, fp32 with
    64, 80, 128, 384 or 512) and raise on anything else; CPU tensors take
    ``flash_attention_plain``. Each launch adds one to ``launches``, to
    ``launches_by_instantiation["fp32 d512"]`` (its dtype and head dim) and
    to ``launches_by_shape[("fp32 d512", B * H, Sq, Sk)]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens=kv_lens, scale=scale,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, kv_lens, scale, return_lse)


flash_attention.launches = 0
flash_attention.launches_by_instantiation = {}
flash_attention.launches_by_shape = {}
