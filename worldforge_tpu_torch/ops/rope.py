"""3D rotary position embeddings for video DiTs — kernel 2.

Counterpart of ``worldforge_tpu/ops/rope.py``. Wan splits head_dim d into
(d - 4*(d//6), 2*(d//6), 2*(d//6)) for (t, h, w), theta 10000, and rotates
interleaved pairs (x[2i], x[2i+1]). The angles are computed on the host in
float64 and cast to fp32 cos/sin tables [S, D/2].

``apply_rope_qk`` replaces the Pallas TPU kernel ``_rope_qk_kernel`` (:101,
``pallas_call`` :140, through ``_rope_qk_pallas`` :132 and
``apply_rope_qk`` :150) with a Triton kernel (``ops/_triton_kernels.py``).
What bounds it on the H100: bytes. It reads q and k once and writes them
once, 0.83 GB at the Wan2.1-14B 480p shape (q, k bf16 [1, 20280, 40, 128]
plus the fp32 tables), against a few operations per element. One program
rotates a run of tokens x all heads (2,535 programs at that shape), reads
each token's cos/sin row once for all its heads, and moves q and k as
contiguous [tokens, heads, D] tiles, which Triton turns into 16-byte vector
loads and stores (8 bf16 or 4 fp32); the interleaved pairs are split and
joined in registers (``tl.reshape`` + ``tl.split`` / ``tl.join``), fp32
math. The pass is one fused elementwise sweep bound by bytes, which is
what Triton is for: CUDA C++ would move the same bytes with the same
vector width. Unlike the JAX wrapper it takes every shape (no fallback for
h % 8 != 0).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def _freqs_1d(positions: np.ndarray, dim: int, theta: float = 10000.0):
    """Angles [len(positions), dim/2] in float64."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(positions.astype(np.float64), inv)


def rope_3d_split(head_dim: int) -> Tuple[int, int, int]:
    """(dim_t, dim_h, dim_w) split of head_dim (each even)."""
    dh = 2 * (head_dim // 6)
    return head_dim - 2 * dh, dh, dh


@functools.lru_cache(maxsize=32)
def rope_3d_angles(f: int, h: int, w: int, head_dim: int,
                   theta: float = 10000.0, h_offset: int = 0,
                   w_offset: int = 0,
                   t_positions: Optional[tuple] = None) -> np.ndarray:
    """Per-token rotation angles [f*h*w, head_dim/2], float64 numpy."""
    dim_t, dim_h, dim_w = rope_3d_split(head_dim)
    tpos = (np.asarray(t_positions, np.float64) if t_positions is not None
            else np.arange(f))
    if tpos.shape[0] != f:
        raise ValueError(f"t_positions has {tpos.shape[0]} entries, f={f}")
    ang_t = _freqs_1d(tpos, dim_t, theta)
    ang_h = _freqs_1d(np.arange(h_offset, h_offset + h), dim_h, theta)
    ang_w = _freqs_1d(np.arange(w_offset, w_offset + w), dim_w, theta)
    out = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], (f, h, w, dim_t // 2)),
        np.broadcast_to(ang_h[None, :, None, :], (f, h, w, dim_h // 2)),
        np.broadcast_to(ang_w[None, None, :, :], (f, h, w, dim_w // 2)),
    ], axis=-1).reshape(f * h * w, head_dim // 2)
    out.setflags(write=False)
    return out


def rope_cos_sin(f: int, h: int, w: int, head_dim: int,
                 theta: float = 10000.0, h_offset: int = 0,
                 w_offset: int = 0, t_positions: Optional[tuple] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables [f*h*w, head_dim/2] (cos/sin taken in fp64)."""
    ang = rope_3d_angles(f, h, w, head_dim, theta, h_offset, w_offset,
                         t_positions)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """Rotate x [B, S, H, D] by per-token cos/sin [S, D/2]; fp32 math, cast
    to out_dtype. (x_even, x_odd) -> (x_even*cos - x_odd*sin,
    x_even*sin + x_odd*cos)."""
    odtype = out_dtype or x.dtype
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 2)
    xe, xo = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    si = sin[None, :, None, :]
    y = torch.stack([xe * c - xo * si, xe * si + xo * c], dim=-1)
    return y.reshape(b, s, h, d).to(odtype)


def apply_rope_qk_plain(q, k, cos, sin, out_dtype=None):
    """The kernel's function in plain PyTorch."""
    return (apply_rope(q, cos, sin, out_dtype=out_dtype),
            apply_rope(k, cos, sin, out_dtype=out_dtype))


_BLOCK_S = 8      # tokens per program
_BLOCK_H = 8      # heads per step of a program's loop over all heads


def _launch(q, k, cos, sin, out_dtype):
    b, s, h, d = q.shape
    if k.shape != q.shape or d % 2:
        raise ValueError(f"apply_rope_qk kernel: shapes {q.shape} {k.shape}")
    if cos.shape != (s, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"apply_rope_qk kernel: tables {cos.shape} for {q.shape}")
    for t in (k, cos, sin):
        if t.device != q.device:
            raise ValueError("apply_rope_qk kernel: tensors on two devices")
    import triton
    from worldforge_tpu_torch.ops._triton_kernels import rope_qk_kernel
    q, k = q.contiguous(), k.contiguous()
    cos = cos.to(torch.float32).contiguous()
    sin = sin.to(torch.float32).contiguous()
    qo = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    ko = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    grid = (triton.cdiv(b * s, _BLOCK_S),)
    rope_qk_kernel[grid](q, k, cos, sin, qo, ko, b * s, s, h, D=d,
                         BLOCK_S=_BLOCK_S, BLOCK_H=_BLOCK_H,
                         BLOCK_D=triton.next_power_of_2(d), num_warps=8)
    apply_rope_qk.launches += 1
    return qo, ko


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, out_dtype=None):
    """Rotate q and k [B, S, H, D] in one pass. CUDA tensors launch the
    Triton kernel; CPU tensors take ``apply_rope_qk_plain``."""
    odtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return apply_rope_qk_plain(q, k, cos, sin, out_dtype=odtype)
    if q.device.type != "cuda":
        raise ValueError(f"apply_rope_qk: unsupported device {q.device}")
    return _launch(q, k, cos, sin, odtype)


apply_rope_qk.launches = 0
