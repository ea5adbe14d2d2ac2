"""Causal 3x3x3 stride-1 convolution for the VAE — kernel 4.

Counterpart of ``worldforge_tpu/ops/conv3d.py::conv3d_causal_pallas``; the
Pallas TPU kernel ``_conv_kernel`` (:39, ``pallas_call`` :119) becomes the
CUDA C++ implicit GEMM in ``csrc/conv3d.cu`` (the design note and what
bounds it on the H100 are at the top of that file).

Contract: x [B, T+2, H, W, Cin] already front-padded in time, SAME spatial
padding, w [3, 3, 3, Cin, Cout] (DHWIO), optional bias [Cout]. Inputs and
weights are rounded to bf16, products accumulate in fp32, the fp32 bias is
added and the result is cast to ``out_dtype``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core.params import no_tf32
from worldforge_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv3d_causal_plain(x, w, b=None, *, out_dtype=None):
    """The kernel's function in plain PyTorch: a cuDNN/ATen fp32 conv of the
    bf16-rounded operands (exact bf16 products, fp32 sums; TF32 off)."""
    out_dtype = out_dtype or x.dtype
    xb = x.to(torch.bfloat16).float().permute(0, 4, 1, 2, 3)   # NCDHW view
    wb = w.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2)   # OIDHW
    with no_tf32():
        y = F.conv3d(xb, wb, padding=(0, 1, 1))
    y = y.permute(0, 2, 3, 4, 1)
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).contiguous()


def _pick_bn(cout_p: int) -> int:
    """The widest Cout slice (at most 128) that divides CoutP."""
    for bn in (128, 96, 64, 48, 32, 16):
        if cout_p % bn == 0:
            return bn
    raise ValueError(f"CoutP {cout_p} is not a multiple of 16")


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def prepare_weight(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, 3, Cin, Cout] -> bf16 [27, Cin16, Cout16] zero-padded to
    multiples of 16, the layout the kernel stages from."""
    cin, cout = w.shape[3], w.shape[4]
    wp = torch.zeros((27, _round16(cin), _round16(cout)),
                     dtype=torch.bfloat16, device=w.device)
    wp[:, :cin, :cout] = w.reshape(27, cin, cout).to(torch.bfloat16)
    return wp


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("conv3d", {
        "wf_conv3d_causal": ([p, p, p, p] + [i] * 9 + [p], i),
        "wf_conv3d_error_string": ([i], ctypes.c_char_p),
    })


def _launch(x, w, b, out_dtype):
    bn_, tp, hh, ww, cin = x.shape
    if w.shape[:4] != (3, 3, 3, cin):
        raise ValueError(f"conv3d kernel: weight {tuple(w.shape)} for input "
                         f"{tuple(x.shape)}")
    if tp < 3:
        raise ValueError("conv3d kernel: needs at least 3 padded frames")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3d kernel: output dtype {out_dtype}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("conv3d kernel: tensors on two devices")
    cout = w.shape[4]
    # the kernel reads bf16 with Cin padded to 16 (the Pallas wrapper casts
    # x to bf16 before its kernel as well)
    xb = x.to(torch.bfloat16)
    if cin % 16:
        xb = F.pad(xb, (0, _round16(cin) - cin))
    xb = xb.contiguous()
    wp = prepare_weight(w)
    bias = (b.float().contiguous() if b is not None else
            torch.zeros((cout,), dtype=torch.float32, device=x.device))
    y = torch.empty((bn_, tp - 2, hh, ww, cout), dtype=out_dtype,
                    device=x.device)
    lib = _lib()
    err = lib.wf_conv3d_causal(
        xb.data_ptr(), wp.data_ptr(), bias.data_ptr(), y.data_ptr(), bn_, tp,
        hh, ww, xb.shape[-1], cout, wp.shape[2], _pick_bn(wp.shape[2]),
        _DTYPE_CODE[out_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv3d kernel launch failed: "
                           + lib.wf_conv3d_error_string(err).decode())
    conv3d_causal.launches += 1
    return y


def conv3d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *,
                  out_dtype=None) -> torch.Tensor:
    """x [B, T+2, H, W, Cin] (temporally pre-padded), w [3,3,3,Cin,Cout],
    b [Cout] or None. Returns [B, T, H, W, Cout]. CUDA tensors launch the
    kernel; CPU tensors take ``conv3d_causal_plain``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv3d_causal_plain(x, w, b, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_causal: unsupported device {x.device}")
    return _launch(x, w, b, out_dtype)


conv3d_causal.launches = 0
