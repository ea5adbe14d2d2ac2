"""Minimal functional parameter library (counterpart of
``worldforge_tpu/core/params.py``).

Models are plain functions over explicit param dicts. Layouts are the JAX
package's: dense kernels ``[in, out]`` (apply is ``x @ w``), conv kernels
spatial-first ``(D)HWIO``. Random init draws from an explicit
``torch.Generator`` on the generator's device, so a full-width model is
built on the card without a host round trip.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init


def uniform(gen: torch.Generator, shape, limit: float) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.uniform_(-limit, limit, generator=gen)


def normal(gen: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, std, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = True, init: str = "xavier", std: float = 0.02,
               dtype=torch.float32) -> dict:
    if init == "xavier":
        w = uniform(gen, (in_dim, out_dim), math.sqrt(6.0 / (in_dim + out_dim)))
    elif init == "normal":
        w = normal(gen, (in_dim, out_dim), std)
    elif init == "zeros":
        w = torch.zeros((in_dim, out_dim), device=gen.device)
    else:
        raise ValueError(init)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def layer_norm_init(dim: int, *, affine: bool = True, dtype=torch.float32,
                    device=None) -> dict:
    if not affine:
        return {}
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def rms_norm_init(dim: int, *, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def conv_init(gen: torch.Generator, in_ch: int, out_ch: int,
              kernel: Sequence[int], *, bias: bool = True,
              dtype=torch.float32) -> dict:
    """ND conv params, kernel layout spatial... + (in, out)."""
    fan_in = in_ch * math.prod(kernel)
    fan_out = out_ch * math.prod(kernel)
    w = uniform(gen, (*kernel, in_ch, out_ch), math.sqrt(6.0 / (fan_in + fan_out)))
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_ch,), dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------- dense


def dense(p: dict, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """``x @ w + b`` with the JAX package's dtype rules
    (``worldforge_tpu/core/params.py:42-99``).

    bf16-stored weights under an fp32 compute request keep the fp32
    activation precision with a two-term bf16 split ``x = hi + lo``:
    ``y = hi @ w + lo @ w`` with exact bf16 products accumulated in fp32 (the
    JAX ``preferred_element_type=float32`` dot). PyTorch has no bf16 matmul
    with an fp32 result, so both terms run as fp32 products of the
    bf16-valued operands, which is the same arithmetic."""
    for key in ("w8", "w4", "w6", "lora_down"):
        if key in p:
            raise NotImplementedError(
                f"dense param '{key}': quantized and LoRA weights are not "
                f"ported yet (a later slice of the port)")
    w = p["w"]
    if compute_dtype == torch.float32 and w.dtype == torch.bfloat16:
        wf = w.float()
        if x.dtype == torch.float32:
            hi = x.to(torch.bfloat16)
            lo = (x - hi.float()).to(torch.bfloat16)
            y = hi.float() @ wf + lo.float() @ wf
        else:
            y = x.to(torch.bfloat16).float() @ wf
    else:
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            x = x.to(compute_dtype)
        y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------- norms


def layer_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
               out_dtype=None) -> torch.Tensor:
    """LayerNorm in fp32, cast to ``out_dtype or x.dtype``."""
    odtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if p:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(odtype)


def rms_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-5,
             out_dtype=None) -> torch.Tensor:
    """RMSNorm in fp32; the scale multiplies after the cast back."""
    odtype = out_dtype or x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(odtype) * p["scale"].to(odtype)


def group_norm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def group_norm(p: dict, x: torch.Tensor, *, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channels-last input [N, ..., C]: statistics over the
    spatial dims and the channel group in fp32, as
    ``worldforge_tpu/core/params.py::group_norm`` (the group count falls to
    the largest divisor of C at most ``groups``)."""
    odtype = x.dtype
    c = x.shape[-1]
    g = min(groups, c)
    while c % g != 0:
        g -= 1
    xf = x.float().reshape(x.shape[0], -1, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True,
                               correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * p["scale"].float() + p["bias"].float()).to(odtype)


# ---------------------------------------------------------------- conv


@contextlib.contextmanager
def tf32(allow: bool):
    """Set ``torch.backends.cudnn.allow_tf32`` for the block. cuDNN
    defaults to TF32, which keeps about three decimal digits of an fp32
    operand."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def no_tf32():
    """Run fp32 cuDNN convolutions in full fp32, as the JAX package's fp32
    convs run on the CPU."""
    return tf32(False)


@contextlib.contextmanager
def no_tf32_matmul():
    """Run fp32 cuBLAS matmuls in full fp32 for the block (PyTorch's
    default, which a caller may have changed)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def conv(p: dict, x: torch.Tensor, *, stride=1, padding=0,
         bf16_operands: bool = False) -> torch.Tensor:
    """Channels-last ND convolution (N, *spatial, C) with a spatial-first
    ``(D)HWIO`` kernel, as ``worldforge_tpu/core/params.py::conv``.
    ``padding`` is PyTorch's: an int or one per spatial dim (symmetric).

    The permuted views are PyTorch's channels-last memory formats, so the
    convolution reads and writes the NDHWC / NHWC buffers in place.

    fp32 convolutions run in full fp32 (TF32 off). With ``bf16_operands``
    an fp32 x and w are rounded to bf16 and the convolution runs with TF32
    on: a bf16 value is a TF32 value, so the TF32 algorithms give the exact
    products of the rounded operands, fp32 sums and an fp32 result, which
    is how an XLA conv given no precision runs on the JAX package's chip."""
    w = p["w"].to(x.dtype)
    if bf16_operands and x.dtype == torch.float32:
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    nd = w.ndim - 2
    perm_x = (0, nd + 1) + tuple(range(1, nd + 1))
    perm_w = (nd + 1, nd) + tuple(range(nd))
    fn = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
    with tf32(bf16_operands):
        y = fn(x.permute(perm_x), w.permute(perm_w), stride=stride,
               padding=padding)
    y = y.permute((0,) + tuple(range(2, nd + 2)) + (1,))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------- misc


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/list param tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def make_generator(seed: int, device: Optional[torch.device] = None
                   ) -> torch.Generator:
    return torch.Generator(device=device or "cpu").manual_seed(int(seed))
