"""Fused modulated LayerNorm for the adaLN prologue — kernel 3.

Counterpart of ``worldforge_tpu/ops/fused_norm.py``: ``LN(x) * (1 + sc) +
sh`` with fp32 mean / variance and rsqrt, eps 1e-6, x read once and the
result written once in ``out_dtype``. The Pallas TPU kernel
``_mod_ln_kernel`` (:24, ``pallas_call`` :53, through
``modulated_layer_norm`` :38) becomes a Triton kernel here
(``ops/_triton_kernels.py``).

What bounds it on the H100: bytes. At the Wan2.1-14B 480p shape it reads x
fp32 [1, 20280, 5120] (415 MB) and writes bf16 (208 MB), 0.62 GB per call,
with a handful of operations per element. The design is one program per row
of 5120: the row is loaded once into registers, both reductions and the
modulation run there, and one store writes the result.

The JAX package keeps this kernel switched off (``_FUSED_NORM_MODE = "off"``
at ``models/wan/dit.py:361``); the port routes the DiT's adaLN prologue
through it.

Gradients (the JAX package's training takes them by autodiff of the same
function): on CUDA tensors ``_ModLNFn``'s backward is a Triton kernel in
two passes (``mod_ln_bwd_kernel``, then ``colsum_kernel``): one program
per ``_BWD_ROWS`` rows of one batch row recomputes mean and rstd, writes
dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) with g = dy * (1 + sc)
and its block's per-channel sums of dy * xhat and dy; the second pass adds
the blocks into dsc and dsh [B, 1, D]. It reads x and dy and writes dx
once (1.04 GB at the 480p shape: bound by bytes, as the forward), and the
partial sums are 1/_BWD_ROWS of that. A reduction over channels per row
plus one over tokens per channel is what Triton does well. On the CPU
autograd differentiates ``modulated_layer_norm_ref``.
"""

from __future__ import annotations

import torch


def modulated_layer_norm_ref(x, sc, sh, *, eps: float = 1e-6,
                             out_dtype=torch.bfloat16):
    """Plain PyTorch: the exact op sequence the kernel replaces."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * (1.0 + sc.float()) + sh.float()
    return y.to(out_dtype)


_BWD_ROWS = 32   # rows of one backward program


def _launch(x, sc, sh, eps, out_dtype):
    b, s, d = x.shape
    if sc.shape != (b, 1, d) or sh.shape != sc.shape:
        raise ValueError(f"modulated_layer_norm kernel: modulation "
                         f"{sc.shape} {sh.shape} for x {x.shape}")
    for t in (sc, sh):
        if t.device != x.device:
            raise ValueError("modulated_layer_norm kernel: two devices")
    import triton
    from worldforge_tpu_torch.ops._triton_kernels import mod_ln_kernel
    x = x.contiguous()
    sc, sh = sc.contiguous(), sh.contiguous()
    out = torch.empty((b, s, d), dtype=out_dtype, device=x.device)
    block = triton.next_power_of_2(d)
    mod_ln_kernel[(b * s,)](x, sc, sh, out, s, d, float(eps), BLOCK_D=block,
                            num_warps=max(1, min(16, block // 512)))
    modulated_layer_norm.launches += 1
    return out


def modulated_layer_norm_backward(x, sc, dy, *, eps: float = 1e-6):
    """dx (x's dtype), dsc and dsh ([B, 1, D], sc's dtype) of
    ``LN(x) * (1 + sc) + sh`` from x, sc and the output's gradient dy:
    the Triton backward kernel on CUDA tensors (each call adds one to
    ``modulated_layer_norm_backward.launches``)."""
    b, s, d = x.shape
    if dy.shape != x.shape or sc.shape != (b, 1, d):
        raise ValueError(f"modulated_layer_norm backward kernel: dy "
                         f"{tuple(dy.shape)}, sc {tuple(sc.shape)} for x "
                         f"{tuple(x.shape)}")
    for t in (sc, dy):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("modulated_layer_norm backward kernel: CUDA "
                             "tensors on one device only")
    import triton
    from worldforge_tpu_torch.ops._triton_kernels import (colsum_kernel,
                                                          mod_ln_bwd_kernel)
    x, sc, dy = x.contiguous(), sc.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    nblk = triton.cdiv(s, _BWD_ROWS)
    pdsc = torch.empty((b, nblk, d), dtype=torch.float32, device=x.device)
    pdsh = torch.empty_like(pdsc)
    block = triton.next_power_of_2(d)
    mod_ln_bwd_kernel[(b, nblk)](x, sc, dy, dx, pdsc, pdsh, s, d, nblk,
                                 float(eps), ROWS=_BWD_ROWS, BLOCK_D=block,
                                 num_warps=max(1, min(16, block // 512)))
    dsc = torch.empty((b, 1, d), dtype=sc.dtype, device=x.device)
    dsh = torch.empty_like(dsc)
    for part, out in ((pdsc, dsc), (pdsh, dsh)):
        colsum_kernel[(b, triton.cdiv(d, 128))](part, out, nblk, d,
                                                BLOCK_N=32, BLOCK_D=128,
                                                num_warps=4)
    modulated_layer_norm_backward.launches += 1
    return dx, dsc, dsh


modulated_layer_norm_backward.launches = 0


class _ModLNFn(torch.autograd.Function):
    """Kernel 3 with a gradient (CUDA tensors): the forward kernel, then
    ``modulated_layer_norm_backward``."""

    @staticmethod
    def forward(ctx, x, sc, sh, eps, out_dtype):
        ctx.save_for_backward(x, sc)
        ctx.eps = eps
        ctx.sh_dtype = sh.dtype
        return _launch(x, sc, sh, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, sc = ctx.saved_tensors
        dx, dsc, dsh = modulated_layer_norm_backward(x, sc, dy, eps=ctx.eps)
        return dx, dsc, dsh.to(ctx.sh_dtype), None, None


def modulated_layer_norm(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                         *, eps: float = 1e-6,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, S, D] (any float dtype; computed fp32), sc/sh [B, 1, D].
    Returns LN(x)*(1+sc)+sh in out_dtype. CUDA tensors launch the Triton
    kernel, through ``_ModLNFn`` (the backward kernel) where x, sc or sh
    requires a gradient; CPU tensors take ``modulated_layer_norm_ref``."""
    if x.device.type == "cpu":
        return modulated_layer_norm_ref(x, sc, sh, eps=eps,
                                        out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, sc, sh)):
        return _ModLNFn.apply(x, sc, sh, eps, out_dtype)
    return _launch(x, sc, sh, eps, out_dtype)


modulated_layer_norm.launches = 0
