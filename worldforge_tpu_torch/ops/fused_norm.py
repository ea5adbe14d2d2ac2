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


def modulated_layer_norm(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                         *, eps: float = 1e-6,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, S, D] (any float dtype; computed fp32), sc/sh [B, 1, D].
    Returns LN(x)*(1+sc)+sh in out_dtype. CUDA tensors launch the Triton
    kernel; CPU tensors take ``modulated_layer_norm_ref``."""
    if x.device.type == "cpu":
        return modulated_layer_norm_ref(x, sc, sh, eps=eps,
                                        out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_layer_norm: unsupported device {x.device}")
    return _launch(x, sc, sh, eps, out_dtype)


modulated_layer_norm.launches = 0
