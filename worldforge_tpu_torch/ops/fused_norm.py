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
two launches (``mod_ln_bwd_kernel``, then ``colsum_kernel``). It reads x
and dy and writes dx once (1.04 GB at the 480p shape: bound by bytes, as
the forward, 0.310 ms at 3.35 TB/s). The first launch runs one program
per SM for wide rows and two for narrow ones (``_bwd_launch``,
``_bwd_grid``), each over a run of rows of one batch row. A row is held in registers as a power-of-two HEAD piece plus a
masked TAIL piece (4096 + 1024 at D = 5120, so no lane is spent past D),
and the next row's loads are issued before this row's two rounds of
reductions (the mean, then the centred variance, mean(g) and mean(g *
xhat) together). It writes dx = rstd * (g - mean g - xhat * mean(g *
xhat)) with g = dy * (1 + sc), and the program's per-channel sums of dy *
xhat and dy to one partial buffer [2, B, programs, D]. The second launch
adds both sets of partials into dsc and dsh [B, 1, D]. A reduction over
channels per row plus one over tokens per channel is what Triton does
well. On the CPU autograd differentiates ``modulated_layer_norm_ref``.
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


def _bwd_launch(d):
    """(num_warps, programs per SM) of the backward's first launch: 8 warps,
    one program an SM for rows of 4096 channels or more (Wan-14B's 5120,
    LongCat's 4096), two below (Wan-1.3B's 1536), where one program's row
    keeps too few bytes in flight. On the H100 (``ops/tune_backward.py``,
    warps 4 / 8 / 16 by 1 / 2 / 4 / 8 programs an SM) these take 0.4022 /
    0.3064 / 0.2274 ms, within 0.6% of the fastest at each width (16 warps
    and one program 0.4012 at 5120, 4 warps and two programs 0.2260 at
    1536; within 2.2% in a second run); two programs at 5120 take 0.4086,
    one at 1536 takes 0.3661."""
    return (8, 1) if d >= 4096 else (8, 2)


def _bwd_grid(b, s, num_sms, programs_per_sm):
    """(programs per batch row, rows per program) of the backward's first
    launch: about ``programs_per_sm`` programs per SM in all."""
    want = max(1, -(-programs_per_sm * num_sms // max(b, 1)))
    rows = max(1, -(-s // want))
    return -(-s // rows), rows


def _bwd_pieces(d):
    """The HEAD (largest power of two <= d) and TAIL (the rest, rounded
    up to a power of two, at least 16) pieces a row is held in."""
    head = 1 << (d.bit_length() - 1)
    tail = max(16, 1 << max(0, (d - head - 1).bit_length()))
    return head, tail


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
    return _launch_backward(x.contiguous(), sc.contiguous(), dy.contiguous(),
                            eps, *_bwd_launch(d))


def _launch_backward(x, sc, dy, eps, num_warps, per_sm):
    """The two launches on checked, contiguous CUDA tensors, the first with
    ``num_warps`` warps and about ``per_sm`` programs per SM
    (``modulated_layer_norm_backward`` passes ``_bwd_launch``'s;
    ``ops/tune_backward.py`` times others)."""
    import triton
    from worldforge_tpu_torch.ops._triton_kernels import (colsum_kernel,
                                                          mod_ln_bwd_kernel)
    b, s, d = x.shape
    dx = torch.empty_like(x)
    nblk, rows = _bwd_grid(b, s, torch.cuda.get_device_properties(
        x.device).multi_processor_count, per_sm)
    part = torch.empty((2, b, nblk, d), dtype=torch.float32, device=x.device)
    head, tail = _bwd_pieces(d)
    mod_ln_bwd_kernel[(b, nblk)](x, sc, dy, dx, part, s, rows, nblk,
                                 float(eps), D=d, HEAD=head, TAIL=tail,
                                 num_warps=num_warps)
    dsc_dsh = torch.empty((2, b, 1, d), dtype=sc.dtype, device=x.device)
    colsum_kernel[(2 * b, triton.cdiv(d, 128))](part, dsc_dsh, nblk, d,
                                                BLOCK_N=32, BLOCK_D=128,
                                                num_warps=4)
    dsc, dsh = dsc_dsh[0], dsc_dsh[1]
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
