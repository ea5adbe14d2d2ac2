"""Triton kernels of the port: q/k RoPE (kernel 2) and modulated LayerNorm
(kernel 3).

This module imports ``triton`` at its top, so only the launching functions
(``ops/rope.py::_launch`` and ``ops/fused_norm.py::_launch``) import it, on a
machine with a card; every other module of the package imports without
``triton``. The design notes and bounds are in those two modules.
"""

import triton
import triton.language as tl


@triton.jit
def rope_qk_kernel(q_ptr, k_ptr, cos_ptr, sin_ptr, qo_ptr, ko_ptr, S, H,
                   HALF, BLOCK_H: tl.constexpr, BLOCK_HALF: tl.constexpr):
    """One program rotates BLOCK_H heads of one token of q and of k."""
    tok = tl.program_id(0)                    # b * S + s
    s = tok % S
    heads = tl.program_id(1) * BLOCK_H + tl.arange(0, BLOCK_H)[:, None]
    pair = tl.arange(0, BLOCK_HALF)[None, :]
    pmask = pair < HALF
    mask = (heads < H) & pmask
    c = tl.load(cos_ptr + s * HALF + pair, mask=pmask, other=0.0)
    sn = tl.load(sin_ptr + s * HALF + pair, mask=pmask, other=0.0)
    off = (tok.to(tl.int64) * H + heads) * (2 * HALF) + 2 * pair
    qe = tl.load(q_ptr + off, mask=mask, other=0.0).to(tl.float32)
    qo = tl.load(q_ptr + off + 1, mask=mask, other=0.0).to(tl.float32)
    tl.store(qo_ptr + off, (qe * c - qo * sn).to(qo_ptr.dtype.element_ty),
             mask=mask)
    tl.store(qo_ptr + off + 1, (qe * sn + qo * c).to(qo_ptr.dtype.element_ty),
             mask=mask)
    ke = tl.load(k_ptr + off, mask=mask, other=0.0).to(tl.float32)
    ko = tl.load(k_ptr + off + 1, mask=mask, other=0.0).to(tl.float32)
    tl.store(ko_ptr + off, (ke * c - ko * sn).to(ko_ptr.dtype.element_ty),
             mask=mask)
    tl.store(ko_ptr + off + 1, (ke * sn + ko * c).to(ko_ptr.dtype.element_ty),
             mask=mask)


@triton.jit
def mod_ln_kernel(x_ptr, sc_ptr, sh_ptr, o_ptr, S, D, eps,
                  BLOCK_D: tl.constexpr):
    """One program normalises and modulates one row of D channels."""
    row = tl.program_id(0)                    # b * S + s
    b = row // S
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    base = row.to(tl.int64) * D
    x = tl.load(x_ptr + base + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / D
    y = xc * tl.rsqrt(var + eps)
    sc = tl.load(sc_ptr + b * D + cols, mask=mask, other=0.0).to(tl.float32)
    sh = tl.load(sh_ptr + b * D + cols, mask=mask, other=0.0).to(tl.float32)
    y = y * (1.0 + sc) + sh
    tl.store(o_ptr + base + cols, y.to(o_ptr.dtype.element_ty), mask=mask)
