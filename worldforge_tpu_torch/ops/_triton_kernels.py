"""Triton kernels of the port: q/k RoPE (kernel 2; its backward is the same
kernel at -theta) and modulated LayerNorm (kernel 3) with its backward.

This module imports ``triton`` at its top, so only the launching functions
(``ops/rope.py::_launch`` and ``ops/fused_norm.py::_launch``) import it, on a
machine with a card; every other module of the package imports without
``triton``. The design notes and bounds are in those two modules.
"""

import triton
import triton.language as tl


@triton.jit
def _rotate_pairs(x_ptr, o_ptr, off, mask, c, sn, BLOCK_S: tl.constexpr,
                  BLOCK_H: tl.constexpr, BLOCK_D: tl.constexpr):
    """Rotate one [BLOCK_S, BLOCK_H, BLOCK_D] tile by its tokens' cos/sin
    [BLOCK_S, 1, BLOCK_D // 2]: contiguous loads and stores along D, the
    interleaved pairs split apart and joined back in registers."""
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    xe, xo = tl.split(tl.reshape(x, (BLOCK_S, BLOCK_H, BLOCK_D // 2, 2)))
    y = tl.join(xe * c - xo * sn, xe * sn + xo * c)
    y = tl.reshape(y, (BLOCK_S, BLOCK_H, BLOCK_D))
    tl.store(o_ptr + off, y.to(o_ptr.dtype.element_ty), mask=mask)


@triton.jit
def rope_qk_kernel(q_ptr, k_ptr, cos_ptr, sin_ptr, qo_ptr, ko_ptr, NTOK, S,
                   H, D: tl.constexpr, BLOCK_S: tl.constexpr,
                   BLOCK_H: tl.constexpr, BLOCK_D: tl.constexpr):
    """One program rotates BLOCK_S tokens (of the B * S) x all H heads of q
    and of k, BLOCK_H heads at a time; each token's cos/sin row is read
    once for all its heads."""
    tok = tl.program_id(0) * BLOCK_S + tl.arange(0, BLOCK_S)
    tmask = tok < NTOK
    pair = tl.arange(0, BLOCK_D // 2)
    cs_off = (tok % S)[:, None] * (D // 2) + pair[None, :]
    cs_mask = tmask[:, None] & (pair < D // 2)[None, :]
    c = tl.load(cos_ptr + cs_off, mask=cs_mask, other=0.0)[:, None, :]
    sn = tl.load(sin_ptr + cs_off, mask=cs_mask, other=0.0)[:, None, :]
    d = tl.arange(0, BLOCK_D)[None, None, :]
    row = tok.to(tl.int64)[:, None, None] * H
    for h0 in range(0, H, BLOCK_H):
        heads = h0 + tl.arange(0, BLOCK_H)[None, :, None]
        off = (row + heads) * D + d
        mask = tmask[:, None, None] & (heads < H) & (d < D)
        _rotate_pairs(q_ptr, qo_ptr, off, mask, c, sn, BLOCK_S, BLOCK_H,
                      BLOCK_D)
        _rotate_pairs(k_ptr, ko_ptr, off, mask, c, sn, BLOCK_S, BLOCK_H,
                      BLOCK_D)


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


@triton.jit
def mod_ln_bwd_kernel(x_ptr, sc_ptr, dy_ptr, dx_ptr, pdsc_ptr, pdsh_ptr, S,
                      D, NBLK, eps, ROWS: tl.constexpr,
                      BLOCK_D: tl.constexpr):
    """The backward of ``mod_ln_kernel`` over ROWS rows of one batch row b:
    each row's dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) with
    g = dy * (1 + sc), and the block's partial sums of dy * xhat and dy per
    channel, written to pdsc / pdsh [B, NBLK, D] for the second pass."""
    b = tl.program_id(0)
    blk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    sc1 = 1.0 + tl.load(sc_ptr + b * D + cols, mask=mask,
                        other=0.0).to(tl.float32)
    acc_sc = tl.zeros((BLOCK_D,), dtype=tl.float32)
    acc_sh = tl.zeros((BLOCK_D,), dtype=tl.float32)
    for i in range(ROWS):
        s = blk * ROWS + i
        if s < S:
            base = (b.to(tl.int64) * S + s) * D
            x = tl.load(x_ptr + base + cols, mask=mask,
                        other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + base + cols, mask=mask,
                         other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / D
            xc = tl.where(mask, x - mean, 0.0)
            rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / D + eps)
            xhat = xc * rstd
            g = dy * sc1
            mg = tl.sum(g, axis=0) / D
            mgx = tl.sum(g * xhat, axis=0) / D
            dx = rstd * (g - mg - xhat * mgx)
            tl.store(dx_ptr + base + cols, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)
            acc_sc += dy * xhat
            acc_sh += dy
    poff = (b.to(tl.int64) * NBLK + blk) * D + cols
    tl.store(pdsc_ptr + poff, acc_sc, mask=mask)
    tl.store(pdsh_ptr + poff, acc_sh, mask=mask)


@triton.jit
def colsum_kernel(p_ptr, o_ptr, NBLK, D, BLOCK_N: tl.constexpr,
                  BLOCK_D: tl.constexpr):
    """o[b, d] = sum over n of p[b, n, d] (the second pass of the
    modulation's gradient), BLOCK_D channels of one batch row a program."""
    b = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
    cmask = cols < D
    acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
    for n0 in range(0, NBLK, BLOCK_N):
        rows = n0 + tl.arange(0, BLOCK_N)
        off = (b.to(tl.int64) * NBLK + rows[:, None]) * D + cols[None, :]
        p = tl.load(p_ptr + off, mask=(rows < NBLK)[:, None] & cmask[None, :],
                    other=0.0)
        acc += tl.sum(p, axis=0)
    tl.store(o_ptr + b * D + cols, acc.to(o_ptr.dtype.element_ty),
             mask=cmask)
