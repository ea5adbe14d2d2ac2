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
def _load_row(x_ptr, dy_ptr, base, ch, ct, mt, ok):
    """x and dy of one row as a HEAD piece and a masked TAIL piece, fp32
    (all masked off where ``ok`` is false)."""
    xh = tl.load(x_ptr + base + ch, mask=ok, other=0.0).to(tl.float32)
    xt = tl.load(x_ptr + base + ct, mask=mt & ok, other=0.0).to(tl.float32)
    dyh = tl.load(dy_ptr + base + ch, mask=ok, other=0.0).to(tl.float32)
    dyt = tl.load(dy_ptr + base + ct, mask=mt & ok,
                  other=0.0).to(tl.float32)
    return xh, xt, dyh, dyt


@triton.jit
def mod_ln_bwd_kernel(x_ptr, sc_ptr, dy_ptr, dx_ptr, part_ptr, S, ROWS,
                      NBLK, eps, D: tl.constexpr, HEAD: tl.constexpr,
                      TAIL: tl.constexpr):
    """The backward of ``mod_ln_kernel`` over rows [blk ROWS, (blk + 1)
    ROWS) of batch row b. A row of D channels is held as a HEAD piece (the
    largest power of two <= D) and a TAIL piece (masked past D), so no lane
    past D is spent at D = 5120 (4096 + 1024). Each row's dx = rstd * (g -
    mean(g) - xhat * mean(g * xhat)) with g = dy * (1 + sc); the next row's
    loads are issued before this row's reductions. The block's per-channel
    sums of dy * xhat and dy go to part [2, B, NBLK, D] for
    ``colsum_kernel``."""
    b = tl.program_id(0)
    blk = tl.program_id(1)
    ch = tl.arange(0, HEAD)
    ct = HEAD + tl.arange(0, TAIL)
    mt = ct < D
    sc1h = 1.0 + tl.load(sc_ptr + b * D + ch).to(tl.float32)
    sc1t = 1.0 + tl.load(sc_ptr + b * D + ct, mask=mt,
                         other=0.0).to(tl.float32)
    acc_sch = tl.zeros((HEAD,), dtype=tl.float32)
    acc_sct = tl.zeros((TAIL,), dtype=tl.float32)
    acc_shh = tl.zeros((HEAD,), dtype=tl.float32)
    acc_sht = tl.zeros((TAIL,), dtype=tl.float32)
    s0 = blk * ROWS
    n = tl.minimum(ROWS, S - s0)
    row0 = b.to(tl.int64) * S + s0
    nxh, nxt, ndyh, ndyt = _load_row(x_ptr, dy_ptr, row0 * D, ch, ct, mt,
                                     n > 0)
    for i in range(0, n):
        xh, xt, dyh, dyt = nxh, nxt, ndyh, ndyt
        base = (row0 + i) * D
        nxh, nxt, ndyh, ndyt = _load_row(x_ptr, dy_ptr, base + D, ch, ct, mt,
                                         i + 1 < n)
        mean = (tl.sum(xh, axis=0) + tl.sum(xt, axis=0)) / D
        xch = xh - mean
        xct = tl.where(mt, xt - mean, 0.0)
        gh = dyh * sc1h
        gt = dyt * sc1t
        var = (tl.sum(xch * xch, axis=0) + tl.sum(xct * xct, axis=0)) / D
        mg = (tl.sum(gh, axis=0) + tl.sum(gt, axis=0)) / D
        mgxc = (tl.sum(gh * xch, axis=0) + tl.sum(gt * xct, axis=0)) / D
        rstd = tl.rsqrt(var + eps)
        xhh = xch * rstd
        xht = xct * rstd
        mgx = mgxc * rstd
        dxh = rstd * (gh - mg - xhh * mgx)
        dxt = rstd * (gt - mg - xht * mgx)
        tl.store(dx_ptr + base + ch, dxh.to(dx_ptr.dtype.element_ty))
        tl.store(dx_ptr + base + ct, dxt.to(dx_ptr.dtype.element_ty),
                 mask=mt)
        acc_sch += dyh * xhh
        acc_sct += dyt * xht
        acc_shh += dyh
        acc_sht += dyt
    B = tl.num_programs(0)
    psc = part_ptr + (b.to(tl.int64) * NBLK + blk) * D
    psh = psc + B.to(tl.int64) * NBLK * D
    tl.store(psc + ch, acc_sch)
    tl.store(psc + ct, acc_sct, mask=mt)
    tl.store(psh + ch, acc_shh)
    tl.store(psh + ct, acc_sht, mask=mt)


@triton.jit
def colsum_kernel(p_ptr, o_ptr, NBLK, D, BLOCK_N: tl.constexpr,
                  BLOCK_D: tl.constexpr):
    """o[k, b, d] = sum over n of p[k, b, n, d]: both of the modulation's
    gradients (k = 0: dsc, 1: dsh) in one launch, BLOCK_D channels of one
    (k, b) a program."""
    kb = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
    cmask = cols < D
    acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
    for n0 in range(0, NBLK, BLOCK_N):
        rows = n0 + tl.arange(0, BLOCK_N)
        off = (kb.to(tl.int64) * NBLK + rows[:, None]) * D + cols[None, :]
        p = tl.load(p_ptr + off, mask=(rows < NBLK)[:, None] & cmask[None, :],
                    other=0.0)
        acc += tl.sum(p, axis=0)
    tl.store(o_ptr + kb * D + cols, acc.to(o_ptr.dtype.element_ty),
             mask=cmask)
