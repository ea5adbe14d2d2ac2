"""2-D spatial (H x W) context parallelism (counterpart of
``worldforge_tpu/parallel/cp2d.py``).

The latent grid [B, T, H, W, C] is cut on a (sp_h, sp_w) rank grid with a
near-square factorisation (``get_optimal_split``): rank (i, j) holds rows
i * H / sp_h ... and columns j * W / sp_w ... of every frame, and its RoPE
rows come from ``rope_cos_sin`` with its ``h_offset`` / ``w_offset``.
Attention is Ulysses over both axes at once: one all-to-all over the
sp_h * sp_w ranks scatters the heads (head group i * sp_w + j to rank
(i, j), JAX's order) and gathers every rank's tokens, which
``TokenSplit`` puts back in the raster order. Cross-attention to the
replicated text / CLIP context needs no exchange. The Wan DiT runs these
under a 2-D mesh as JAX's does: ``split_cp_2d`` on the patch tokens,
``ulysses_attention_2d`` and ``cross_attention_2d`` in every block, and
``gather_cp_2d`` before the head.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from worldforge_tpu_torch.core.mesh import (AXIS_DP, AXIS_FSDP, AXIS_SP_H,
                                            AXIS_SP_W, Mesh, TokenSplit,
                                            gather_replicated,
                                            init_process_group)
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.rope import rope_cos_sin
from worldforge_tpu_torch.parallel.ulysses import ulysses_attention


def get_optimal_split(n: int) -> Tuple[int, int]:
    """Near-square factorisation (a, b), a * b = n, a <= b."""
    a = int(math.isqrt(n))
    while n % a != 0:
        a -= 1
    return min(a, n // a), max(a, n // a)


def make_mesh_2d(dp: int = 1, fsdp: int = 1, sp_h: int = 1, sp_w: int = 1,
                 *, device: str = "cuda") -> Mesh:
    """The 4-axis (dp, fsdp, sp_h, sp_w) mesh over every rank of the
    default group, which it joins first if needed."""
    dev = init_process_group(device)
    return Mesh({AXIS_DP: dp, AXIS_FSDP: fsdp, AXIS_SP_H: sp_h,
                 AXIS_SP_W: sp_w}, dev)


def uses_cp2d(mesh) -> bool:
    return (mesh is not None and mesh.shape.get(AXIS_SP_H, 1)
            * mesh.shape.get(AXIS_SP_W, 1) > 1)


def _dims(mesh: Mesh, hh: int, ww: int):
    sph, spw = mesh.shape[AXIS_SP_H], mesh.shape[AXIS_SP_W]
    if hh % sph or ww % spw:
        raise ValueError(f"2-D context parallelism: the {hh} x {ww} token "
                         f"grid does not divide over sp_h x sp_w = "
                         f"{sph} x {spw}")
    return sph, spw, hh // sph, ww // spw


def grid_split(mesh: Mesh, grid, device=None) -> TokenSplit:
    """The ``TokenSplit`` of a raster (T, H, W) token sequence whose rank
    (i, j) holds its spatial block, in (t, h, w) order within the block:
    the rows ``split_cp_2d`` cuts, for the exchanges of
    ``ulysses_attention_2d``."""
    f, hh, ww = grid
    sph, spw, hl, wl = _dims(mesh, hh, ww)
    order = torch.arange(f * hh * ww, device=device).reshape(
        f, sph, hl, spw, wl).permute(1, 3, 0, 2, 4).reshape(-1)
    return TokenSplit(f * hh * ww, mesh, (AXIS_SP_H, AXIS_SP_W),
                      order=order, device=device)


def rope_rows_2d(mesh: Mesh, grid, head_dim: int, device=None):
    """This rank's RoPE cos / sin rows [T * H/sp_h * W/sp_w, D/2]."""
    f, hh, ww = grid
    _, _, hl, wl = _dims(mesh, hh, ww)
    return rope_cos_sin(f, hl, wl, head_dim,
                        h_offset=mesh.coord(AXIS_SP_H) * hl,
                        w_offset=mesh.coord(AXIS_SP_W) * wl, device=device)


def split_cp_2d(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block [B, T, H/sp_h, W/sp_w, C] of a global
    [B, T, H, W, C]."""
    _, _, hl, wl = _dims(mesh, x.shape[2], x.shape[3])
    return x.narrow(2, mesh.coord(AXIS_SP_H) * hl, hl).narrow(
        3, mesh.coord(AXIS_SP_W) * wl, wl)


def gather_cp_2d(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global [B, T, H, W, C] from every rank's block (the backward
    keeps this rank's block; marks both axes in ``mesh.cut_axes``)."""
    sph, spw = mesh.shape[AXIS_SP_H], mesh.shape[AXIS_SP_W]
    b, t, hl, wl, c = x.shape
    mesh.cut_axes.update((AXIS_SP_H, AXIS_SP_W))
    g = gather_replicated(x[None], mesh.group(AXIS_SP_H, AXIS_SP_W), dim=0)
    g = g.reshape(sph, spw, b, t, hl, wl, c).permute(2, 3, 0, 4, 1, 5, 6)
    return g.reshape(b, t, sph * hl, spw * wl, c)


def ulysses_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mesh: Mesh, split: Optional[TokenSplit] = None
                         ) -> torch.Tensor:
    """Self-attention over this rank's blocks [B, T, H/sp_h, W/sp_w, nh, D]
    of global [B, T, H, W, nh, D] tensors: Ulysses over the
    ``grid_split`` of both spatial axes, so nh must divide by
    sp_h * sp_w. A caller that holds the block's tokens flat
    ([B, T * H/sp_h * W/sp_w, nh, D]) passes the ``grid_split`` they
    were cut by."""
    if split is None:
        t, hl, wl = q.shape[1:4]
        split = grid_split(mesh, (t, hl * mesh.shape[AXIS_SP_H],
                                  wl * mesh.shape[AXIS_SP_W]), q.device)

    def fl(x):
        return x.reshape((x.shape[0], -1) + tuple(x.shape[-2:]))

    return ulysses_attention(fl(q), fl(k), fl(v), mesh=None,
                             split=split).reshape(q.shape)


def cross_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, mesh: Mesh) -> torch.Tensor:
    """Cross-attention from this rank's block [B, T, H', W', nh, D] (or its
    tokens flat) to a replicated context [B, Lc, nh, D]: local, no
    exchange."""
    fl = q.reshape((q.shape[0], -1) + tuple(q.shape[-2:]))
    return attention(fl, k, v).reshape(q.shape)
