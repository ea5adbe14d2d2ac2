"""Ulysses sequence-parallel attention (counterpart of
``worldforge_tpu/parallel/ulysses.py``).

The tokens of a sample are cut over the ``sp`` ranks ([B, S/sp, H, D] on
each); one all-to-all scatters the heads and gathers the sequence
([B, S, H/sp, D]), kernel 1 attends over the full sequence for the rank's
head group, and the inverse all-to-all brings the rows back. The
exchanges are ``core/mesh.py::TokenSplit``'s (differentiable: an
all-to-all is its own adjoint), so the train step trains through them.
"""

from __future__ import annotations

from typing import Optional

import torch

from worldforge_tpu_torch.core.mesh import AXIS_SP, Mesh, TokenSplit
from worldforge_tpu_torch.ops.attention import attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Optional[Mesh], kv_lens: Optional[torch.Tensor] = None,
                      split: Optional[TokenSplit] = None,
                      sp_axis: str = AXIS_SP) -> torch.Tensor:
    """Self-attention over a sequence cut on ``sp_axis``: q, k, v are this
    rank's rows [B, S_local, H, D] of the global [B, S, H, D] (JAX's
    arguments sharded P(dp, sp)); returns this rank's rows of the output.
    ``split`` says how the rows were cut (by default S_local * sp rows in
    the raster order, cut evenly; the 2-D split of ``parallel/cp2d.py``
    takes its group from the split). H must divide over the ranks. kv_lens
    applies to the gathered sequence unchanged. With neither a mesh nor a
    split it is plain attention."""
    if split is not None:
        sp = split.size
    else:
        sp = mesh.shape[sp_axis] if mesh is not None else 1
    if sp == 1:
        return attention(q, k, v, kv_lens=kv_lens)
    if split is None:
        split = TokenSplit(q.shape[1] * sp, mesh, (sp_axis,),
                           device=q.device)
    o = attention(split.to_heads(q), split.to_heads(k), split.to_heads(v),
                  kv_lens=kv_lens)
    return split.from_heads(o)


def sequence_local_cross_attention(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, mesh: Mesh
                                   ) -> torch.Tensor:
    """Cross-attention from this rank's query rows to a small context every
    rank holds whole (text / CLIP tokens): no exchange, each rank attends
    locally (the Wan DiT's cross-attention under ``sp``). ``mesh`` is JAX's
    argument; the result does not depend on it."""
    return attention(q, k, v)
