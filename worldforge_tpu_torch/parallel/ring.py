"""Ring attention over the ``sp`` ranks (counterpart of
``worldforge_tpu/parallel/ring.py``).

Queries stay on their rank; the key / value shards travel around the ring
(``batch_isend_irecv``: rank i sends to i + 1 and receives from i - 1), and
each step's partial attention (kernel 1 with ``return_lse``) merges into
the running result by the running-max / log-sum-exp rescale:

  m = max(m_a, m_b); w_a = e^(m_a - m) l_a; w_b = e^(m_b - m) l_b
  out = (w_a out_a + w_b out_b) / (w_a + w_b);  l = w_a + w_b

Forward only, as upstream: kernel 1's ``m`` and ``l`` carry no gradient.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from worldforge_tpu_torch.core.mesh import AXIS_SP, Mesh
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.flash_attention import flash_attention


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only: the partial results' "
                           "running max and normaliser carry no gradient "
                           "(train through ulysses_attention)")


def ring_pass(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """One step around the ring: send each tensor to the next rank of
    ``group`` and return the ones received from the previous rank (after
    ``step`` passes, ``ring_owner(rank, step, size)``'s)."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_owner(rank: int, step: int, size: int) -> int:
    """The rank whose shard visits ``rank`` after ``step`` ring passes."""
    return (rank - step) % size


def _partial_attention(q, k, v, scale):
    """Kernel 1 over one key shard: (out [B, S, H, D] fp32, normalised;
    m, l [B, H, S] fp32)."""
    out, m, l = flash_attention(q, k, v, scale=scale, return_lse=True)
    return out.float(), m, l


def _merge(out_a, m_a, l_a, out_b, m_b, l_b):
    """The log-sum-exp merge of two partial results; out [B, S, H, D],
    m / l [B, H, S]. A row with l = 0 on both sides (no key) stays 0."""
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m) * l_a
    wb = torch.exp(m_b - m) * l_b
    l = wa + wb
    ca = (wa / l.clamp_min(1e-20)).transpose(1, 2)[..., None]
    cb = (wb / l.clamp_min(1e-20)).transpose(1, 2)[..., None]
    return out_a * ca + out_b * cb, m, l


def ring_step(q, k, v, state, scale):
    """A rank's work at one ring step, between its exchanges: kernel 1 of
    its queries q over the visiting key shard k, v, merged into ``state``
    ((out, m, l) of the steps before; None at the first step). Returns the
    new state."""
    part = _partial_attention(q, k, v, scale)
    return part if state is None else _merge(*state, *part)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, scale: Optional[float] = None,
                   sp_axis: str = AXIS_SP) -> torch.Tensor:
    """Self-attention over a sequence cut evenly on ``sp_axis``: q, k, v are
    this rank's [B, S / sp, H, D] rows; returns this rank's rows of the
    output in q's dtype. No head-count condition; memory O(S / sp)."""
    forward_only("ring_attention", q, k, v)
    sp = mesh.shape[sp_axis]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if sp == 1:
        return attention(q, k, v, scale=scale)
    group = mesh.group(sp_axis)
    state = None
    kr, vr = k, v
    for step in range(sp):
        state = ring_step(q, kr, vr, state, scale)
        if step < sp - 1:
            kr, vr = ring_pass([kr, vr], group)
    return state[0].to(q.dtype)
