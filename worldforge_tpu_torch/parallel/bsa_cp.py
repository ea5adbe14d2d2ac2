"""Context-parallel block-sparse attention (counterpart of
``worldforge_tpu/parallel/bsa_cp.py``).

The sequence is taken in BSA's chunk-contiguous order (``block_order``)
and cut over the ``sp`` ranks, each holding whole 128-token chunks of q, k
and v. Selection stays global and exact: each rank mean-pools its key
chunks, the pooled keys are all-gathered (128 times smaller than the keys)
and every rank scores its query chunks against all key chunks, the
single-card selection. The key / value shards then travel around the ring
(``ring.ring_pass``); at each step the rank keeps, for every query chunk,
the selected chunks the visiting shard owns (compacted to the front of the
row in their selection order, rebased to the shard) and runs kernel 5
(``ops/bsa.py::bsa_bhsd`` with ``return_lse``), merging as the ring does.
A query chunk may select none of a shard's chunks: its count is 0, kernel
5 gives zeros with m = -1e30 and l = 0, and the merge keeps the row as it
was. Forward only, as upstream.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from worldforge_tpu_torch.core.mesh import AXIS_SP, Mesh, all_gather_stack
from worldforge_tpu_torch.ops.bsa import (CHUNK_K, CHUNK_Q, bsa_bhsd,
                                          mean_pool_chunks,
                                          rearrange_thw_to_blocks,
                                          select_blocks_from_pooled)
from worldforge_tpu_torch.parallel.ring import (forward_only, ring_owner,
                                                ring_pass)


def block_order(grid3d, chunk3d, device=None) -> torch.Tensor:
    """The raster index of each token in BSA's chunk-contiguous order: the
    ``order`` of a ``TokenSplit`` that gives each rank whole chunks."""
    n = grid3d[0] * grid3d[1] * grid3d[2]
    idx = torch.arange(n, device=device).reshape(1, n, 1, 1)
    return rearrange_thw_to_blocks(idx, grid3d, chunk3d).reshape(n)


def _merge_flat(o_a, m_a, l_a, o_b, m_b, l_b):
    """The log-sum-exp merge on [BH, S, D] outputs with [BH, S] stats."""
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m) * l_a
    wb = torch.exp(m_b - m) * l_b
    l = (wa + wb).clamp_min(1e-20)
    return (o_a.float() * (wa / l)[..., None]
            + o_b.float() * (wb / l)[..., None], m, wa + wb)


def member_indices(indices, counts, base: int, n_local: int):
    """The selected chunks of each query chunk that lie in
    [base, base + n_local), compacted to the front of the row (stable, so
    in their selection order) and rebased to the shard, zeros after; and
    their counts. indices [BH, Nq, Kmax], counts [BH, Nq]."""
    kmax = indices.shape[-1]
    valid = (torch.arange(kmax, device=indices.device)[None, None]
             < counts[..., None])
    member = valid & (indices >= base) & (indices < base + n_local)
    order = torch.argsort((~member).to(torch.int8), dim=-1, stable=True)
    idx = torch.gather(indices - base, -1, order)
    mem = torch.gather(member, -1, order)
    idx = torch.where(mem, idx, torch.zeros_like(idx)).to(torch.int32)
    return idx, member.sum(dim=-1).to(torch.int32)


def rank_selection(qf, pooled_keys, *, sparsity, cdf_threshold=None):
    """A rank's selection: its query chunks (qf [BH, S_local, D], whole
    chunks) mean-pooled and scored against every rank's pooled key chunks
    (``pool_keys`` of each shard, in rank order along dim 1) -- the
    single-card selection of these query chunks. Returns (indices, counts)
    over the global key chunks."""
    qc = mean_pool_chunks(qf.float(), CHUNK_Q)
    return select_blocks_from_pooled(qc, pooled_keys, sparsity=sparsity,
                                     cdf_threshold=cdf_threshold,
                                     head_dim=qf.shape[-1])


def pool_keys(kf):
    """A shard's mean-pooled key chunks [BH, Nk_local, D] fp32."""
    return mean_pool_chunks(kf.float(), CHUNK_K)


def bsa_ring_step(qf, kf, vf, indices, counts, owner: int, state, scale):
    """A rank's work at one ring step, between its exchanges: of its
    selection (``rank_selection``), the chunks that ``owner``'s visiting
    shard kf, vf [BH, S_local, D] holds, compacted and rebased
    (``member_indices``); kernel 5 with ``return_lse`` over them, merged
    into ``state`` ((out, m, l) of the steps before; None at the first
    step). Returns (state, the step's counts [BH, Nq])."""
    nk = kf.shape[1] // CHUNK_K
    idx, cnt = member_indices(indices, counts, owner * nk, nk)
    o, m, l = bsa_bhsd(qf, kf, vf, idx, cnt, scale=scale, return_lse=True)
    if state is None:
        return (o.float(), m, l), cnt
    return _merge_flat(*state, o, m, l), cnt


def bsa_attention_3d_cp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mesh: Mesh, sparsity: Optional[float] = 0.875,
                        cdf_threshold: Optional[float] = None,
                        sp_axis: str = AXIS_SP, stats: Optional[dict] = None
                        ) -> torch.Tensor:
    """Block-sparse attention over a sequence cut on ``sp_axis`` in BSA's
    chunk-contiguous order: q, k, v are this rank's rows [B, S_local, H, D]
    (whole 128-token chunks; the same chunks of the sequence
    ``bsa_attention_3d`` rearranges), and the result is this rank's rows of
    its output, in the same order. The selection equals the single-card
    one; the output differs only by the merge's rounding. ``stats``, when
    given, receives the number of (query chunk, head, ring step) rows with
    a count of 0."""
    forward_only("bsa_attention_3d_cp", q, k, v)
    sp = mesh.shape[sp_axis]
    group = mesh.group(sp_axis)
    me = mesh.coord(sp_axis)
    b, sl, h, d = q.shape
    if sl % CHUNK_Q or k.shape[1] % CHUNK_K:
        raise ValueError(f"bsa_attention_3d_cp: {sl} / {k.shape[1]} local "
                         f"tokens are not whole chunks of {CHUNK_Q}")
    scale = 1.0 / math.sqrt(d)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    qf, kf, vf = flat(q), flat(k), flat(v)
    kc = all_gather_stack(pool_keys(kf), group)
    indices, counts = rank_selection(
        qf, torch.cat(kc.unbind(0), dim=1), sparsity=sparsity,
        cdf_threshold=cdf_threshold)

    state = None
    empty = 0
    kr, vr = kf, vf
    for step in range(sp):
        state, cnt = bsa_ring_step(qf, kr, vr, indices, counts,
                                   ring_owner(me, step, sp), state, scale)
        if stats is not None:
            empty += int((cnt == 0).sum())
        if step < sp - 1:
            kr, vr = ring_pass([kr, vr], group)
    if stats is not None:
        stats["empty_rows"] = stats.get("empty_rows", 0) + empty
    return state[0].to(q.dtype).reshape(b, h, sl, d).permute(0, 2, 1, 3)
