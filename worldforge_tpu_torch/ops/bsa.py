"""Block-sparse attention (BSA) for the LongCat 720p refine — kernel 5.

Counterpart of ``worldforge_tpu/ops/bsa.py``. Tokens are regrouped into
(4, 4, 8) t/h/w chunks of 128; q and k are mean-pooled per chunk, each query
chunk selects key chunks by top-k of the pooled scores, by a CDF threshold
over their softmax, or by the larger of both, and attends only to the
selected chunks.

Selection (``mean_pool_chunks``, ``select_blocks``,
``select_blocks_from_pooled``) is plain PyTorch, as the JAX package runs it
as plain JAX: the scores are tiny ([BH, Nq, Nk]). The sparse attention
``bsa_bhsd`` replaces the Pallas TPU kernel ``_bsa_kernel`` (:100,
``pallas_call`` :209, through ``_bsa_bhsd`` :174, ``_bsa_bhsd_grouped``
:295 and ``_bsa_dispatch`` :321) with the CUDA C++ kernel in
``csrc/bsa.cu`` on the wgmma / TMA main loop of ``csrc/attention_sm90.cuh``
(the design note and what bounds it on the H100 are at the
top of that file). CUDA tensors launch the kernel; CPU tensors take
``bsa_plain``, which follows the kernel's contract: fp32 scores, the
probabilities cast to v's dtype before the P.V product, and zeros for a
query chunk with a count of 0.

The backward pass (the JAX package differentiates the gathered form) comes
with the training slice of the port.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from worldforge_tpu_torch.ops import _build

NEG_INF = -1e30
CHUNK_Q = 128
CHUNK_K = 128
_KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------- selection


def mean_pool_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[BH, S, D] -> [BH, S // chunk, D] chunk means."""
    bh, s, d = x.shape
    return x.reshape(bh, s // chunk, chunk, d).mean(dim=2)


def select_blocks(q: torch.Tensor, k: torch.Tensor, *,
                  sparsity: Optional[float] = 0.875,
                  cdf_threshold: Optional[float] = None,
                  head_dim: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [BH, S, D] (chunk-rearranged, 128-token chunks). Returns
    (indices [BH, Nq, Kmax] int32, counts [BH, Nq] int32)."""
    d = head_dim or q.shape[-1]
    qc = mean_pool_chunks(q.float(), CHUNK_Q)
    kc = mean_pool_chunks(k.float(), CHUNK_K)
    return select_blocks_from_pooled(qc, kc, sparsity=sparsity,
                                     cdf_threshold=cdf_threshold, head_dim=d)


def select_blocks_from_pooled(qc: torch.Tensor, kc: torch.Tensor, *,
                              sparsity: Optional[float] = 0.875,
                              cdf_threshold: Optional[float] = None,
                              head_dim: int = 128
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selection on chunk-pooled q/k [BH, N, D].

    Top-k takes the first ``ksel`` of a stable descending sort, so equal
    scores keep the lower index first, as ``jax.lax.top_k`` does; the CDF
    path orders by a stable argsort of the negated weights, as
    ``jnp.argsort`` does. Counts are the number of CDF entries at or below
    the threshold (``torch.searchsorted(..., right=True)``)."""
    score = torch.einsum("bqd,bkd->bqk", qc, kc)
    nk = score.shape[-1]
    if sparsity is not None and cdf_threshold is None:
        ksel = max(int((1 - sparsity) * nk), 1)
        idx = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[..., :ksel]
        counts = torch.full(idx.shape[:2], ksel, dtype=torch.int32,
                            device=score.device)
        return idx.to(torch.int32), counts
    weights = torch.softmax(score * (1.0 / math.sqrt(head_dim)), dim=-1)
    order = torch.argsort(-weights, dim=-1, stable=True)
    cdf = torch.cumsum(torch.gather(weights, -1, order), dim=-1)
    counts = (cdf <= cdf_threshold).sum(dim=-1).to(torch.int32)
    if sparsity is not None:
        counts = torch.clamp(counts, min=int((1 - sparsity) * nk))
    return order.to(torch.int32), counts


# ---------------------------------------------------------------- attention


def bsa_plain(q, k, v, indices, counts, *, scale: Optional[float] = None,
              return_lse: bool = False):
    """The kernel's function in plain PyTorch (the gathered form of the JAX
    package's ``_bsa_gathered``). q [BH, Sq, D], k/v [BH, Sk, D]
    chunk-rearranged; indices [BH, Nq, Kmax] and counts [BH, Nq] int.
    Returns [BH, Sq, D] in q's dtype (and m, l as [BH, Sq] fp32).

    fp32 scores and softmax, the probabilities cast to v's dtype before the
    P.V product, zeros (m = -1e30, l = 0) for a count of 0. It runs one
    head at a time: its memory scales with Kmax * 128 keys per query chunk,
    about 1.6 GB in fp32 for one head at the refine shape."""
    bh, sq, d = q.shape
    nq, nk = sq // CHUNK_Q, k.shape[1] // CHUNK_K
    kmax = indices.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    slots = torch.arange(kmax, device=q.device)
    outs, ms, ls = [], [], []
    nb = 1
    for b0 in range(bh):
        sl = slice(b0, b0 + 1)
        idx = indices[sl].long()                          # [nb, nq, kmax]
        qc = q[sl].reshape(nb, nq, CHUNK_Q, d).float()
        kc = k[sl].reshape(nb, nk, CHUNK_K, d)
        vc = v[sl].reshape(nb, nk, CHUNK_K, d)
        rows = torch.arange(nb, device=q.device)[:, None, None]
        kg = kc[rows, idx].float()                        # [nb,nq,kmax,C,d]
        vg = vc[rows, idx].float()
        s = torch.einsum("bnqd,bnmkd->bnqmk", qc, kg) * scale
        live = (slots[None, None, :] < counts[sl, :, None].to(q.device))
        live = live[:, :, None, :, None]                  # [nb,nq,1,kmax,1]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        s = s.reshape(nb, nq, CHUNK_Q, kmax * CHUNK_K)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).reshape(nb, nq, CHUNK_Q, kmax, CHUNK_K)
        p = torch.where(live, p, torch.zeros_like(p))
        l = p.sum(dim=(-2, -1))[..., None]                # [nb,nq,C,1]
        o = torch.einsum("bnqmk,bnmkd->bnqd", p.to(v.dtype).float(), vg)
        o = o * torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
        outs.append(o.reshape(nb, sq, d).to(q.dtype))
        ms.append(m.reshape(nb, sq))
        ls.append(l.reshape(nb, sq))
    o = torch.cat(outs, dim=0)
    if return_lse:
        return o, torch.cat(ms, dim=0), torch.cat(ls, dim=0)
    return o


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("bsa", {
        "wf_bsa": ([p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p],
                   i),
        "wf_bsa_error_string": ([i], ctypes.c_char_p),
    })


def _launch(q, k, v, indices, counts, scale, return_lse):
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype != torch.bfloat16 or d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"bsa kernel: no instantiation for dtype {q.dtype} "
                         f"and head dim {d} (bf16 with d 64 or 128)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("bsa kernel: q, k and v must share a dtype")
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"bsa kernel: shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if sq % CHUNK_Q or sk % CHUNK_K:
        raise ValueError(f"bsa kernel: sequence lengths {sq}, {sk} are not "
                         f"multiples of {CHUNK_Q}")
    nq = sq // CHUNK_Q
    if indices.dim() != 3 or indices.shape[:2] != (bh, nq) or \
            counts.shape != (bh, nq):
        raise ValueError(f"bsa kernel: indices {tuple(indices.shape)} and "
                         f"counts {tuple(counts.shape)} for {bh} heads of "
                         f"{nq} query chunks")
    for t in (k, v, indices, counts):
        if t.device != q.device:
            raise ValueError("bsa kernel: tensors on two devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bsa kernel: q, k and v must be 16-byte aligned "
                         "(the kernel copies 16-byte vectors)")
    if any(st * t.element_size() % 16 for t in (q, k, v)
           for st in t.stride()[:-1]):
        raise ValueError("bsa kernel: every stride of q, k and v must be a "
                         "multiple of 16 bytes (TMA)")
    idx = indices.to(torch.int32).contiguous()
    cnt = counts.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    m = l = None
    if return_lse:
        m = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _lib()
    err = lib.wf_bsa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
        cnt.data_ptr(), o.data_ptr(), m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, bh, sq, sk, d,
        idx.shape[-1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("bsa kernel launch failed: "
                           + lib.wf_bsa_error_string(err).decode())
    bsa_bhsd.launches += 1
    return (o, m, l) if return_lse else o


def bsa_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             indices: torch.Tensor, counts: torch.Tensor, *,
             scale: Optional[float] = None, return_lse: bool = False):
    """Block-sparse attention over chunk-rearranged [BH, S, D] tensors with
    a fixed selection (indices [BH, Nq, Kmax], counts [BH, Nq]); returns
    [BH, Sq, D] (and the running max ``m`` and normaliser ``l`` per query
    row as [BH, Sq] fp32 for ``return_lse``, which the context-parallel
    merge needs). CUDA tensors launch the kernel (bf16, head dim 64 or 128)
    and raise on anything else; CPU tensors take ``bsa_plain``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return bsa_plain(q, k, v, indices, counts, scale=scale,
                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"bsa_bhsd: unsupported device {q.device}")
    return _launch(q, k, v, indices, counts, scale, return_lse)


bsa_bhsd.launches = 0


# ---------------------------------------------------------------- top level


def rearrange_thw_to_blocks(x: torch.Tensor, grid3d, chunk3d) -> torch.Tensor:
    """[B, S, H, D] tokens in (T, H, W) raster order -> chunk-contiguous
    order."""
    b, s, h, d = x.shape
    T, Hh, Ww = grid3d
    t, hh, ww = chunk3d
    x = x.reshape(b, T // t, t, Hh // hh, hh, Ww // ww, ww, h, d)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7, 8)
    return x.reshape(b, s, h, d)


def rearrange_blocks_to_thw(x: torch.Tensor, grid3d, chunk3d) -> torch.Tensor:
    b, s, h, d = x.shape
    T, Hh, Ww = grid3d
    t, hh, ww = chunk3d
    x = x.reshape(b, T // t, Hh // hh, Ww // ww, t, hh, ww, h, d)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7, 8)
    return x.reshape(b, s, h, d)


def bsa_attention_3d(q, k, v, latent_shape_q, latent_shape_k, *,
                     sparsity: Optional[float] = 0.875,
                     cdf_threshold: Optional[float] = None,
                     chunk_3d_shape_q=(4, 4, 8), chunk_3d_shape_k=(4, 4, 8)
                     ) -> torch.Tensor:
    """Block-sparse 3D attention over [B, S, H, D]; latent shapes are the
    (T', H', W') token grids. Selection, then ``bsa_bhsd``."""
    b, sq, h, d = q.shape
    qb = rearrange_thw_to_blocks(q, latent_shape_q, chunk_3d_shape_q)
    kb = rearrange_thw_to_blocks(k, latent_shape_k, chunk_3d_shape_k)
    vb = rearrange_thw_to_blocks(v, latent_shape_k, chunk_3d_shape_k)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    qf, kf, vf = flat(qb), flat(kb), flat(vb)
    indices, counts = select_blocks(qf, kf, sparsity=sparsity,
                                    cdf_threshold=cdf_threshold, head_dim=d)
    of = bsa_bhsd(qf, kf, vf, indices, counts, scale=1.0 / math.sqrt(d))
    ob = of.reshape(b, h, sq, d).permute(0, 2, 1, 3)
    return rearrange_blocks_to_thw(ob, latent_shape_q, chunk_3d_shape_q)
