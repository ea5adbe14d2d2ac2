"""Flash attention (dense, non-causal, variable kv length) — kernel 1.

Counterpart of ``worldforge_tpu/ops/flash_attention.py::flash_attention``;
the Pallas TPU kernel ``_fa_kernel`` (:34, ``pallas_call`` :124) becomes the
CUDA C++ kernel in ``csrc/flash_attention.cu`` (the design note and what
bounds it on the H100 are at the top of that file).

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` only for tensors on the CPU. Both follow the
kernel's contract, which differs from ``ops/attention.py::sdpa_reference``
in one place: a row with ``kv_len = 0`` gives zeros (the reference gives the
mean of V).

Gradients: the JAX package trains through ``ops/attention.py::attention``
(:40) by autodiff. Here a gradient on CUDA tensors goes through
``_FlashAttentionFn``: its forward is the kernel with ``return_lse``, and
its backward is the CUDA C++ kernel in ``csrc/flash_attention_bwd.cu``
(``flash_attention_backward``; bf16 with head dim 64 or 128, anything else
raises), laid out by the host-side ``_bwd_plan`` (tiles and query splits)
and ``_bwd_scratch`` (its fp32 scratch). On the CPU autograd differentiates
``flash_attention_plain`` itself. Either way masked keys get zero dK / dV
and a ``kv_len = 0`` row, whose output is zeros, gets zero dQ.
"""

from __future__ import annotations

import ctypes
import math
from fractions import Fraction
from typing import NamedTuple, Optional

import torch

from worldforge_tpu_torch.ops import _build

NEG_INF = -1e30  # finite "minus infinity": keeps exp() NaN-free on padding
_KERNEL_HEAD_DIMS = {torch.bfloat16: (64, 128),
                     torch.float32: (64, 80, 128, 384, 512)}
_BACKWARD_HEAD_DIMS = {torch.bfloat16: (64, 128)}


def flash_attention_plain(q, k, v, *, kv_lens=None, scale=None,
                          return_lse: bool = False, q_chunk: int = 0):
    """The kernel's function in plain PyTorch. q [B, Sq, H, D], k/v
    [B, Sk, H, D]; returns [B, Sq, H, D] (and m, l as [B, H, Sq] fp32).

    fp32 scores and softmax; the probabilities are cast to v's dtype before
    the P.V product (the Pallas kernel's ``p.astype(v.dtype)``). Queries run
    in chunks so the [B, H, chunk, Sk] score block stays near 256 MB."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().permute(0, 2, 3, 1)                    # [B, H, D, Sk]
    vt = v.permute(0, 2, 1, 3)                            # [B, H, Sk, D]
    mask = None
    if kv_lens is not None:
        kl = kv_lens.to(device=q.device, dtype=torch.int64)
        mask = torch.arange(sk, device=q.device)[None, :] < kl[:, None]
        mask = mask[:, None, None, :]                     # [B, 1, 1, Sk]
    if not q_chunk:
        q_chunk = max(1, (64 << 20) // max(1, b * h * sk))
    outs, ms, ls = [], [], []
    for s0 in range(0, sq, q_chunk):
        qc = q[:, s0:s0 + q_chunk].float().permute(0, 2, 1, 3)  # [B,H,c,D]
        s = (qc @ kf) * scale
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        if mask is not None:
            m = torch.where(mask.any(dim=-1, keepdim=True), m,
                            torch.full_like(m, NEG_INF))
        p = torch.exp(s - m)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).float() @ vt.float())
        o = o * torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
        outs.append(o.permute(0, 2, 1, 3).to(q.dtype))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    o = torch.cat(outs, dim=1)
    if return_lse:
        return o, torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)
    return o


def _launch(q, k, v, kv_lens, scale, return_lse):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _KERNEL_HEAD_DIMS or d not in _KERNEL_HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention kernel: no instantiation for "
                         f"dtype {q.dtype} and head dim {d}")
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention kernel: q, k and v must share a dtype")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: shapes {q.shape} "
                         f"{k.shape} {v.shape}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention kernel: tensors on two devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q, k and v must be 16-byte "
                         "aligned (the kernel copies 16-byte vectors)")
    if q.dtype == torch.bfloat16 and any(
            st * t.element_size() % 16 for t in (q, k, v)
            for st in t.stride()[:-1]):
        raise ValueError("flash_attention kernel: every stride of q, k and v "
                         "must be a multiple of 16 bytes (TMA)")
    if kv_lens is None:
        kv_lens = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    m = l = None
    if return_lse:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _lib()
    err = lib.wf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, b, sq, sk, h, d,
        float(scale), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.wf_flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    inst = f"{'bf16' if q.dtype == torch.bfloat16 else 'fp32'} d{d}"
    by = flash_attention.launches_by_instantiation
    by[inst] = by.get(inst, 0) + 1
    shape = flash_attention.launches_by_shape
    key = (inst, b * h, sq, sk)
    shape[key] = shape.get(key, 0) + 1
    return (o, m, l) if return_lse else o


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("flash_attention", {
        "wf_flash_attention": ([p, p, p, p, p, p, p, i, i, i, i, i,
                                ctypes.c_float, i, p], i),
        "wf_flash_attention_error_string": ([i], ctypes.c_char_p),
    })


def _bwd_lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("flash_attention_bwd", {
        "wf_flash_attention_bwd": ([p] * 16 + [i] * 7 + [ctypes.c_float, p],
                                   i),
        "wf_flash_attention_bwd_tiles": ([ctypes.POINTER(i)] * 2, None),
        "wf_flash_attention_bwd_error_string": ([i], ctypes.c_char_p),
    })


def _check_backward(q):
    d = q.shape[-1]
    if d not in _BACKWARD_HEAD_DIMS.get(q.dtype, ()):
        raise ValueError(f"flash_attention backward kernel: no instantiation "
                         f"for dtype {q.dtype} and head dim {d} (bf16 with "
                         f"head dim 64 or 128)")


class BwdPlan(NamedTuple):
    """How the backward kernel cuts one call: ``key_tile`` keys per block,
    ``q_tile`` queries per step of its walk, the walk cut into ``splits``
    runs of ``q_tiles_per_split`` query tiles (the last may be shorter).
    The tiles are the kernel's compile-time ``kKeys`` and ``kQ``
    (``csrc/flash_attention_bwd.cu``); the wrapper checks that they agree."""
    key_tile: int
    q_tile: int
    splits: int
    q_tiles_per_split: int


_BWD_KEY_TILE, _BWD_Q_TILE = 128, 64
_H100_SMS = 132
_BWD_WAVES = 4   # at or above this many key-tile blocks per SM: no split


def _bwd_plan(b, sq, sk, h, d, num_sms=_H100_SMS):
    """The backward kernel's tiles and query split for q [b, sq, h, d] and
    k [b, sk, h, d] (``d`` names the instantiation; the tiles do not depend
    on it). One block runs on an SM at a time (its shared memory), so s
    splits of ``blocks`` key-tile blocks take ceil(blocks s / num_sms)
    waves of 1 / s of the walk each, and each split adds fp32 dK / dV
    partials to write and sum. The plan takes the split count with the
    fewest waves per walk, the fewest splits on a tie, at most about
    ``_BWD_WAVES * num_sms`` blocks in all; from ``_BWD_WAVES * num_sms``
    blocks up (159 x 40 at the 14B self-attention) it does not split. On
    the H100 (``ops/tune_backward.py``, splits 1-12 at the cross-attentions
    that train) that is the fastest split at Wan-14B's text cross-attention
    (4 x 40 blocks: split 4, 1.619 ms; unsplit 2.134), its CLIP
    cross-attention (3 x 40 blocks fit one wave: unsplit, 1.331 ms; every
    split ties on waves and 2-12 splits take 1.361-1.456) and LongCat's text
    cross-attention (4 x 32: unsplit), and within 0.3% of the fastest at
    Wan-1.3B's (4 x 12 blocks: split 11, 0.807 ms; split 8 0.805, unsplit
    1.535; 0.7% in a second run)."""
    del d
    key_tiles = -(-sk // _BWD_KEY_TILE)
    q_tiles = -(-sq // _BWD_Q_TILE)
    blocks = key_tiles * b * h
    splits = 1
    if 0 < blocks < _BWD_WAVES * num_sms and q_tiles > 1:
        cap = min(q_tiles, -(-_BWD_WAVES * num_sms // blocks))
        splits = min(range(1, cap + 1), key=lambda n: (
            Fraction(-(-blocks * n // num_sms), n), n))
    per = -(-q_tiles // splits) if q_tiles else 1
    splits = -(-q_tiles // per) if q_tiles else 1
    return BwdPlan(_BWD_KEY_TILE, _BWD_Q_TILE, splits, per)


def _bwd_scratch(plan, b, sq, sk, h, d):
    """The fp32 scratch the backward wrapper allocates, name -> shape: D and
    lse2 per query row padded to the query tile, the dQ accumulator, and
    with a split the per-split dK / dV partials."""
    sqp = -(-sq // plan.q_tile) * plan.q_tile
    shapes = {"delta": (b, h, sqp), "lse2": (b, h, sqp),
              "dq_acc": (b, sq, h, d)}
    if plan.splits > 1:
        shapes["dk_part"] = shapes["dv_part"] = (plan.splits, b, sk, h, d)
    return shapes


def flash_attention_backward(q, k, v, o, do, m, l, kv_lens, scale):
    """dq, dk, dv of ``flash_attention`` from what its forward saved (q, k,
    v, the output o and its m / l [B, H, Sq] fp32) and the output's
    gradient ``do``: the CUDA kernel, bf16 with head dim 64 or 128, cut as
    ``_bwd_plan`` says. dq is summed in fp32 from every key tile in an
    order that changes from run to run (its last bits may too); dk and dv
    are deterministic. Each call adds one to
    ``flash_attention_backward.launches``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_backward(q)
    for t in (k, v, o, do):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention backward kernel: q, k, v, o "
                             "and do must share a dtype and a device")
    if o.shape != q.shape or do.shape != q.shape or v.shape != k.shape or \
            k.shape != (b, sk, h, d) or m.shape != (b, h, sq) or \
            l.shape != m.shape:
        raise ValueError("flash_attention backward kernel: shapes")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention backward kernel: q, k, v, o and do "
                         "must be 16-byte aligned (TMA and 16-byte copies)")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention backward kernel: device "
                         f"{q.device}")
    m, l = m.float().contiguous(), l.float().contiguous()
    if kv_lens is None:
        kv_lens = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    plan = _bwd_plan(b, sq, sk, h, d, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    return _launch_backward(q, k, v, o, do, m, l, kv_lens, scale, plan)


def _launch_backward(q, k, v, o, do, m, l, kv_lens, scale, plan):
    """The backward kernel on checked, contiguous CUDA tensors cut as
    ``plan`` says (``flash_attention_backward`` passes ``_bwd_plan``'s;
    ``ops/tune_backward.py`` times others)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lib = _bwd_lib()
    tiles = (ctypes.c_int(), ctypes.c_int())
    lib.wf_flash_attention_bwd_tiles(*(ctypes.byref(t) for t in tiles))
    if (plan.key_tile, plan.q_tile) != tuple(t.value for t in tiles):
        raise RuntimeError(
            f"flash_attention backward kernel: plan tiles "
            f"{(plan.key_tile, plan.q_tile)}, kernel tiles "
            f"{tuple(t.value for t in tiles)}")
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
               for name, shape in _bwd_scratch(plan, b, sq, sk, h, d).items()}
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = lambda name: (scratch[name].data_ptr() if name in scratch
                         else None)
    err = lib.wf_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), kv_lens.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), scratch["delta"].data_ptr(),
        scratch["lse2"].data_ptr(), scratch["dq_acc"].data_ptr(),
        part("dk_part"), part("dv_part"), b, sq, sk, h, d, plan.splits,
        plan.q_tiles_per_split, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            "flash_attention backward kernel launch failed: "
            + lib.wf_flash_attention_bwd_error_string(err).decode())
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class _FlashAttentionFn(torch.autograd.Function):
    """Kernel 1 with a gradient: the forward kernel saves o, m and l, the
    backward kernel takes them (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale):
        o, m, l = _launch(q, k, v, kv_lens, scale, True)
        ctx.save_for_backward(q, k, v, o, m, l, kv_lens)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do.to(o.dtype), m,
                                              l, kv_lens, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, kv_lens: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Attention over [B, S, H, D] tensors; returns [B, Sq, H, D].

    kv_lens: optional [B] int true key lengths (keys past it are masked).
    return_lse: also return the running max ``m`` and softmax normaliser
    ``l`` per query row as [B, H, Sq] fp32 (the output stays normalised).
    CUDA tensors launch the kernel (bf16 with head dim 64 or 128, fp32 with
    64, 80, 128, 384 or 512) and raise on anything else; CPU tensors take
    ``flash_attention_plain``. Each launch adds one to ``launches``, to
    ``launches_by_instantiation["fp32 d512"]`` (its dtype and head dim) and
    to ``launches_by_shape[("fp32 d512", B * H, Sq, Sk)]``.

    Where q, k or v requires a gradient (and autograd records), CUDA
    tensors go through ``_FlashAttentionFn`` (the backward kernel: bf16 with
    head dim 64 or 128, anything else raises here, before the forward) and
    CPU tensors through autograd of ``flash_attention_plain``; m and l then
    carry no gradient, so ``return_lse`` with a gradient raises on CUDA."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens=kv_lens, scale=scale,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if return_lse:
            raise ValueError("flash_attention: return_lse has no gradient")
        _check_backward(q)
        if kv_lens is None:
            kv_lens = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                                 device=q.device)
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32)
        return _FlashAttentionFn.apply(q, k, v, kv_lens, scale)
    return _launch(q, k, v, kv_lens, scale, return_lse)


flash_attention.launches = 0
flash_attention.launches_by_instantiation = {}
flash_attention.launches_by_shape = {}
