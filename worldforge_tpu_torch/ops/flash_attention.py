"""Flash attention (dense, non-causal, variable kv length) — kernel 1.

Counterpart of ``worldforge_tpu/ops/flash_attention.py::flash_attention``;
the Pallas TPU kernel ``_fa_kernel`` (:34, ``pallas_call`` :124) becomes the
CUDA C++ kernels in ``csrc/flash_attention.cu`` (the design note and what
bounds them on the H100 are at the top of that file): bf16 on the shared
``wgmma`` / TMA loop of ``csrc/attention_sm90.cuh``, or at head dim 128 and
short key runs on the persistent kernel of ``csrc/attention_short_sm90.cuh``
(the host-side ``_bf16_plan`` picks the route, the walk and the grid, which
the kernel refuses where it does not compile them; the key tiles and the
shared memory follow from the route and the key count,
``csrc/attention_bf16_plan.cuh``); fp32 with head dim 64,
80 or 128 on ``csrc/attention_f32_sm90.cuh`` (every product three TF32
``wgmma`` products fed by a TMA ring, each tile split into TF32 hi / lo
planes once in shared memory); fp32 with head dim 384 or 512 on the two
passes of ``csrc/attention_f32_wide_sm90.cuh`` (S = Q.K^T, then O =
exp(S - m).V / l, each a GEMM of three TF32 ``wgmma`` products fed by TMA,
the scores of one chunk of query tiles in a device scratch of at most 256
MiB between them). The host-side ``_fwd_plan`` picks the variant and, at
d 384 / 512, the chunk; the rest of the layout (rows, key tile, ring
stages, threads, shared memory, the scratch's bytes) follows from the head
dim, the variant, the key count and the chunk in one plain C++ header,
``csrc/attention_f32_plan.cuh``, which the kernels include and which the
host reads through ``csrc/flash_plan.cpp``. The entry point takes the
variant, the chunk and the scratch, and refuses a variant it does not
compile, a short scratch or a chunk where there is none.

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
import functools
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


class FwdPlan(NamedTuple):
    """How the fp32 forward kernel cuts one call: ``variant`` 0 (long rows)
    or 1 (short rows, head dim 64 only), ``rows`` query rows a block,
    ``key_tile`` keys a ring stage, ``stages`` ring stages, ``threads`` a
    block, ``smem_bytes`` of dynamic shared memory, ``blocks`` in the
    largest grid (on ``gridDim.x`` alone).

    At head dims 64, 80 and 128 one kernel runs one grid and the call
    allocates no device scratch (the TF32 hi / lo planes of Q, K and V^T
    live in shared memory): the ``score_*`` fields and ``chunk_tiles`` are
    0, ``chunks`` 1 and ``passes`` 1. At 384 and 512 two kernels run per
    chunk of ``chunk_tiles`` 128-row query tiles (flat over b * h and the
    tiles; ``chunks`` of them, the last possibly shorter), ``passes`` = 2 *
    ``chunks`` launches a call: pass 1 takes ``score_tile`` keys a block
    through ``score_stages`` depth stages in ``score_smem_bytes``, pass 2
    the ``rows``, ``key_tile``, ``stages`` and ``smem_bytes`` above; the
    call allocates ``scratch_bytes`` of fp32 scratch (a chunk's scores and
    the per-key-tile max and sum of exp). The fields are
    ``csrc/attention_f32_plan.cuh``'s."""
    variant: int
    rows: int
    key_tile: int
    stages: int
    threads: int
    smem_bytes: int
    blocks: int
    score_tile: int = 0
    score_stages: int = 0
    score_smem_bytes: int = 0
    chunk_tiles: int = 0
    chunks: int = 1
    scratch_bytes: int = 0
    passes: int = 1


_H100_SMS = 132
_SHORT_KEYS = 64           # at or below this many keys: the short variant
_TWO_PASS_HEAD_DIMS = (384, 512)
_SCRATCH_CAP = 256 << 20   # bytes of scratch a call at most


def _fwd_variant(b, sq, sk, h, d, num_sms=_H100_SMS):
    """The wgmma route's variant for q [b, sq, h, d] and ``sk`` keys: at
    head dim 64, 1 (short: one consumer warpgroup of 64 rows, 32-key tiles,
    Q in shared memory; two blocks share an SM) where a row's keys fit one
    long-variant tile, so a block's loads, split and epilogue are most of
    its time, or where the long variant's 128-row blocks would not fill one
    wave of SMs; else 0. ``chip_smoke.py``'s kernels phase times both
    variants at the SVD UNet's cross-attention to 1 key, its temporal
    attention (110 keys) and 16-key rows at B*H 70,000 (``variant_ms``)."""
    if d != 64:
        return 0
    return int(sk <= _SHORT_KEYS or -(-sq // 128) * b * h < num_sms)


class _F32Layout(NamedTuple):
    """``csrc/attention_f32_plan.cuh``'s plan of one head dim, variant, key
    count and chunk (``wf_flash_f32_plan``)."""
    rows: int
    key_tile: int
    stages: int
    threads: int
    smem_bytes: int
    score_tile: int
    score_stages: int
    score_smem_bytes: int
    cols: int
    score_key_tiles: int
    scratch_bytes: int


@functools.lru_cache(maxsize=4096)
def _f32_layout(d, variant, sk, chunk_tiles):
    """The fp32 layout ``csrc/flash_attention.cu`` compiles for head dim
    ``d`` and ``variant``, at ``sk`` keys and, at d 384 / 512, chunks of
    ``chunk_tiles`` query tiles (0 for the one-pass kernels)."""
    out = (ctypes.c_longlong * len(_F32Layout._fields))()
    if not _plan_lib().wf_flash_f32_plan(d, variant, sk, chunk_tiles, out):
        raise ValueError(f"flash_attention fp32 kernel: no variant {variant} "
                         f"at head dim {d}")
    return _F32Layout(*out)


def _wide_chunk_tiles(n_tiles, one, d, num_sms):
    """The query tiles a chunk of the two-pass route takes (``one``: the
    layout of a one-tile chunk): at most as many as keep the scratch within
    ``_SCRATCH_CAP``, and among those the count whose chunks take the
    fewest waves of blocks on ``num_sms`` SMs (one block an SM), each
    pass's waves weighted by its block's work (pass 1: ``score_tile`` x
    ``rows`` scores over ``d``; pass 2: ``rows`` x ``cols`` outputs over
    the padded keys); the largest count on a tie."""
    nkt = one.score_key_tiles
    cap = max(1, _SCRATCH_CAP // one.scratch_bytes)
    ncol = d // one.cols

    def chunk(t):
        return (-(-t * nkt // num_sms) * d
                + -(-t * ncol // num_sms) * nkt * one.score_tile)

    def cost(tiles):
        full, rest = divmod(n_tiles, tiles)
        return full * chunk(tiles) + (chunk(rest) if rest else 0)

    return min(range(1, min(cap, n_tiles) + 1), key=lambda t: (cost(t), -t))


@functools.lru_cache(maxsize=4096)
def _fwd_plan(b, sq, sk, h, d, variant=None, num_sms=_H100_SMS,
              chunk_tiles=None):
    """The fp32 forward kernel's plan for q [b, sq, h, d] and k [b, sk, h,
    d], as ``csrc/flash_attention.cu`` compiles it for head dim ``d`` and
    ``variant`` (default: ``_fwd_variant``'s), on a card of ``num_sms``
    SMs. The layout is ``csrc/attention_f32_plan.cuh``'s, read through
    ``csrc/flash_plan.cpp``; the wrapper passes the variant and, at d 384 /
    512, the chunk and its scratch to the kernel, which refuses a variant
    it does not compile.

    d 64 / 80 / 128, the one-pass wgmma route: one grid of ``rows``-row
    blocks per (batch, head) row.

    d 384 / 512, the two-pass route: 128 query rows a block in both passes;
    pass 1 one block per (query tile, 128-key tile) of the chunk, pass 2 one
    per (query tile, 128 columns). The chunk is ``_wide_chunk_tiles``'s (or
    ``chunk_tiles``: a check may force several chunks), its scratch at most
    256 MiB; ``blocks`` is the larger of a full chunk's two grids."""
    if d not in _KERNEL_HEAD_DIMS[torch.float32]:
        raise ValueError(f"flash_attention fp32 kernel: no instantiation for "
                         f"head dim {d}")
    if d in _TWO_PASS_HEAD_DIMS:
        variant = 0 if variant is None else variant
        one = _f32_layout(d, variant, sk, 1)
        n_tiles = -(-sq // one.rows) * b * h
        if chunk_tiles is None:
            chunk_tiles = _wide_chunk_tiles(n_tiles, one, d, num_sms)
        if chunk_tiles < 1:
            raise ValueError("flash_attention fp32 kernel: a chunk holds at "
                             "least one query tile")
        chunk_tiles = min(chunk_tiles, n_tiles)
        chunks = -(-n_tiles // chunk_tiles)
        lay = _f32_layout(d, variant, sk, chunk_tiles)
        return FwdPlan(
            variant, lay.rows, lay.key_tile, lay.stages, lay.threads,
            lay.smem_bytes,
            chunk_tiles * max(lay.score_key_tiles, d // lay.cols),
            lay.score_tile, lay.score_stages, lay.score_smem_bytes,
            chunk_tiles, chunks, lay.scratch_bytes, 2 * chunks)
    if chunk_tiles is not None:
        raise ValueError(f"flash_attention fp32 kernel: no chunks at head "
                         f"dim {d}")
    if variant is None:
        variant = _fwd_variant(b, sq, sk, h, d)
    lay = _f32_layout(d, variant, sk, 0)
    return FwdPlan(variant, lay.rows, lay.key_tile, lay.stages, lay.threads,
                   lay.smem_bytes, -(-sq // lay.rows) * b * h)


class Bf16Plan(NamedTuple):
    """How the bf16 forward kernel cuts one call. ``route`` 0: the long-row
    loop of ``csrc/attention_sm90.cuh``, one block per (128-query tile,
    head), a ring of ``kv_bufs`` stages of 128 keys. ``route`` 1: the
    short-key kernel of ``csrc/attention_short_sm90.cuh``, ``grid``
    persistent blocks, each taking a share of the (b * h, query tile)
    items in the order ``walk`` gives (0: head by head, 1: heads fastest,
    as the kernel's ``Walk`` and ``Item``); K / V ``resident`` for a head
    in ``kv_bufs`` buffers of ``kv_unit_bytes`` where they fit, else a ring
    of ``kv_bufs`` stages; ``q_bufs`` Q buffers of 128 rows, in which O is
    staged for its TMA store. ``full_tiles`` 128-key tiles and a last one
    ``tail`` keys wide (0: none) cover Sk (``key_tiles``); ``items`` (b * h
    * query tiles) is the work. The entry point takes the route, the walk
    and the grid; the layout follows from the route and Sk
    (``csrc/attention_bf16_plan.cuh``, read here through
    ``csrc/flash_plan.cpp``). No device scratch."""
    route: int
    full_tiles: int
    tail: int
    resident: bool
    kv_bufs: int
    q_bufs: int
    kv_unit_bytes: int
    smem_bytes: int
    walk: int
    items: int
    grid: int

    @property
    def key_tiles(self):
        """The widths of the key tiles at Sk, in order."""
        return (128,) * self.full_tiles + ((self.tail,) if self.tail else ())


_SHORT_BF16_KEYS = 2048    # at or below this many keys (d 128): route 1


@functools.lru_cache(maxsize=4096)
def _bf16_layout(route, d, sk):
    """(full tiles, tail, resident, K / V buffers, Q buffers, bytes of a K /
    V buffer or stage, shared-memory bytes) of ``route`` at head dim ``d``
    and ``sk`` keys, as ``csrc/flash_attention.cu`` compiles it."""
    out = (ctypes.c_int * 7)()
    if not _plan_lib().wf_flash_bf16_plan(route, d, sk, out):
        raise ValueError(f"flash_attention bf16 kernel: no route {route} at "
                         f"head dim {d} and {sk} keys")
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _bf16_plan(b, sq, sk, h, d, route=None, num_sms=_H100_SMS, walk=None):
    """The bf16 forward kernel's plan for q [b, sq, h, d] and k [b, sk, h,
    d] on a card of ``num_sms`` SMs: route ``route`` (default 1, the
    short-key kernel, at head dim 128 for 1 to ``_SHORT_BF16_KEYS`` keys,
    else 0, the long-row loop) and, on route 1, ``walk`` (default heads
    fastest where two resident buffers hold K / V: a head's few keys, the
    next head's load in flight, and the blocks in flight read every head of
    the same tokens; else head by head, since one resident buffer is
    reloaded at each change of head and streamed tiles gain nothing from
    the other order; ``chip_smoke.py`` times both walks) on one block an
    SM, never more blocks than items. Route 0 runs one block per query tile
    and head, walk 0."""
    if d not in (64, 128):
        raise ValueError(f"flash_attention bf16 kernel: no instantiation for "
                         f"head dim {d}")
    if route is None:
        route = int(d == 128 and 1 <= sk <= _SHORT_BF16_KEYS)
    full, tail, resident, kv_bufs, q_bufs, unit, smem = _bf16_layout(
        route, d, sk)
    items = -(-sq // 128) * b * h
    if route == 0:
        if walk not in (None, 0):
            raise ValueError("flash_attention bf16 kernel: route 0 has walk "
                             "0")
        return Bf16Plan(0, full, tail, False, kv_bufs, q_bufs, unit, smem, 0,
                        items, items)
    walk = int(resident and kv_bufs == 2) if walk is None else walk
    if walk not in (0, 1):
        raise ValueError(f"flash_attention bf16 kernel: no walk {walk}")
    return Bf16Plan(1, full, tail, bool(resident), kv_bufs, q_bufs, unit,
                    smem, walk, items, min(items, num_sms))


@functools.lru_cache(maxsize=16)
def _num_sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k, v, kv_lens, scale, return_lse, plan=None):
    """The kernel on CUDA tensors, cut as ``plan`` says (default
    ``_bf16_plan``'s or ``_fwd_plan``'s; a timing harness may pass another
    compiled route or variant)."""
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
    if any(st * t.element_size() % 16 for t in (q, k, v)
           for st in t.stride()[:-1]):
        raise ValueError("flash_attention kernel: every stride of q, k and v "
                         "must be a multiple of 16 bytes (TMA)")
    if plan is None:
        sms = _num_sms(q.device)
        plan = (_fwd_plan(b, sq, sk, h, d, num_sms=sms)
                if q.dtype == torch.float32 else
                _bf16_plan(b, sq, sk, h, d, num_sms=sms))
    blocks = plan.grid if isinstance(plan, Bf16Plan) else plan.blocks
    if not 0 < blocks < 2 ** 31:
        raise ValueError(f"flash_attention kernel: {blocks} blocks "
                         f"(gridDim.x holds 1 to 2^31 - 1)")
    if kv_lens is not None:   # else every batch row has sk keys
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty_like(q)
    m = l = None
    if return_lse:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_lens.data_ptr() if kv_lens is not None else None,
            o.data_ptr(), m.data_ptr() if m is not None else None,
            l.data_ptr() if l is not None else None, b, sq, sk, h, d,
            float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    passes = 1
    if isinstance(plan, Bf16Plan):
        err = lib.wf_flash_attention(*ptrs, plan.route, plan.walk,
                                     plan.grid, stream)
    else:
        # the two-pass route's scores and partials, from the caching
        # allocator on this stream; its size depends on the shapes only, so
        # a CUDA graph's warm-up and capture take the same
        scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                               device=q.device)
                   if plan.scratch_bytes else None)
        err = lib.wf_flash_attention_f32(
            *ptrs, plan.variant, plan.chunk_tiles,
            scratch.data_ptr() if scratch is not None else None,
            plan.scratch_bytes, stream)
        passes = plan.passes
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
    by = flash_attention.passes_by_instantiation
    by[inst] = by.get(inst, 0) + passes
    return (o, m, l) if return_lse else o


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("flash_attention", {
        "wf_flash_attention": ([p] * 7 + [i] * 5 + [ctypes.c_float]
                               + [i] * 3 + [p], i),
        "wf_flash_attention_f32": ([p] * 7 + [i] * 5 + [ctypes.c_float]
                                   + [i] * 2 + [p, ctypes.c_longlong, p],
                                   i),
        "wf_flash_attention_error_string": ([i], ctypes.c_char_p),
    })


def _plan_lib():
    i = ctypes.c_int
    return _build.bind("flash_plan", {
        "wf_flash_bf16_plan": ([i] * 3 + [ctypes.POINTER(i)], i),
        "wf_flash_f32_plan": ([i] * 4 + [ctypes.POINTER(ctypes.c_longlong)],
                              i),
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
    to ``launches_by_shape[("fp32 d512", B * H, Sq, Sk)]``; the kernel
    launches it made (two a chunk at fp32 d 384 / 512, else one) go to
    ``passes_by_instantiation["fp32 d512"]``.

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
flash_attention.passes_by_instantiation = {}
