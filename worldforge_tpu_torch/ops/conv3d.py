"""Causal 3x3x3 stride-1 convolution for the VAE — kernel 4.

Counterpart of ``worldforge_tpu/ops/conv3d.py::conv3d_causal_pallas``; the
Pallas TPU kernel ``_conv_kernel`` (:39, ``pallas_call`` :119) becomes the
CUDA C++ implicit GEMM on TMA and wgmma in ``csrc/conv3d.cu`` (the design
note and what bounds it on the H100 are at the top of that file). The
kernel reads x in the type it is given (fp32 or bf16) and rounds it to bf16
as it stages it; ``conv_plan`` picks its tiles and ``prepared_weight`` makes
the bf16 weight layout once per weight tensor.

Contract: x [B, T+2, H, W, Cin] already front-padded in time, SAME spatial
padding, w [3, 3, 3, Cin, Cout] (DHWIO), optional bias [Cout]. Inputs and
weights are rounded to bf16, products accumulate in fp32, the fp32 bias is
added and the result is cast to ``out_dtype``.

``conv2d_3x3`` is the same kernel with one temporal tap: the stride-1 3x3
SAME convolution of every frame [N, H, W, Cin] with w [3, 3, Cin, Cout],
on the same contract (the VAE decoder's resample convs on the card).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core.params import no_tf32
from worldforge_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv3d_causal_plain(x, w, b=None, *, out_dtype=None):
    """The kernel's function in plain PyTorch: a cuDNN/ATen fp32 conv of the
    bf16-rounded operands (exact bf16 products, fp32 sums; TF32 off)."""
    out_dtype = out_dtype or x.dtype
    xb = x.to(torch.bfloat16).float().permute(0, 4, 1, 2, 3)   # NCDHW view
    wb = w.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2)   # OIDHW
    with no_tf32():
        y = F.conv3d(xb, wb, padding=(0, 1, 1))
    y = y.permute(0, 2, 3, 4, 1)
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).contiguous()


def conv2d_3x3_plain(x, w, b=None, *, out_dtype=None):
    """``conv2d_3x3``'s function in plain PyTorch: the fp32 conv of the
    bf16-rounded operands (TF32 off)."""
    out_dtype = out_dtype or x.dtype
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)      # NCHW view
    wb = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)      # OIHW
    with no_tf32():
        y = F.conv2d(xb, wb, padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).contiguous()


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


TILE_H, TILE_W = 8, 32              # output rows x pixels of one block
SMEM_LIMIT = 232448                 # shared memory a block may use (227 KB)
_SLICES = (128, 96, 32, 16)         # N instantiations of the kernel
_MAX_STAGES = 4


@dataclass(frozen=True)
class ConvPlan:
    """One launch of ``csrc/conv3d.cu``: the block's output tile, the Cout
    slice N each block computes (``nslices`` of them), the Cin chunk CK of
    one pipeline stage, the ring's depth, how x reaches shared memory (TMA,
    through ``staging`` fp32 buffers for fp32 x; ``manual``: the producer's
    threads), the swizzle of the weight panels and the dynamic shared
    memory, counted as the kernel's ``Plan`` does."""
    cin_p: int
    cout_p: int
    tile: tuple
    n: int
    nslices: int
    ck: int
    stages: int
    manual: bool
    staging: int
    swizzle_bytes: int
    stage_bytes: int
    staging_bytes: int
    epilogue_bytes: int
    smem_bytes: int


def conv_plan(cin: int, cout: int, x_dtype=torch.float32,
              x_aligned: bool = True) -> ConvPlan:
    """The tile plan for Cin -> Cout on x of ``x_dtype``. N is CoutP itself
    up to 128, else the widest of 128, 96, 32, 16 that divides it (the two
    64-row accumulators are N fp32 registers a consumer thread). TMA reads
    x where a row of Cin elements is a multiple of 16 bytes and x is
    16-byte aligned, else the producer's threads stage it (``manual``); an
    fp32 x goes through fp32 staging buffers, two where they fit, else one.
    CK is 32 where it divides CinP and fits with two stages, else 16; the
    ring takes as many stages (2 to 4) as fit in 227 KB."""
    cin_p, cout_p = _round16(cin), _round16(cout)
    n = next(s for s in _SLICES if cout_p % s == 0)
    elem = 2 if x_dtype == torch.bfloat16 else 4
    manual = not (x_aligned and (cin * elem) % 16 == 0)
    sw = 128 if n % 64 == 0 else 64 if n % 32 == 0 else 32
    slab_pix = (TILE_H + 2) * (TILE_W + 2)
    epilogue = 4 * TILE_H * TILE_W * (n + 8)

    def sizes(ck):
        stage = _round1024(9 * ck * n * 2) + _round1024(slab_pix * ck * 2)
        return stage, _round1024(slab_pix * ck * 4)

    def total(ck, stages, nstg):
        stage, stg = sizes(ck)
        return (1024 + max(stages * stage + nstg * stg, epilogue)
                + 8 * (2 * stages + nstg))

    staging_options = (2, 1) if elem == 4 and not manual else (0,)
    for ck in (32, 16):
        if cin_p % ck:
            continue
        fits = [(nstg, st) for nstg in staging_options
                for st in range(_MAX_STAGES, 1, -1)
                if total(ck, st, nstg) <= SMEM_LIMIT]
        if fits or ck == 16:
            break
    nstg, stages = fits[0] if fits else (staging_options[-1], 2)
    stage, stg = sizes(ck)
    return ConvPlan(cin_p, cout_p, (TILE_H, TILE_W), n, cout_p // n, ck,
                    stages, manual, nstg, sw, stage, stg, epilogue,
                    total(ck, stages, nstg))


def prepare_weight(w: torch.Tensor) -> torch.Tensor:
    """[KT, 3, 3, Cin, Cout] -> bf16 [9 KT, Cin16, Cout16] zero-padded to
    multiples of 16, the layout the kernel stages from (a 2-D [3, 3, Cin,
    Cout] weight is KT = 1)."""
    cin, cout = w.shape[-2], w.shape[-1]
    taps = w.numel() // (cin * cout)
    wp = torch.zeros((taps, _round16(cin), _round16(cout)),
                     dtype=torch.bfloat16, device=w.device)
    wp[:, :cin, :cout] = w.reshape(taps, cin, cout).to(torch.bfloat16)
    return wp


def prepared_weight(w: torch.Tensor) -> torch.Tensor:
    """``prepare_weight(w)``, made once per weight tensor and kept on it; made
    again when the tensor is changed in place (its ``_version``; an
    inference tensor has none and is keyed by its storage alone) or its
    storage is swapped."""
    version = None if w.is_inference() else w._version
    key = (version, w.data_ptr(), tuple(w.shape), w.dtype, w.device)
    cached = getattr(w, "_wf_conv3d_weight", None)
    if cached is None or cached[0] != key:
        cached = (key, prepare_weight(w.detach()))
        w._wf_conv3d_weight = cached
    return cached[1]


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("conv3d", {
        "wf_conv3d_causal": ([p, p, p, p] + [i] * 17 + [p], i),
        "wf_conv3d_error_string": ([i], ctypes.c_char_p),
    })


def _launch(x, w, b, out_dtype, taps):
    """x [B, Tp, H, W, Cin]; w [3, 3, 3, Cin, Cout] (taps 3) or [3, 3, Cin,
    Cout] (taps 1)."""
    bn_, tp, hh, ww, cin = x.shape
    if w.shape[:-1] != (3,) * (taps // 3 + 2) + (cin,):
        raise ValueError(f"conv3d kernel: weight {tuple(w.shape)} for input "
                         f"{tuple(x.shape)}")
    if tp < taps:
        raise ValueError(f"conv3d kernel: needs at least {taps} frames")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3d kernel: dtypes {x.dtype} -> {out_dtype}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("conv3d kernel: tensors on two devices")
    cout = w.shape[-1]
    x = x.contiguous()          # read as it is: no bf16 copy of x
    plan = conv_plan(cin, cout, x.dtype, x.data_ptr() % 16 == 0)
    wp = prepared_weight(w)
    bias = b.float().contiguous() if b is not None else None
    y = torch.empty((bn_, tp - taps + 1, hh, ww, cout), dtype=out_dtype,
                    device=x.device)
    lib = _lib()
    err = lib.wf_conv3d_causal(
        x.data_ptr(), wp.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), bn_, tp,
        taps, hh, ww, cin, plan.cin_p, cout, plan.cout_p, plan.n, plan.ck,
        plan.stages, int(plan.manual), plan.staging, plan.smem_bytes,
        _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[out_dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv3d kernel launch failed: "
                           + lib.wf_conv3d_error_string(err).decode())
    return y


def conv3d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *,
                  out_dtype=None) -> torch.Tensor:
    """x [B, T+2, H, W, Cin] (temporally pre-padded), w [3,3,3,Cin,Cout],
    b [Cout] or None. Returns [B, T, H, W, Cout]. CUDA tensors launch the
    kernel; CPU tensors take ``conv3d_causal_plain``. Each launch adds one to
    ``launches`` and to ``launches_by_shape[(B, T, H, W, Cin, Cout)]``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv3d_causal_plain(x, w, b, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_causal: unsupported device {x.device}")
    y = _launch(x, w, b, out_dtype, 3)
    conv3d_causal.launches += 1
    key = (*y.shape[:4], x.shape[-1], y.shape[-1])
    conv3d_causal.launches_by_shape[key] = (
        conv3d_causal.launches_by_shape.get(key, 0) + 1)
    return y


conv3d_causal.launches = 0
conv3d_causal.launches_by_shape = {}


def conv2d_3x3(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               out_dtype=None) -> torch.Tensor:
    """x [N, H, W, Cin], w [3, 3, Cin, Cout] (HWIO), b [Cout] or None:
    the stride-1 3x3 SAME convolution, [N, H, W, Cout]. CUDA tensors launch
    kernel 4 with one temporal tap (the N frames as one batch row); CPU
    tensors take ``conv2d_3x3_plain``. Each launch adds one to ``launches``
    and to ``launches_by_shape[(N, H, W, Cin, Cout)]``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv2d_3x3_plain(x, w, b, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_3x3: unsupported device {x.device}")
    y = _launch(x[None], w, b, out_dtype, 1)[0]
    conv2d_3x3.launches += 1
    key = (*x.shape, w.shape[-1])
    conv2d_3x3.launches_by_shape[key] = (
        conv2d_3x3.launches_by_shape.get(key, 0) + 1)
    return y


conv2d_3x3.launches = 0
conv2d_3x3.launches_by_shape = {}
