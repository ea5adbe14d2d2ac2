"""Causal 3x3x3 stride-1 convolution for the VAE — kernel 4.

Counterpart of ``worldforge_tpu/ops/conv3d.py::conv3d_causal_pallas``; the
Pallas TPU kernel ``_conv_kernel`` (:39, ``pallas_call`` :119) becomes the
CUDA C++ implicit GEMM on TMA and wgmma in ``csrc/conv3d.cu`` (the design
note and what bounds it on the H100 are at the top of that file). The
kernel reads x in the type it is given (fp32 or bf16) and rounds it to bf16
as it stages it. Its launch plan is ``csrc/conv3d_plan.cuh``, plain C++
that the kernel includes and the host reads through ``csrc/conv_plan.cpp``
(``conv_plan``): one of three routes, a function of the temporal taps, the
width, Cin, Cout and x's type alone (the tile route; the walk for Cout <= 8
at three taps; the fold for Cin <= 8 at three taps and Cin <= 4 into one
Cout slice at one), and the output box, slice width,
channel chunk, ring and grid. ``prepared_weight`` makes the route's bf16
weight layout once per weight tensor.

Contract: x [B, T+2, H, W, Cin] already front-padded in time, SAME spatial
padding, w [3, 3, 3, Cin, Cout] (DHWIO), optional bias [Cout]. Inputs and
weights are rounded to bf16, products accumulate in fp32, the fp32 bias is
added and the result is cast to ``out_dtype``. The order of each output's
sums follows the route alone, so an H-strip or a chunk of frames sums as
the whole does.

``conv2d_3x3`` is the same kernel with one temporal tap: the stride-1 3x3
SAME convolution of every frame [N, H, W, Cin] with w [3, 3, Cin, Cout],
on the same contract (the VAE decoder's resample convs and the SVD UNet's
and VAE's 3x3 convs on the card).
"""

from __future__ import annotations

import ctypes
import functools
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


ROUTES = ("tile", "walk", "fold")   # conv3d_plan.cuh's Route, in order
_PLAN_FIELDS = (
    "route", "n", "nslices", "ck", "cin_p", "cout_p", "taps_k", "src",
    "stages", "staging", "box_f", "box_r", "box_w", "slab_pix", "tiles_f",
    "tiles_h", "tiles_w", "walk", "ksteps", "swizzle_bytes", "weight_bytes",
    "stage_bytes", "staging_bytes", "epilogue_bytes", "smem_bytes", "blocks",
    "smem_limit")
_H100_SMS = 132


@dataclass(frozen=True)
class ConvPlan:
    """One launch of ``csrc/conv3d.cu``, as ``csrc/conv3d_plan.cuh`` makes
    it (read through ``csrc/conv_plan.cpp``): the route (``ROUTES``), the
    Cout slice N a block computes (``nslices`` of them), the channel chunk
    CK of a stage (8 in the fold), the prepared weight's padded Cin and Cout
    and its leading taps, how x reaches shared memory (``src``: 0 TMA into
    the bf16 slab, 1 TMA through ``staging`` fp32 buffers, 2 the producer's
    threads), the ring's depth, the output box of a block (``box_f`` frames
    x ``box_r`` rows x ``box_w`` columns) and the boxes over T, H and W, the
    output frames a walking block covers, the k16 steps of a stage, the
    weight panels' swizzle, the bytes of the weights (a stage's, or resident
    in the walk and the fold), of a stage, of a staging buffer, of the
    epilogue's tile, the dynamic shared memory, the grid and the 227 KB
    limit."""
    route: int
    n: int
    nslices: int
    ck: int
    cin_p: int
    cout_p: int
    taps_k: int
    src: int
    stages: int
    staging: int
    box_f: int
    box_r: int
    box_w: int
    slab_pix: int
    tiles_f: int
    tiles_h: int
    tiles_w: int
    walk: int
    ksteps: int
    swizzle_bytes: int
    weight_bytes: int
    stage_bytes: int
    staging_bytes: int
    epilogue_bytes: int
    smem_bytes: int
    blocks: int
    smem_limit: int

    @property
    def route_name(self) -> str:
        return ROUTES[self.route]

    @property
    def manual(self) -> bool:
        return self.src == 2


def _plan_lib():
    i = ctypes.c_int
    return _build.bind("conv_plan", {
        "wf_conv3d_plan": ([i] * 10 + [ctypes.POINTER(ctypes.c_longlong)],
                           i)})


@functools.lru_cache(maxsize=1024)
def conv_plan(cin: int, cout: int, x_dtype=torch.float32,
              x_aligned: bool = True, *, taps: int = 3, batch: int = 1,
              frames: int = 1, height: int = 8, width: int = 32,
              sms: int = _H100_SMS) -> ConvPlan:
    """The launch plan of a conv with ``taps`` temporal taps over x [batch,
    frames + taps - 1, height, width, cin] of ``x_dtype`` (``x_aligned``:
    16-byte aligned) to ``cout`` channels on a card of ``sms`` SMs: the
    kernel's own numbers, from ``csrc/conv3d_plan.cuh``. The route follows
    taps, the width, Cin, Cout and x's type alone: ``fold`` for Cin <= 8 at
    3 taps (at 1 tap for Cin <= 4 into one slice of Cout <= 128), ``walk``
    for Cout <= 8 at 3 taps (Cin <= 112), else ``tile``, whose box
    is 8 x 32 at widths that are multiples of 32 and otherwise the box of
    at most 256 pixels with the most real rows (``choose_box``); N is the
    widest of 160 / 128 / 96 / 32 / 16 that divides the padded Cout, 128
    for 160 where the launch's blocks make it fill fewer waves; CK is 32
    where it divides CinP and fits with two stages at the route's largest
    slab, else 16; the ring takes as many stages (2 to 4) as fit in 227 KB.
    None of the box, the walk, the stages and the grid changes the order of
    the sums. Raises where no route takes the shape. Cached: a launch's
    host time counts beside kernels of a tenth of a millisecond."""
    elem = 2 if x_dtype == torch.bfloat16 else 4
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    if not _plan_lib().wf_conv3d_plan(taps, batch, frames, height, width,
                                      cin, cout, int(elem == 2),
                                      int(bool(x_aligned)), sms, out):
        raise ValueError(f"conv3d kernel: no plan for {cin} -> {cout} at "
                         f"{taps} taps, [{batch}, {frames}, {height}, "
                         f"{width}]")
    return ConvPlan(*(int(v) for v in out))


def prepare_weight(w: torch.Tensor) -> torch.Tensor:
    """[KT, 3, 3, Cin, Cout] (or [3, 3, Cin, Cout], KT = 1) -> the bf16
    layout the kernel stages from, zero-padded: [9 KT, Cin16, Cout16]
    (Cin, Cout to multiples of 16), or on the fold route (Cin <= 8 at KT =
    3; Cin <= 4 and Cout <= 128 at KT = 1) [9 KT + 1, 8, Cout16] (8
    channels a tap and a last zero tap, so that two taps fill each k16
    step)."""
    cin, cout = w.shape[-2], w.shape[-1]
    taps = w.numel() // (cin * cout)
    fold = cin <= 8 and (taps == 27 or (cin <= 4 and _round16(cout) <= 128))
    rows, cin_p = (taps + 1, 8) if fold else (taps, _round16(cin))
    wp = torch.zeros((rows, cin_p, _round16(cout)), dtype=torch.bfloat16,
                     device=w.device)
    wp[:taps, :cin, :cout] = w.reshape(taps, cin, cout).to(torch.bfloat16)
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
        "wf_conv3d_causal": ([p, p, p, p] + [i] * 13 + [p], i),
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_plan(cin, cout, x.dtype, x.data_ptr() % 16 == 0, taps=taps,
                     batch=bn_, frames=tp - taps + 1, height=hh, width=ww,
                     sms=sms)
    wp = prepared_weight(w)
    bias = b.float().contiguous() if b is not None else None
    y = torch.empty((bn_, tp - taps + 1, hh, ww, cout), dtype=out_dtype,
                    device=x.device)
    lib = _lib()
    err = lib.wf_conv3d_causal(
        x.data_ptr(), wp.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), bn_, tp,
        taps, hh, ww, cin, cout, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        sms, plan.route, plan.n, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
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
