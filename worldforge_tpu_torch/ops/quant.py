"""Weight quantization for the dense layers: W8A8, W4A8 and W6A8.

Counterpart of ``worldforge_tpu/ops/quant.py`` (:29-389), with the same
codes, scales, packing and numerics:

  - W8A8: per-output-channel symmetric int8 weights (``w8``, ``scale``),
    per-token symmetric int8 activations quantized at run time, int32 sums,
    then the fp32 rescale ``acc * s_x * s_w`` (+ ``b``) and the cast.
  - W4A8: int4 weights in groups of 128 along the in-dim (``w4`` packs row
    i with row i + in/2 into one byte, ``scale4`` per group), requantized
    per call to per-output-channel int8 with the precomputed ``scale8`` and
    run on the int8 product. Legacy trees without ``scale8`` dequantize to
    bf16: the only dequantizing path, as in JAX.
  - W6A8: int6 weights (``w6``, four rows in three byte planes,
    ``scale6``), requantized to int8 like int4.

The int8 x int8 -> int32 product is ``torch._int_mm`` (cuBLASLt's int8 GEMM
on the card), as the JAX package leaves its ``preferred_element_type=int32``
dot to XLA outside any Pallas kernel. On the card its first operand needs
more than 16 rows and K and N multiples of 8: ``int8_matmul`` pads with
zeros where a shape breaks one of those and slices the pad off, so the sums
are the exact ones on every shape. Its second operand has to be
column-major, so the int8 weights are stored so (the same values; a
row-major [5,120 x 13,824] ran 7.4x slower on the H100, and some shapes
are refused). The activation quantization, the
int4 / int6 requantization and the rescale are plain PyTorch on both
devices (XLA fuses them in JAX).

``core/params.py::dense`` dispatches on ``w8`` / ``w4`` / ``w6``, so the
model forwards run unchanged on a tree that ``quantize_tree`` converted.
The port quantizes each 2-D layer of its block lists where JAX quantizes
``[L, in, out]`` stacks with per-layer scales: the codes are equal layer by
layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as a true division on every device: CUDA divides a tensor
    by a Python number as a product with its reciprocal, which is one bit
    off the quotient JAX and the CPU compute."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _col_major(w8: torch.Tensor) -> torch.Tensor:
    """[.., K, N] laid out as the transpose of a contiguous [.., N, K] (the
    same values): cuBLASLt's int8 GEMM takes its second operand so, and
    refuses or runs ~7x slower on a row-major one (H100, measured)."""
    if w8.stride(-2) == 1:
        return w8
    return w8.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor):
    """[.., in, out] -> (int8 [.., in, out], fp32 scale [.., out]); the
    codes laid out column-major (``_col_major``)."""
    wf = w.float()
    s = _div(wf.abs().amax(dim=-2), 127.0).clamp_min(1e-8)
    w8 = torch.round(wf / s[..., None, :]).clamp_(-127, 127).to(torch.int8)
    return _col_major(w8), s


def quantize_dense(p: dict) -> dict:
    """{"w": [in, out], "b"?, ...} -> {"w8", "scale", "b"?, ...}: other keys
    (attached LoRA terms) pass through."""
    w8, s = quantize_weight(p["w"])
    out = {k: v for k, v in p.items() if k != "w"}
    out.update(w8=w8, scale=s)
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def quantize_activations(x: torch.Tensor):
    """Per-token symmetric int8: (x8, fp32 scale [..., 1]). One call serves
    several products over the same activations (the Wan q / k / v)."""
    # max |x| without an fp32 copy or an |x| temporary: exact either way
    amax = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                    dtype=torch.float32)
    sx = _div(amax, 127.0).clamp_min(1e-8)
    x8 = torch.round(x / sx).clamp_(-127, 127).to(torch.int8)
    return x8, sx


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim % t.ndim) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int8 [.., K] x int8 [K, N] -> the exact int32 sums [.., N].

    On the card the rows are padded with zeros to a multiple of 8 and at
    least 32 (``_int_mm`` takes more than 16), K and N to multiples of 8
    (exact), the pad sliced off after; the weight goes in column-major
    (``_col_major``: a no-op for the weights ``quantize_weight`` makes, a
    transposing copy for the requantized int4 / int6 ones)."""
    k, n = w8.shape
    a = x8.reshape(-1, k)
    m = a.shape[0]
    if a.is_cuda:
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        a = _pad_to(_pad_to(a, 1, kp), 0, max(-(-m // 8) * 8, 32))
        w = _col_major(_pad_to(_pad_to(w8, 0, kp), 1, np_))
        acc = torch._int_mm(a, w)[:m, :n]
    else:
        acc = torch._int_mm(a, w8)
    return acc.reshape(x8.shape[:-1] + (n,))


def _rescale(acc, sx, scale, b, out_dtype):
    """``acc * s_x * s_w`` (+ ``b``) in fp32, in that order, then the cast;
    in place on the fp32 copy of ``acc``."""
    y = acc.float().mul_(sx).mul_(scale.float())
    if b is not None:
        y.add_(b.float())
    return y.to(out_dtype)


def dense_q8_pre(p: dict, x8: torch.Tensor, sx: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """The int8 product over activations already quantized."""
    return _rescale(int8_matmul(x8, p["w8"]), sx, p["scale"], p.get("b"),
                    out_dtype)


def dense_q8(p: dict, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Dynamic-activation int8 product: (q(x) @ w8) * s_x * s_w + b."""
    x8, sx = quantize_activations(x)
    return dense_q8_pre(p, x8, sx, out_dtype=out_dtype or x.dtype)


def is_quantized(p) -> bool:
    return isinstance(p, dict) and ("w8" in p or "w4" in p or "w6" in p)


# ------------------------------------------------------------------ int4


def quantize_weight_int4(w: torch.Tensor, group: int = 128):
    """[.., in, out] -> (uint8 [.., in/2, out], fp32 scale [.., in/g, out]).
    Symmetric [-7, 7] per (group, out) cell; row i goes to the low nibble
    and row i + in/2 to the high nibble of byte i, both offset by +8.
    Per-output-channel scaling when ``group`` does not divide in/2."""
    wf = w.float()
    in_dim, out_dim = wf.shape[-2], wf.shape[-1]
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {in_dim}")
    g = group if group and (in_dim // 2) % group == 0 else in_dim
    ng = in_dim // g
    wg = wf.reshape(*wf.shape[:-2], ng, g, out_dim)
    s = _div(wg.abs().amax(dim=-2), 7.0).clamp_min(1e-8)
    q = torch.round(wg / s[..., :, None, :]).clamp_(-7, 7)
    q = q.reshape(*wf.shape[:-2], in_dim, out_dim).to(torch.int8)
    half = in_dim // 2
    lo = (q[..., :half, :] + 8).to(torch.uint8)
    hi = (q[..., half:, :] + 8).to(torch.uint8)
    return lo | (hi << 4), s


def quantize_dense_int4(p: dict, group: int = 128) -> dict:
    """{"w", "b"?, ...} -> {"w4", "scale4", "scale8", "b"?, ...}; ``scale8``
    [.., out] is the per-output-channel int8 requantization scale,
    7 * max over groups of scale4 / 127."""
    w4, s = quantize_weight_int4(p["w"], group=group)
    s8 = _div(7.0 * s.amax(dim=-2), 127.0).clamp_min(1e-8)
    out = {k: v for k, v in p.items() if k != "w"}
    out.update(w4=w4, scale4=s, scale8=s8)
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def _unpack_int4(u: torch.Tensor) -> torch.Tensor:
    """uint8 [.., in/2, out] -> int8 codes [.., in, out] in [-7, 7]."""
    lo = (u & 0xF).to(torch.int8) - 8
    hi = (u >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def _grouped(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int codes [.., in, out] times their group scales [.., ng, out], fp32,
    as [.., ng, in/ng, out]."""
    in_dim, out_dim = q.shape[-2], q.shape[-1]
    ng = s.shape[-2]
    qg = q.reshape(*q.shape[:-2], ng, in_dim // ng, out_dim)
    return qg.float() * s[..., :, None, :]


def dequantize_int4(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"w4", "scale4"} -> the dense [.., in, out] weight."""
    q = _unpack_int4(p["w4"])
    return _grouped(q, p["scale4"].float()).reshape(q.shape).to(dtype)


def _requantize_to_int8(q, s, s8):
    """Codes times ``s / s8`` rounded to int8 (the ratio is at most 127/7
    or 127/31, so nothing overflows)."""
    ratio = s.float() / s8.float()[..., None, :]
    w8 = torch.round(_grouped(q, ratio)).clamp_(-127, 127).to(torch.int8)
    return w8.reshape(q.shape)


def _requantize_int4_to_int8(p: dict) -> torch.Tensor:
    """int4 codes -> per-output-channel int8: round(q * scale4 / scale8)."""
    return _requantize_to_int8(_unpack_int4(p["w4"]), p["scale4"],
                               p["scale8"])


# ------------------------------------------------------------------ int6


def quantize_weight_int6(w: torch.Tensor, group: int = 128):
    """[.., in, out] -> (uint8 [.., 3, in/4, out] planes, fp32 scale
    [.., in/g, out]). Symmetric [-31, 31] per (group, out) cell, stored
    offset by +32; rows i, i + in/4, i + in/2, i + 3in/4 share byte column
    i of the three planes. Per-output-channel scaling when ``group`` does
    not divide in/4."""
    wf = w.float()
    in_dim, out_dim = wf.shape[-2], wf.shape[-1]
    if in_dim % 4:
        raise ValueError(f"int6 packing needs in-dim % 4 == 0, got {in_dim}")
    g = group if group and (in_dim // 4) % group == 0 else in_dim
    ng = in_dim // g
    wg = wf.reshape(*wf.shape[:-2], ng, g, out_dim)
    s = _div(wg.abs().amax(dim=-2), 31.0).clamp_min(1e-8)
    q = torch.round(wg / s[..., :, None, :]).clamp_(-31, 31)
    v = (q.reshape(*wf.shape[:-2], in_dim, out_dim) + 32.0).to(torch.uint8)
    v0, v1, v2, v3 = torch.chunk(v, 4, dim=-2)
    b0 = v0 | ((v1 & 0x3) << 6)
    b1 = (v1 >> 2) | ((v2 & 0xF) << 4)
    b2 = (v2 >> 4) | (v3 << 2)
    return torch.stack([b0, b1, b2], dim=-3), s


def _unpack_int6(u: torch.Tensor) -> torch.Tensor:
    """uint8 [.., 3, in/4, out] -> int8 codes [.., in, out] in [-31, 31]."""
    b0, b1, b2 = u[..., 0, :, :], u[..., 1, :, :], u[..., 2, :, :]
    v0 = b0 & 63
    v1 = (b0 >> 6) | ((b1 & 0xF) << 2)
    v2 = (b1 >> 4) | ((b2 & 0x3) << 4)
    v3 = b2 >> 2
    return torch.cat([v0, v1, v2, v3], dim=-2).to(torch.int8) - 32


def quantize_dense_int6(p: dict, group: int = 128) -> dict:
    """{"w", ...} -> {"w6", "scale6", "scale8", "b"?, ...}; ``scale8`` =
    31 * max over groups of scale6 / 127."""
    w6, s = quantize_weight_int6(p["w"], group=group)
    s8 = _div(31.0 * s.amax(dim=-2), 127.0).clamp_min(1e-8)
    out = {k: v for k, v in p.items() if k != "w"}
    out.update(w6=w6, scale6=s, scale8=s8)
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def dequantize_int6(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{"w6", "scale6"} -> the dense [.., in, out] weight."""
    q = _unpack_int6(p["w6"])
    return _grouped(q, p["scale6"].float()).reshape(q.shape).to(dtype)


def _requantize_int6_to_int8(p: dict) -> torch.Tensor:
    """int6 codes -> per-output-channel int8: round(q * scale6 / scale8)."""
    return _requantize_to_int8(_unpack_int6(p["w6"]), p["scale6"],
                               p["scale8"])


def dense_q6(p: dict, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """int6-stored product, W6A8: the requantized int8 weights on the int8
    product with per-token int8 activations."""
    x8, sx = quantize_activations(x)
    acc = int8_matmul(x8, _requantize_int6_to_int8(p))
    return _rescale(acc, sx, p["scale8"], p.get("b"), out_dtype or x.dtype)


def dense_q4(p: dict, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """int4-stored product. With ``scale8`` (every tree ``quantize_tree``
    makes): W4A8, as ``dense_q6``. Legacy trees without it: the weights
    dequantized to bf16 and an fp32-accumulated bf16 product."""
    if "scale8" in p:
        x8, sx = quantize_activations(x)
        acc = int8_matmul(x8, _requantize_int4_to_int8(p))
        return _rescale(acc, sx, p["scale8"], p.get("b"),
                        out_dtype or x.dtype)
    w = dequantize_int4(p, dtype=torch.bfloat16)
    y = x.to(torch.bfloat16).float() @ w.float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(out_dtype or x.dtype)


# ------------------------------------------------------------- tree walk

DEFAULT_KEYS = ("qkv", "attn_proj", "proj", "x_q", "x_kv", "x_proj",
                "w1", "w2", "w3", "fc1", "fc2", "q", "k", "v", "o",
                "to_q", "to_k", "to_v", "to_out", "ffn1", "ffn2",
                "img_kv", "k_img", "v_img", "a_q", "a_kv", "a_proj")
# fp32 islands: the time embeddings, the heads, LongCat's adaLN embedder
EXCLUDE_PATHS = ("time_embedding", "time_projection", "head",
                 "t_embedder", "final")
# conditioning embeddings keep W8A8 when their leaf name is an int4 key
INT4_EXCLUDE_PATHS = ("text_embedding", "img_emb", "txt_in", "vector_in",
                      "audio_proj")


def _default_pred(path: str) -> bool:
    parts = path.split("/")
    return (parts[-1] in DEFAULT_KEYS
            and not any(p in EXCLUDE_PATHS for p in parts))


def _is_dense(node: dict) -> bool:
    return "w" in node and isinstance(node["w"], torch.Tensor)


def quantize_tree(params, predicate: Optional[Callable[[str], bool]] = None,
                  int4_keys: tuple = (), int4_group: int = 128,
                  int6_keys: tuple = (), int6_group: int = 128,
                  downcast_adaln: bool = True):
    """Convert the dense dicts whose '/'-joined path (list indices left
    out) matches ``predicate`` (default: the large attention / FFN
    products outside ``EXCLUDE_PATHS``). A matched leaf named in
    ``int6_keys`` becomes int6, else one named in ``int4_keys`` int4
    (``("*",)`` matches every leaf), else W8A8; leaves under
    ``INT4_EXCLUDE_PATHS`` stay W8A8. With ``downcast_adaln`` every
    per-block ``*adaln`` dense outside ``EXCLUDE_PATHS`` is stored in bf16
    (``dense`` keeps the fp32 input precision with its hi / lo split).
    Returns a new tree; leaves it does not convert are shared."""
    pred = predicate or _default_pred

    def walk(node, path=""):
        if isinstance(node, dict):
            parts = path.split("/")
            if _is_dense(node) and node["w"].ndim in (2, 3) and pred(path):
                sub8_ok = not any(p in INT4_EXCLUDE_PATHS for p in parts)
                if sub8_ok and ("*" in int6_keys or parts[-1] in int6_keys):
                    return quantize_dense_int6(node, group=int6_group)
                if sub8_ok and ("*" in int4_keys or parts[-1] in int4_keys):
                    return quantize_dense_int4(node, group=int4_group)
                return quantize_dense(node)
            if (downcast_adaln and _is_dense(node)
                    and parts[-1].endswith("adaln")
                    and not any(p in EXCLUDE_PATHS for p in parts)):
                return dict(node, w=node["w"].to(torch.bfloat16))
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        return node

    return walk(params)
