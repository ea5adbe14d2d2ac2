"""Wan2.1 DiT denoiser (t2v / i2v) in PyTorch.

Counterpart of ``worldforge_tpu/models/wan/dit.py``: the same config, param
layout (dense ``[in, out]``, the ``(pt, ph, pw, c)`` patch-embed flatten) and
numerics policy (bf16 matmul inputs, fp32 residual stream, fp32 norm /
adaLN / gated-residual islands). The blocks are a list of per-layer dicts run
by a Python loop where the JAX package stacks them for ``lax.scan``
(``io/from_jax.py`` unstacks a JAX tree).

Kernels on this path (CUDA tensors launch them; CPU tensors take each
kernel's plain version):
  - the adaLN prologue ``LN(x) * (1 + scale) + shift`` -> ``ops/fused_norm``
    (kernel 3; the JAX package keeps its Pallas twin switched off),
  - q/k RoPE -> ``ops/rope.apply_rope_qk`` (kernel 2),
  - self- and cross-attention -> ``ops/attention`` -> flash attention
    (kernel 1).
Matrix products are ``torch.matmul``, as the JAX package leaves them to XLA;
on a quantized tree (``init_wan_dit_int8`` / ``init_wan_dit_w4``) they are
``ops/quant.py``'s int8 products, and the W8A8 self-attention quantizes its
input once for q, k and v.

``wan_dit_forward`` is differentiable (training, ``training/step.py``):
on CUDA tensors the gradients go through the backward kernels of kernels 1,
2 and 3, and ``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` around
the scan body), so only the blocks' inputs are kept. The pipelines call it
under their own ``torch.inference_mode``.

Under a ``mesh`` (``core/mesh.py``) the batch is cut on ``dp`` and the
tokens, after the patch embedding, on ``sp`` (Ulysses,
``parallel/ulysses.py``) or on ``sp_h`` x ``sp_w`` (``parallel/cp2d.py``);
each rank rotates its own RoPE rows, cross-attention and the FFN stay
local, and the output is gathered after the head. FSDP-sharded trees
(``parallel/sharding.py``) are gathered a block at a time.
``token_chunk`` > 1 runs the FFN over that many token chunks (exact math, a
smaller [N, ffn_dim] transient); it is ignored under a mesh, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.core.mesh import (AXIS_SP, AXIS_SP_H, AXIS_SP_W,
                                            TokenSplit,
                                            gather_batch, split_batch,
                                            sp_size)
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.fused_norm import modulated_layer_norm
from worldforge_tpu_torch.ops.quant import (dense_q8_pre,
                                            quantize_activations,
                                            quantize_tree)
from worldforge_tpu_torch.ops.rope import apply_rope_qk, rope_cos_sin
from worldforge_tpu_torch.parallel.cp2d import (cross_attention_2d,
                                                gather_cp_2d, grid_split,
                                                rope_rows_2d, split_cp_2d,
                                                ulysses_attention_2d,
                                                uses_cp2d)
from worldforge_tpu_torch.parallel.sharding import gather_params
from worldforge_tpu_torch.parallel.ulysses import (
    sequence_local_cross_attention, ulysses_attention)

CLIP_TOKENS = 257  # i2v CLIP image context tokens


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    model_type: str = "i2v"  # 't2v' | 'i2v'
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 36  # i2v: 16 latent + 4 mask + 16 first-frame cond
    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 40
    num_layers: int = 40
    eps: float = 1e-6
    clip_dim: int = 1280

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @classmethod
    def wan_14b_i2v(cls) -> "WanDiTConfig":
        return cls()

    @classmethod
    def wan_1_3b_t2v(cls) -> "WanDiTConfig":
        return cls(model_type="t2v", in_dim=16, dim=1536, ffn_dim=8960,
                   num_heads=12, num_layers=30)

    @classmethod
    def tiny(cls, model_type: str = "i2v") -> "WanDiTConfig":
        in_dim = 36 if model_type == "i2v" else 16
        return cls(model_type=model_type, in_dim=in_dim, dim=128,
                   ffn_dim=256, num_heads=2, num_layers=2, text_len=16,
                   text_dim=64, freq_dim=32)


# ------------------------------------------------------------------ init


def _attn_init(gen, dim, *, img_branch=False, dtype=torch.float32):
    dev = gen.device
    p = {
        "q": P.dense_init(gen, dim, dim, dtype=dtype),
        "k": P.dense_init(gen, dim, dim, dtype=dtype),
        "v": P.dense_init(gen, dim, dim, dtype=dtype),
        "o": P.dense_init(gen, dim, dim, dtype=dtype),
        "norm_q": P.rms_norm_init(dim, dtype=dtype, device=dev),
        "norm_k": P.rms_norm_init(dim, dtype=dtype, device=dev),
    }
    if img_branch:
        p["k_img"] = P.dense_init(gen, dim, dim, dtype=dtype)
        p["v_img"] = P.dense_init(gen, dim, dim, dtype=dtype)
        p["norm_k_img"] = P.rms_norm_init(dim, dtype=dtype, device=dev)
    return p


def init_wan_dit_layer(gen: torch.Generator, cfg: WanDiTConfig,
                       dtype=torch.float32) -> dict:
    d = cfg.dim
    return {
        "self_attn": _attn_init(gen, d, dtype=dtype),
        "cross_attn": _attn_init(gen, d, img_branch=cfg.model_type in
                                 ("i2v", "flf2v"), dtype=dtype),
        "norm3": P.layer_norm_init(d, affine=True, dtype=dtype,
                                   device=gen.device),
        "ffn": {
            "fc1": P.dense_init(gen, d, cfg.ffn_dim, dtype=dtype),
            "fc2": P.dense_init(gen, cfg.ffn_dim, d, dtype=dtype),
        },
        # kept fp32 (adaLN island)
        "modulation": P.normal(gen, (1, 6, d)) / d ** 0.5,
    }


def init_wan_dit(gen: torch.Generator, cfg: WanDiTConfig,
                 dtype=torch.bfloat16) -> dict:
    """Random init on ``gen.device`` (the JAX init's shapes, dtypes and
    distributions; a torch.Generator draws other numbers than a JAX key)."""
    return init_wan_dit_layerwise(gen, cfg, dtype)


def init_wan_dit_layerwise(gen: torch.Generator, cfg: WanDiTConfig,
                           dtype=torch.bfloat16,
                           layer_transform=None) -> dict:
    """The DiT built one layer at a time on ``gen.device``, each layer
    passed through ``layer_transform(tree) -> tree`` (e.g.
    ``ops/quant.py::quantize_tree``) as it is made, so the peak is the
    transformed model plus one untransformed layer; the blocks outside the
    list are transformed once at the end. The generator draws in the order
    of the dict below (patch, text embedding, time, projection, the blocks
    in order, the head, ``img_emb``) with or without a transform, so a
    transformed build equals the transform of ``init_wan_dit`` from a
    generator in the same state."""
    tf = layer_transform or (lambda t: t)
    d = cfg.dim
    dev = gen.device
    pin = cfg.in_dim * math.prod(cfg.patch_size)
    p = {
        "patch_embedding": P.dense_init(gen, pin, d, dtype=dtype),
        "text_embedding": {
            "fc1": P.dense_init(gen, cfg.text_dim, d, init="normal",
                                dtype=dtype),
            "fc2": P.dense_init(gen, d, d, init="normal", dtype=dtype),
        },
        "time_embedding": {
            "fc1": P.dense_init(gen, cfg.freq_dim, d, init="normal",
                                dtype=torch.float32),
            "fc2": P.dense_init(gen, d, d, init="normal", dtype=torch.float32),
        },
        "time_projection": P.dense_init(gen, d, d * 6, dtype=torch.float32),
        "blocks": [tf(init_wan_dit_layer(gen, cfg, dtype=dtype))
                   for _ in range(cfg.num_layers)],
        "head": {
            "head": P.dense_init(gen, d, cfg.out_dim * math.prod(
                cfg.patch_size), init="zeros", dtype=dtype),
            "modulation": P.normal(gen, (1, 2, d)) / d ** 0.5,
        },
    }
    if cfg.model_type in ("i2v", "flf2v"):
        c = cfg.clip_dim
        p["img_emb"] = {
            "norm_in": P.layer_norm_init(c, dtype=dtype, device=dev),
            "fc1": P.dense_init(gen, c, c, dtype=dtype),
            "fc2": P.dense_init(gen, c, d, dtype=dtype),
            "norm_out": P.layer_norm_init(d, dtype=dtype, device=dev),
        }
        if cfg.model_type == "flf2v":
            p["img_emb"]["emb_pos"] = torch.zeros(
                (1, 2 * CLIP_TOKENS, c), dtype=dtype, device=dev)
    if layer_transform is None:
        return p
    return dict(tf(dict(p, blocks=[])), blocks=p["blocks"])


def init_wan_dit_int8(gen: torch.Generator, cfg: WanDiTConfig,
                      dtype=torch.bfloat16) -> dict:
    """W8A8 build, layer by layer: equal to
    ``quantize_tree(init_wan_dit(gen, cfg, dtype))`` bit for bit."""
    return init_wan_dit_layerwise(gen, cfg, dtype,
                                  layer_transform=quantize_tree)


def init_wan_dit_w4(gen: torch.Generator, cfg: WanDiTConfig,
                    dtype=torch.bfloat16, int4_keys=("fc1", "fc2"),
                    int4_group: int = 128, int6_keys=(),
                    int6_group: int = 128) -> dict:
    """Mixed-precision build: int4 (W4A8) on ``int4_keys`` (the FFN by
    default), W8A8 on the other large products; ``int4_keys=("*",)`` is
    all-int4, and ``int6_keys`` takes the 6-bit rung first
    (``int6_keys=("fc1", "fc2"), int4_keys=("*",)``: int6 FFN + int4
    attention)."""
    return init_wan_dit_layerwise(
        gen, cfg, dtype, layer_transform=functools.partial(
            quantize_tree, int4_keys=int4_keys, int4_group=int4_group,
            int6_keys=int6_keys, int6_group=int6_group))


# ------------------------------------------------------------------ pieces


def sinusoidal_embedding_1d(dim: int, t: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoid, freq 10000^(-i/half), fp32."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _heads(x, h):
    """Split the feature dim into heads: [..., D] -> [..., h, D/h]."""
    return x.reshape(x.shape[:-1] + (h, x.shape[-1] // h))


def _self_attention(p, cfg: WanDiTConfig, x, cos, sin, policy: Policy,
                    mesh=None, split=None):
    cdt = policy.compute_dtype
    xq = x.to(cdt)
    if "w8" in p["q"] and not any(
            "lora_down" in p[k] for k in ("q", "k", "v")):
        # W8A8: q / k / v share one activation quantization; leaves with
        # an unmerged LoRA take the generic dense
        x8, sx = quantize_activations(xq)
        q = P.rms_norm(p["norm_q"], dense_q8_pre(p["q"], x8, sx, cdt),
                       eps=cfg.eps)
        k = P.rms_norm(p["norm_k"], dense_q8_pre(p["k"], x8, sx, cdt),
                       eps=cfg.eps)
        v = dense_q8_pre(p["v"], x8, sx, cdt)
    else:
        q = P.rms_norm(p["norm_q"], P.dense(p["q"], xq), eps=cfg.eps)
        k = P.rms_norm(p["norm_k"], P.dense(p["k"], xq), eps=cfg.eps)
        v = P.dense(p["v"], xq)
    h = cfg.num_heads
    q, k = apply_rope_qk(_heads(q, h), _heads(k, h), cos, sin)
    # Ulysses over the rank's split (both spatial axes under the 2-D
    # split), plain attention without one
    if uses_cp2d(mesh):
        o = ulysses_attention_2d(q, k, _heads(v, h), mesh=mesh, split=split)
    else:
        o = ulysses_attention(q, k, _heads(v, h), mesh=None, split=split)
    return P.dense(p["o"], o.reshape(x.shape[0], x.shape[1], cfg.dim))


def _cross_attention(p, cfg: WanDiTConfig, x, context, img_ctx_len: int,
                     policy: Policy, mesh=None):
    """context: [B, img_ctx_len + text_len, dim] (i2v) or [B, text_len, dim].
    Under a mesh each rank's tokens attend to the whole context locally."""
    if uses_cp2d(mesh):
        attend = functools.partial(cross_attention_2d, mesh=mesh)
    elif sp_size(mesh) > 1:
        attend = functools.partial(sequence_local_cross_attention, mesh=mesh)
    else:
        attend = attention
    cdt = policy.compute_dtype
    xq = x.to(cdt)
    ctx = context.to(cdt)
    h = cfg.num_heads
    q = _heads(P.rms_norm(p["norm_q"], P.dense(p["q"], xq), eps=cfg.eps), h)
    if img_ctx_len and cfg.model_type in ("i2v", "flf2v"):
        ctx_img, ctx_txt = ctx[:, :img_ctx_len], ctx[:, img_ctx_len:]
    else:
        ctx_img, ctx_txt = None, ctx
    k = _heads(P.rms_norm(p["norm_k"], P.dense(p["k"], ctx_txt),
                          eps=cfg.eps), h)
    v = _heads(P.dense(p["v"], ctx_txt), h)
    o = attend(q, k, v)
    if ctx_img is not None:
        k_i = _heads(P.rms_norm(p["norm_k_img"], P.dense(p["k_img"], ctx_img),
                                eps=cfg.eps), h)
        v_i = _heads(P.dense(p["v_img"], ctx_img), h)
        o = o + attend(q, k_i, v_i)
    return P.dense(p["o"], o.reshape(x.shape[:-1] + (cfg.dim,)))


def _modulated_ln(xf, sc, sh, eps, out_dtype):
    """The adaLN prologue through kernel 3 (``ops/fused_norm``)."""
    return modulated_layer_norm(xf, sc, sh, eps=eps, out_dtype=out_dtype)


def _ffn(p, h3, token_chunk: int = 1):
    """The FFN, over ``token_chunk`` token chunks when that divides the
    tokens (row for row the same math; the [N, ffn_dim] gate transient
    shrinks by the factor)."""
    def f(xc):
        return P.dense(p["fc2"], P.gelu_tanh(P.dense(p["fc1"], xc)))

    if token_chunk > 1 and h3.shape[1] % token_chunk == 0:
        return torch.cat([f(c) for c in h3.chunk(token_chunk, dim=1)], dim=1)
    return f(h3)


def wan_dit_layer_forward(p, cfg: WanDiTConfig, x, e0, context, cos, sin,
                          img_ctx_len: int = 0,
                          policy: Policy = DEFAULT_POLICY, mesh=None,
                          split=None, token_chunk: int = 1):
    """One WanAttentionBlock. x: [B, L, dim] fp32 residual stream (this
    rank's tokens under a ``split``), e0: [B, 6, dim] fp32, context:
    [B, Lc, dim]. An FSDP-sharded block is gathered first."""
    p = gather_params(p, mesh)
    mod = p["modulation"].float() + e0.float()
    bcast = (mod.shape[0], 1, mod.shape[-1])
    sh_sa, sc_sa, g_sa, sh_ff, sc_ff, g_ff = [
        mod[:, i].reshape(bcast) for i in range(6)]

    xf = x.float()
    h1 = _modulated_ln(xf, sc_sa, sh_sa, cfg.eps, policy.compute_dtype)
    y = _self_attention(p["self_attn"], cfg, h1, cos, sin, policy, mesh,
                        split)
    xf = xf + y.float() * g_sa

    h2 = P.layer_norm(p["norm3"], xf, eps=cfg.eps,
                      out_dtype=policy.compute_dtype)
    y = _cross_attention(p["cross_attn"], cfg, h2, context, img_ctx_len,
                         policy, mesh)
    xf = xf + y.float()

    h3 = _modulated_ln(xf, sc_ff, sh_ff, cfg.eps, policy.compute_dtype)
    y = _ffn(p["ffn"], h3, token_chunk)
    return xf + y.float() * g_ff


def patchify(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, F' * H' * W', pt*ph*pw*C] with feature order
    (pt, ph, pw, c) matching a DHWIO conv kernel flatten."""
    b, c, f, hh, ww = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, f // pt, pt, hh // ph, ph, ww // pw, pw)
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)  # b f' h' w' pt ph pw c
    return x.reshape(b, (f // pt) * (hh // ph) * (ww // pw), pt * ph * pw * c)


def unpatchify(x: torch.Tensor, grid: Tuple[int, int, int],
               patch: Tuple[int, int, int], out_dim: int) -> torch.Tensor:
    """[B, L, pt*ph*pw*C] -> [B, C, F, H, W]."""
    b = x.shape[0]
    f, hh, ww = grid
    pt, ph, pw = patch
    x = x[:, :f * hh * ww].reshape(b, f, hh, ww, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)  # b c f pt h ph w pw
    return x.reshape(b, out_dim, f * pt, hh * ph, ww * pw)


def embed_time(params, cfg: WanDiTConfig, t: torch.Tensor):
    """Timestep embeddings (fp32 island): e [B, dim] for the head and e0
    [B, 6, dim] for the blocks' adaLN."""
    te = sinusoidal_embedding_1d(cfg.freq_dim, t)
    te = P.dense(params["time_embedding"]["fc1"], te,
                 compute_dtype=torch.float32)
    e = P.dense(params["time_embedding"]["fc2"], F.silu(te),
                compute_dtype=torch.float32)
    e0 = P.dense(params["time_projection"], F.silu(e),
                 compute_dtype=torch.float32).reshape(t.shape[0], 6, cfg.dim)
    return e, e0


def embed_text(params, context: torch.Tensor, policy: Policy):
    """The text context (padded to text_len upstream) -> [B, L, dim]."""
    return P.dense(params["text_embedding"]["fc2"],
                   P.gelu_tanh(P.dense(params["text_embedding"]["fc1"],
                                       context.to(policy.compute_dtype))))


def dit_head(params, cfg: WanDiTConfig, hN, e, grid, split=None,
             mesh=None):
    """The head: modulated norm, then the output projection (bf16-stored
    weights under an fp32 request take the hi/lo split in P.dense);
    [B, L, dim] -> [B, out_dim, F, H, W] fp32. Under a ``split`` the
    projected tokens are gathered from every rank first (their 2-D blocks
    by ``gather_cp_2d`` under the 2-D split)."""
    b = hN.shape[0]
    hm = params["head"]["modulation"].float() + e[:, None]
    sh, sc = hm[:, 0].reshape(b, 1, cfg.dim), hm[:, 1].reshape(b, 1, cfg.dim)
    hN = P.layer_norm({}, hN, eps=cfg.eps, out_dtype=torch.float32)
    hN = hN * (1.0 + sc) + sh
    out = P.dense(params["head"]["head"], hN, compute_dtype=torch.float32)
    if uses_cp2d(mesh):
        f, hh, ww = grid
        blk = (b, f, hh // mesh.shape[AXIS_SP_H], ww // mesh.shape[AXIS_SP_W],
               -1)
        out = gather_cp_2d(out.reshape(blk), mesh).reshape(b, f * hh * ww,
                                                           -1)
    elif split is not None:
        out = split.gather(out)
    return unpatchify(out, grid, cfg.patch_size, cfg.out_dim).float()


# ------------------------------------------------------------------ forward


def wan_dit_forward(params, cfg: WanDiTConfig, x, t, context,
                    clip_fea=None, y=None,
                    policy: Policy = DEFAULT_POLICY,
                    remat: bool = False, mesh=None, token_chunk: int = 1):
    """Full WanModel forward.

    x: [B, 16, F, H, W] noisy latents; y: [B, 20, F, H, W] i2v conditioning
    (mask 4ch + first-frame latents 16ch) concatenated on channels.
    t: [B] timesteps. context: [B, text_len, text_dim] padded text embeds.
    clip_fea: [B, 257, 1280] CLIP image tokens (i2v).
    Returns [B, out_dim, F, H, W] fp32. ``remat``: recompute each block in
    the backward pass instead of keeping its activations (the output is the
    same bit for bit). ``mesh``: the parallel layer (module docstring);
    every rank passes the global inputs and gets the global output. The
    heads must divide over ``sp`` (Ulysses) and the token grid over
    ``sp_h`` x ``sp_w``, as in JAX. ``token_chunk``: the FFN over that many
    token chunks, ignored under a mesh.
    """
    if y is not None:
        x = torch.cat([x, y], dim=1)
    batch = x.shape[0]
    pt, ph, pw = cfg.patch_size
    grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
    f, hh, ww = grid
    split = None
    if mesh is not None:
        params = gather_params(params, mesh, skip=("blocks",))
        x, t, context, clip_fea = (split_batch(a, mesh, batch)
                                   for a in (x, t, context, clip_fea))
        if uses_cp2d(mesh):
            split = grid_split(mesh, grid, x.device)
        elif sp_size(mesh) > 1:
            split = TokenSplit(f * hh * ww, mesh, (AXIS_SP,),
                               device=x.device)
        token_chunk = 1

    tokens = patchify(x.to(policy.compute_dtype), cfg.patch_size)
    if uses_cp2d(mesh):
        tokens = split_cp_2d(tokens.reshape(x.shape[0], f, hh, ww, -1),
                             mesh).reshape(x.shape[0], -1, tokens.shape[-1])
    elif split is not None:
        tokens = split.split(tokens)
    h0 = P.dense(params["patch_embedding"], tokens,
                 compute_dtype=policy.compute_dtype)
    e, e0 = embed_time(params, cfg, t)
    ctx = embed_text(params, context, policy)
    img_ctx_len = 0
    if clip_fea is not None and cfg.model_type in ("i2v", "flf2v"):
        ie = params["img_emb"]
        if "emb_pos" in ie:
            clip_fea = clip_fea.float() + ie["emb_pos"].float()
        ci = P.layer_norm(ie["norm_in"], clip_fea.to(policy.compute_dtype),
                          eps=1e-5)
        ci = F.gelu(P.dense(ie["fc1"], ci.to(policy.compute_dtype)))
        ci = P.dense(ie["fc2"], ci)
        ci = P.layer_norm(ie["norm_out"], ci, eps=1e-5)
        ctx = torch.cat([ci, ctx], dim=1)
        img_ctx_len = clip_fea.shape[1]

    if uses_cp2d(mesh):
        cos, sin = rope_rows_2d(mesh, grid, cfg.head_dim, x.device)
    else:
        cos, sin = rope_cos_sin(f, hh, ww, cfg.head_dim, device=x.device)
        if split is not None:
            cos, sin = split.split(cos, 0), split.split(sin, 0)

    hN = h0.float()
    for layer in params["blocks"]:
        args = (layer, cfg, hN, e0, ctx, cos, sin, img_ctx_len, policy,
                mesh, split, token_chunk)
        if remat:
            hN = torch.utils.checkpoint.checkpoint(
                wan_dit_layer_forward, *args, use_reentrant=False)
        else:
            hN = wan_dit_layer_forward(*args)

    return gather_batch(dit_head(params, cfg, hN, e, grid, split, mesh), mesh,
                        batch)
