"""LongCat-Video 13.6B single-stream DiT in PyTorch.

Counterpart of ``worldforge_tpu/models/longcat/dit.py`` (same config, param
layout and numerics policy):

  - hidden 4096, depth 48, heads 32, patch (1, 2, 2), caption 4096
  - per-frame timestep adaLN: t [B, T] -> embedder [B, T, 512]; each
    block's adaLN Linear(512 -> 6 * 4096) in fp32; shift / scale / gate
    applied per frame over x viewed [B, T, HW, C]
  - self-attention: fused qkv, head-dim RMSNorm on q/k (fp32), 3D RoPE;
    with cond latents the cond tokens attend only to cond, the noise
    tokens to all
  - cross-attention: q + fused kv, head-dim RMSNorm, variable text length
    through ``kv_lens``; with cond latents the cond tokens get zeros
  - SwiGLU FFN with hidden 256 * ceil(2 * 4 * C / 3 / 256) = 11008
  - final layer: per-frame modulated LN + linear
The blocks are a list of per-layer dicts run by a Python loop where the JAX
package stacks them for ``lax.scan`` (``io/from_jax.py`` unstacks a JAX
tree), so the random init builds one layer at a time on the device and the
13.6B model never exists twice.

``longcat_dit_cache_cond`` and ``longcat_dit_forward_with_cache`` are the
video-continuation pair: one pass over the clean cond latents caches each
layer's post-norm, pre-RoPE k and v, and every denoise step then runs the
noise latents only, attending to [cached cond k/v ; noise k/v] with RoPE
applied over the joint (T_cond + T) grid.

Kernels on this path (CUDA tensors launch them; CPU tensors take each
kernel's plain version):
  - q/k RoPE -> ``ops/rope.apply_rope_qk`` (kernel 2; fp32 q/k in, the
    compute dtype out),
  - self-attention -> block-sparse attention ``ops/bsa.bsa_attention_3d``
    (kernel 5) when ``bsa_params`` is set and the grid allows it, else
    flash attention (kernel 1),
  - cross-attention -> flash attention with ``kv_lens`` (kernel 1),
  - the cache pass's self-attention and the cached step's attention over
    [cond ; noise] -> flash attention (kernel 1); the cached step rotates
    q and the joint k with the plain ``apply_rope`` (their lengths differ),
    as the JAX package does.
The per-frame modulation is a plain LayerNorm: its [B, T, C] shift and scale
are not the per-(batch, channel) modulation of kernel 3, and the JAX package
never calls that kernel here. Matrix products are ``torch.matmul``.

LoRA adapters are merged into the weights (``merge_lora`` /
``unmerge_lora`` here, ``io/convert_longcat.py::merge_lora_stacked`` for a
converted checkpoint's). Quantized trees (``init_longcat_dit_int8`` /
``init_longcat_dit_w4``) and unmerged adapters over them
(``training/lora.py::apply_lora``) run through ``core/params.dense``.
``longcat_dit_forward`` is differentiable (training through
``training/step.py::longcat_forward``): on CUDA tensors the gradients go
through the backward kernels of kernels 1 and 2 (and BSA's gathered
recompute when ``bsa_params`` is set), and ``remat=True`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, JAX's
``jax.checkpoint`` around the scan body). The cache pair is inference-only.
Left for later slices: meshes and ``token_chunk`` > 1
(``longcat_dit_forward`` raises).
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
from worldforge_tpu_torch.models.wan.dit import patchify, unpatchify
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.bsa import bsa_attention_3d
from worldforge_tpu_torch.ops.quant import quantize_tree
from worldforge_tpu_torch.ops.rope import (apply_rope, apply_rope_qk,
                                           rope_cos_sin)


@dataclasses.dataclass(frozen=True)
class LongCatDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 4096
    depth: int = 48
    num_heads: int = 32
    caption_channels: int = 4096
    mlp_ratio: int = 4
    adaln_tembed_dim: int = 512
    frequency_embedding_size: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        h = int(2 * (self.hidden_size * self.mlp_ratio) / 3)
        return 256 * ((h + 255) // 256)

    @classmethod
    def longcat_13b(cls) -> "LongCatDiTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LongCatDiTConfig":
        return cls(hidden_size=64, depth=2, num_heads=2, caption_channels=32,
                   adaln_tembed_dim=32, frequency_embedding_size=16)


# ------------------------------------------------------------------ init


def init_longcat_layer(gen: torch.Generator, cfg: LongCatDiTConfig,
                       dtype=torch.float32) -> dict:
    c = cfg.hidden_size
    hd = cfg.head_dim
    dev = gen.device
    return {
        "adaln": P.dense_init(gen, cfg.adaln_tembed_dim, 6 * c,
                              dtype=torch.float32),
        "qkv": P.dense_init(gen, c, 3 * c, dtype=dtype),
        "q_norm": P.rms_norm_init(hd, device=dev),
        "k_norm": P.rms_norm_init(hd, device=dev),
        "attn_proj": P.dense_init(gen, c, c, dtype=dtype),
        "pre_crs_norm": P.layer_norm_init(c, dtype=dtype, device=dev),
        "x_q": P.dense_init(gen, c, c, dtype=dtype),
        "x_kv": P.dense_init(gen, c, 2 * c, dtype=dtype),
        "x_q_norm": P.rms_norm_init(hd, device=dev),
        "x_k_norm": P.rms_norm_init(hd, device=dev),
        "x_proj": P.dense_init(gen, c, c, dtype=dtype),
        "w1": P.dense_init(gen, c, cfg.ffn_hidden, bias=False, dtype=dtype),
        "w3": P.dense_init(gen, c, cfg.ffn_hidden, bias=False, dtype=dtype),
        "w2": P.dense_init(gen, cfg.ffn_hidden, c, bias=False, dtype=dtype),
    }


def init_longcat_dit(gen: torch.Generator, cfg: LongCatDiTConfig,
                     dtype=torch.bfloat16) -> dict:
    """Random init on ``gen.device``, one layer at a time (the JAX init's
    shapes, dtypes and distributions; a torch.Generator draws other numbers
    than a JAX key)."""
    return init_longcat_dit_layerwise(gen, cfg, dtype)


def init_longcat_dit_layerwise(gen: torch.Generator, cfg: LongCatDiTConfig,
                               dtype=torch.bfloat16,
                               layer_transform=None) -> dict:
    """The DiT built one layer at a time on ``gen.device``, each layer
    passed through ``layer_transform(tree) -> tree`` as it is made (the
    peak is the transformed model plus one untransformed layer), then the
    embedders and the final layer, transformed once. The draws run in the
    same order with or without a transform (the blocks, then the
    embedders and the final layer), so a transformed build equals the
    transform of ``init_longcat_dit`` from a generator in the same
    state."""
    tf = layer_transform or (lambda t: t)
    c = cfg.hidden_size
    pin = cfg.in_channels * math.prod(cfg.patch_size)
    p = {
        "blocks": [tf(init_longcat_layer(gen, cfg, dtype))
                   for _ in range(cfg.depth)],
        "x_embedder": P.dense_init(gen, pin, c, dtype=dtype),
        "t_embedder": {
            "fc1": P.dense_init(gen, cfg.frequency_embedding_size,
                                cfg.adaln_tembed_dim, dtype=torch.float32),
            "fc2": P.dense_init(gen, cfg.adaln_tembed_dim,
                                cfg.adaln_tembed_dim, dtype=torch.float32),
        },
        "y_embedder": {
            "fc1": P.dense_init(gen, cfg.caption_channels, c, dtype=dtype),
            "fc2": P.dense_init(gen, c, c, dtype=dtype),
        },
        "final": {
            "adaln": P.dense_init(gen, cfg.adaln_tembed_dim, 2 * c,
                                  dtype=torch.float32),
            "linear": P.dense_init(gen, c, math.prod(cfg.patch_size)
                                   * cfg.out_channels, dtype=dtype),
        },
    }
    if layer_transform is None:
        return p
    return dict(tf(dict(p, blocks=[])), blocks=p["blocks"])


def init_longcat_dit_int8(gen: torch.Generator, cfg: LongCatDiTConfig,
                          dtype=torch.bfloat16) -> dict:
    """W8A8 build, layer by layer (per-block adaLN weights in bf16)."""
    return init_longcat_dit_layerwise(gen, cfg, dtype,
                                      layer_transform=quantize_tree)


def init_longcat_dit_w4(gen: torch.Generator, cfg: LongCatDiTConfig,
                        dtype=torch.bfloat16, int4_keys=("*",),
                        int4_group: int = 128, int6_keys=(),
                        int6_group: int = 128) -> dict:
    """int4 (W4A8) build, all-int4 by default; ``int6_keys`` takes the
    6-bit rung first (see ``wan.dit.init_wan_dit_w4``)."""
    return init_longcat_dit_layerwise(
        gen, cfg, dtype, layer_transform=functools.partial(
            quantize_tree, int4_keys=int4_keys, int4_group=int4_group,
            int6_keys=int6_keys, int6_group=int6_group))


# ------------------------------------------------------------------ pieces


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """DiT sinusoidal embedding: exp(-log(P) * i / half) freqs, [cos | sin].
    t: [N] (fractional ok)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _heads_hd(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _rms_hd(p, x, eps):
    """Head-dim RMSNorm over the last axis of [B, S, H, D], fp32 out."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return y * p["scale"].float()


def _modulate_per_frame(x, shift, scale, T, eps):
    """LN (no affine, fp32) then * (1 + scale) + shift per frame.
    x: [B, N, C]; shift / scale: [B, T, C]."""
    b, n, c = x.shape
    xf = P.layer_norm({}, x.float(), eps=eps, out_dtype=torch.float32)
    xf = xf.reshape(b, T, n // T, c)
    y = xf * (1.0 + scale[:, :, None]) + shift[:, :, None]
    return y.reshape(b, n, c)


def _qkv_prologue(p, cfg, x_m, cos, sin, cdt):
    """QKV projection + head-dim RMSNorm + RoPE -> q, k, v in ``cdt``."""
    h = cfg.num_heads
    qkv = P.dense(p["qkv"], x_m.to(cdt))
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = _rms_hd(p["q_norm"], _heads_hd(q, h), cfg.eps)
    k = _rms_hd(p["k_norm"], _heads_hd(k, h), cfg.eps)
    q, k = apply_rope_qk(q, k, cos, sin, out_dtype=cdt)
    return q, k, _heads_hd(v, h)


def _self_attention_lc(p, cfg, x_m, cos, sin, T, num_cond_latents,
                       policy, grid3d=None, bsa_params=None):
    b, n, c = x_m.shape
    cdt = policy.compute_dtype
    q, k, v = _qkv_prologue(p, cfg, x_m, cos, sin, cdt)

    if bsa_params is not None and grid3d is not None and grid3d[0] > 1:
        def attn(q_, k_, v_):
            tq = q_.shape[1] // (grid3d[1] * grid3d[2])
            tk = k_.shape[1] // (grid3d[1] * grid3d[2])
            ct = bsa_params.get("chunk_3d_shape_q", (4, 4, 8))[0]
            if tq % ct or tk % ct:
                raise ValueError(
                    f"BSA needs the temporal grid divisible by the chunk t "
                    f"({ct}); got Tq={tq}, Tk={tk}. The refine pipeline pads "
                    f"latents to 4-multiples; BSA cannot combine with "
                    f"cond-latent splitting (the reference never does).")
            return bsa_attention_3d(q_, k_, v_, (tq, grid3d[1], grid3d[2]),
                                    (tk, grid3d[1], grid3d[2]), **bsa_params)
    else:
        attn = attention

    if num_cond_latents:
        nc = num_cond_latents * (n // T)
        # cond tokens attend only to cond; noise tokens attend to all
        o_cond = attn(q[:, :nc], k[:, :nc], v[:, :nc])
        o_noise = attn(q[:, nc:], k, v)
        o = torch.cat([o_cond, o_noise], dim=1)
    else:
        o = attn(q, k, v)
    return P.dense(p["attn_proj"], o.reshape(b, n, c).to(cdt))


def _cross_attention_lc(p, cfg, x, ctx, kv_lens, T, num_cond_latents,
                        policy):
    b, n, c = x.shape
    cdt = policy.compute_dtype
    h = cfg.num_heads

    def run(xq):
        q = _rms_hd(p["x_q_norm"], _heads_hd(P.dense(p["x_q"], xq.to(cdt)), h),
                    cfg.eps).to(cdt)
        kv = P.dense(p["x_kv"], ctx.to(cdt))
        k, v = torch.chunk(kv, 2, dim=-1)
        k = _rms_hd(p["x_k_norm"], _heads_hd(k, h), cfg.eps).to(cdt)
        o = attention(q, k, _heads_hd(v, h), kv_lens=kv_lens)
        return P.dense(p["x_proj"],
                       o.reshape(xq.shape[0], xq.shape[1], c).to(cdt))

    if num_cond_latents:
        nc = num_cond_latents * (n // T)
        o_noise = run(x[:, nc:])
        return torch.cat([torch.zeros((b, nc, c), dtype=o_noise.dtype,
                                      device=o_noise.device), o_noise], dim=1)
    return run(x)


def swiglu_ffn(p, x_m):
    """SwiGLU FFN: w2(silu(w1 x) * w3 x)."""
    return P.dense(p["w2"], F.silu(P.dense(p["w1"], x_m))
                   * P.dense(p["w3"], x_m))


def _embed_t(params, cfg: LongCatDiTConfig, timestep, b: int, nt: int):
    te = timestep_embedding(timestep.reshape(-1),
                            cfg.frequency_embedding_size)
    te = P.dense(params["t_embedder"]["fc1"], te, compute_dtype=torch.float32)
    te = P.dense(params["t_embedder"]["fc2"], F.silu(te),
                 compute_dtype=torch.float32)
    return te.reshape(b, nt, cfg.adaln_tembed_dim)


def _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt):
    x_m2 = _modulate_per_frame(xf, sh_f, sc_f, nt, cfg.eps).to(cdt)
    ff = swiglu_ffn(layer, x_m2).float().reshape(xf.shape[0], nt, -1,
                                                 cfg.hidden_size)
    return xf + (g_f[:, :, None] * ff).reshape(xf.shape)


def longcat_layer_forward(p, cfg: LongCatDiTConfig, x, t_emb, ctx, kv_lens,
                          cos, sin, T: int, num_cond_latents: int = 0,
                          policy: Policy = DEFAULT_POLICY, grid3d=None,
                          bsa_params=None):
    """x: [B, N, C] fp32 stream; t_emb: [B, T, adaln_dim] fp32;
    ctx: [B, M, C]."""
    b, n, c = x.shape
    mod = P.dense(p["adaln"], F.silu(t_emb.float()),
                  compute_dtype=torch.float32)
    sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)  # [B,T,C]

    xf = x.float()
    x_m = _modulate_per_frame(xf, sh_a, sc_a, T, cfg.eps)
    y = _self_attention_lc(p, cfg, x_m.to(policy.compute_dtype), cos, sin,
                           T, num_cond_latents, policy, grid3d, bsa_params)
    yf = y.float().reshape(b, T, n // T, c)
    xf = xf + (g_a[:, :, None] * yf).reshape(b, n, c)

    h2 = P.layer_norm(p["pre_crs_norm"], xf, eps=cfg.eps,
                      out_dtype=policy.compute_dtype)
    xf = xf + _cross_attention_lc(p, cfg, h2, ctx, kv_lens, T,
                                  num_cond_latents, policy).float()

    return _ffn_residual(p, cfg, xf, sh_f, sc_f, g_f, T, policy.compute_dtype)


# ------------------------------------------------------------------ model


def longcat_dit_forward(params, cfg: LongCatDiTConfig, hidden_states,
                        timestep, encoder_hidden_states,
                        encoder_attention_mask=None,
                        num_cond_latents: int = 0,
                        policy: Policy = DEFAULT_POLICY, mesh=None,
                        bsa_params=None, remat: bool = False,
                        token_chunk: int = 1):
    """hidden_states: [B, C_in, T, H, W]; timestep: [B] or [B, T']
    (per-frame); encoder_hidden_states: [B, M, caption];
    encoder_attention_mask: [B, M] (1 = valid). Returns [B, C_out, T, H, W]
    fp32. ``remat``: recompute each block in the backward pass (the output
    is the same bit for bit). ``mesh`` and ``token_chunk`` > 1 belong to
    later slices and raise."""
    if mesh is not None:
        raise NotImplementedError("meshes / context parallelism are not "
                                  "ported yet (a later slice of the port)")
    if token_chunk != 1:
        raise NotImplementedError("token_chunk > 1 is not ported yet (a "
                                  "later slice of the port)")
    b, _, T, H, W = hidden_states.shape
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    cdt = policy.compute_dtype
    dev = hidden_states.device

    if timestep.ndim == 1:
        timestep = timestep[:, None].expand(b, nt)

    x = P.dense(params["x_embedder"],
                patchify(hidden_states.to(cdt), cfg.patch_size),
                compute_dtype=cdt)

    t_emb = _embed_t(params, cfg, timestep.to(dev), b, nt)

    ctx = P.dense(params["y_embedder"]["fc2"], P.gelu_tanh(
        P.dense(params["y_embedder"]["fc1"], encoder_hidden_states.to(cdt))))
    kv_lens = (encoder_attention_mask.sum(dim=1).to(torch.int32)
               if encoder_attention_mask is not None else None)

    cos, sin = rope_cos_sin(nt, nh, nw, cfg.head_dim, device=dev)

    xN = x.float()
    for layer in params["blocks"]:
        args = (layer, cfg, xN, t_emb, ctx, kv_lens, cos, sin, nt,
                num_cond_latents, policy, (nt, nh, nw), bsa_params)
        if remat:
            xN = torch.utils.checkpoint.checkpoint(
                longcat_layer_forward, *args, use_reentrant=False)
        else:
            xN = longcat_layer_forward(*args)

    # final layer; the bf16-stored linear under an fp32 request takes the
    # hi/lo split in P.dense
    fmod = P.dense(params["final"]["adaln"], F.silu(t_emb.float()),
                   compute_dtype=torch.float32)
    sh, sc = torch.chunk(fmod, 2, dim=-1)
    xN = _modulate_per_frame(xN, sh, sc, nt, cfg.eps)
    out = P.dense(params["final"]["linear"], xN, compute_dtype=torch.float32)
    return unpatchify(out, (nt, nh, nw), cfg.patch_size,
                      cfg.out_channels).float()


# ----------------------------------------------------------- KV cache


@torch.inference_mode()
def longcat_dit_cache_cond(params, cfg: LongCatDiTConfig, cond_latents,
                           policy: Policy = DEFAULT_POLICY,
                           cache_dtype=torch.float32, mesh=None):
    """Run the DiT over the clean cond latents only (timestep 0, no
    cross-attention) and return each layer's (k, v) of the cond tokens,
    post-QK-norm and pre-RoPE: a list over layers of [2, B, Sc, H, D] in
    ``cache_dtype``. fp32 is exact; bf16 halves the cache and rounds k
    before its RoPE. ``mesh`` belongs to a later slice and raises."""
    if mesh is not None:
        raise NotImplementedError("meshes / context parallelism are not "
                                  "ported yet (a later slice of the port)")
    b, _, T, H, W = cond_latents.shape
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    cdt = policy.compute_dtype
    dev = cond_latents.device
    h = cfg.num_heads

    x = P.dense(params["x_embedder"],
                patchify(cond_latents.to(cdt), cfg.patch_size),
                compute_dtype=cdt)
    t_emb = _embed_t(params, cfg, torch.zeros((b * nt,), device=dev), b, nt)
    cos, sin = rope_cos_sin(nt, nh, nw, cfg.head_dim, device=dev)

    xf = x.float()
    cache = []
    for layer in params["blocks"]:
        mod = P.dense(layer["adaln"], F.silu(t_emb),
                      compute_dtype=torch.float32)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)
        x_m = _modulate_per_frame(xf, sh_a, sc_a, nt, cfg.eps).to(cdt)
        q, k, v = torch.chunk(P.dense(layer["qkv"], x_m), 3, dim=-1)
        q = _rms_hd(layer["q_norm"], _heads_hd(q, h), cfg.eps)
        k = _rms_hd(layer["k_norm"], _heads_hd(k, h), cfg.eps)
        v_h = _heads_hd(v, h)
        cache.append(torch.stack([k.to(cache_dtype), v_h.to(cache_dtype)]))
        # continue the forward so later layers cache the right activations
        qr, kr = apply_rope_qk(q, k, cos, sin, out_dtype=cdt)
        o = attention(qr, kr, v_h.to(cdt))
        o = P.dense(layer["attn_proj"],
                    o.reshape(b, xf.shape[1], cfg.hidden_size).to(cdt))
        of = o.float().reshape(b, nt, -1, cfg.hidden_size)
        xf = xf + (g_a[:, :, None] * of).reshape(xf.shape)
        # no cross-attention while caching
        xf = _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt)
    return cache


@torch.inference_mode()
def longcat_dit_forward_with_cache(params, cfg: LongCatDiTConfig,
                                   hidden_states, timestep,
                                   encoder_hidden_states, kv_cache,
                                   cond_grid, encoder_attention_mask=None,
                                   policy: Policy = DEFAULT_POLICY,
                                   mesh=None):
    """Denoise the NOISE latents [B, C, T, H, W] against the cond tokens'
    cached k/v (``longcat_dit_cache_cond``): RoPE over the joint
    (T_cond + T) grid, q at the noise positions; cross-attention on the
    noise tokens. cond_grid: (T_cond,). Returns [B, C_out, T, H, W] fp32.
    ``mesh`` belongs to a later slice and raises."""
    if mesh is not None:
        raise NotImplementedError("meshes / context parallelism are not "
                                  "ported yet (a later slice of the port)")
    b, _, T, H, W = hidden_states.shape
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    tc = cond_grid[0]
    n_cond = tc * nh * nw
    cdt = policy.compute_dtype
    dev = hidden_states.device
    h = cfg.num_heads

    if timestep.ndim == 1:
        timestep = timestep[:, None].expand(b, nt)

    x = P.dense(params["x_embedder"],
                patchify(hidden_states.to(cdt), cfg.patch_size),
                compute_dtype=cdt)
    t_emb = _embed_t(params, cfg, timestep.to(dev), b, nt)
    ctx = P.dense(params["y_embedder"]["fc2"], P.gelu_tanh(
        P.dense(params["y_embedder"]["fc1"], encoder_hidden_states.to(cdt))))
    kv_lens = (encoder_attention_mask.sum(dim=1).to(torch.int32)
               if encoder_attention_mask is not None else None)

    cos_full, sin_full = rope_cos_sin(tc + nt, nh, nw, cfg.head_dim,
                                      device=dev)
    cos_q, sin_q = cos_full[n_cond:], sin_full[n_cond:]

    xf = x.float()
    for layer, kv in zip(params["blocks"], kv_cache):
        mod = P.dense(layer["adaln"], F.silu(t_emb),
                      compute_dtype=torch.float32)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)
        x_m = _modulate_per_frame(xf, sh_a, sc_a, nt, cfg.eps).to(cdt)
        q, k, v = torch.chunk(P.dense(layer["qkv"], x_m), 3, dim=-1)
        q = _rms_hd(layer["q_norm"], _heads_hd(q, h), cfg.eps)
        k = _rms_hd(layer["k_norm"], _heads_hd(k, h), cfg.eps)
        v_h = _heads_hd(v, h)
        k_full = torch.cat([kv[0].float(), k], dim=1)
        v_full = torch.cat([kv[1].to(cdt), v_h.to(cdt)], dim=1)
        q = apply_rope(q, cos_q, sin_q, out_dtype=cdt)
        k_full = apply_rope(k_full, cos_full, sin_full, out_dtype=cdt)
        o = attention(q, k_full, v_full)
        o = P.dense(layer["attn_proj"],
                    o.reshape(b, nt * nh * nw, cfg.hidden_size).to(cdt))
        of = o.float().reshape(b, nt, -1, cfg.hidden_size)
        xf = xf + (g_a[:, :, None] * of).reshape(xf.shape)

        h2 = P.layer_norm(layer["pre_crs_norm"], xf, eps=cfg.eps,
                          out_dtype=cdt)
        xf = xf + _cross_attention_lc(layer, cfg, h2, ctx, kv_lens, nt, 0,
                                      policy).float()
        xf = _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt)

    fmod = P.dense(params["final"]["adaln"], F.silu(t_emb),
                   compute_dtype=torch.float32)
    sh, sc = torch.chunk(fmod, 2, dim=-1)
    xN = _modulate_per_frame(xf, sh, sc, nt, cfg.eps)
    out = P.dense(params["final"]["linear"], xN, compute_dtype=torch.float32)
    return unpatchify(out, (nt, nh, nw), cfg.patch_size,
                      cfg.out_channels).float()


# ------------------------------------------------------------------ LoRA


def lora_merged_weight(w: torch.Tensor, adapter: dict,
                       scale: float = 1.0) -> torch.Tensor:
    """``w + multiplier * (alpha / rank) * scale * down @ up``: the product
    and the sum in fp32 on ``w``'s device (TF32 off), the multiplications
    in the JAX package's order, rounded once to ``w``'s dtype. ``adapter``
    holds ``down`` [in, r], ``up`` [r, out] and optionally ``alpha``
    (default r) and ``multiplier`` (default 1)."""
    down = adapter["down"].to(w.device, torch.float32)
    up = adapter["up"].to(w.device, torch.float32)
    alpha_scale = adapter.get("alpha", down.shape[1]) / down.shape[1]
    with P.no_tf32_matmul():
        delta = (down @ up * adapter.get("multiplier", 1.0) * alpha_scale
                 * scale)
    return (w.float() + delta).to(w.dtype)


def merge_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """Merge additive low-rank adapters into the weights (JAX
    ``models/longcat/dit.py:703-727``; the reference toggles LoRA at run
    time by forward patching, ``longcat_video_dit.py:197-270``, and merging
    is the inference equivalent). ``lora`` maps a '/'-joined path to a
    dense param (``final/linear``) to an adapter; a path into the blocks
    (``blocks/qkv``) merges into every layer, as the JAX delta broadcasts
    over the stacked leaf. Returns a new tree sharing every leaf it does
    not change."""
    def merge(node, keys, adapter):
        if isinstance(node, list):
            return [merge(n, keys, adapter) for n in node]
        if not keys:
            return dict(node, w=lora_merged_weight(node["w"], adapter,
                                                   scale))
        return dict(node, **{keys[0]: merge(node[keys[0]], keys[1:],
                                            adapter)})

    out = params
    for path, adapter in lora.items():
        out = merge(out, path.split("/"), adapter)
    return out


def unmerge_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """``merge_lora`` with the opposite sign (JAX :729-730); equal to the
    weights before the merge up to the rounding of the two merges."""
    return merge_lora(params, lora, scale=-scale)
