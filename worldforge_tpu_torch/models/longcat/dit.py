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

Under a ``mesh`` (``core/mesh.py``) the batch is cut on ``dp`` and the
tokens, after the patch embedding, on ``sp``; the per-frame modulations
take each row's frame, each rank rotates its own RoPE rows, and the output
is gathered after the final layer. Self-attention runs Ulysses
(``parallel/ulysses.py``) when the heads divide over ``sp``, else every
rank gathers the keys for its own queries (JAX falls back to unsharded
attention there); with BSA on, the tokens are cut in BSA's chunk order and
attend through the block-sparse ring (``parallel/bsa_cp.py``, kernel 5
with ``return_lse``). The vc pair keeps the cond tokens' cache
sequence-sharded. FSDP-sharded trees (``parallel/sharding.py``) are
gathered a block at a time. ``token_chunk`` > 1 runs the QKV prologue and
the FFN over token chunks (exact math, smaller transients), ignored under
a mesh, as in JAX.
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
from worldforge_tpu_torch.core.mesh import (AXIS_SP, TokenSplit,
                                            gather_batch, split_batch,
                                            sp_size)
from worldforge_tpu_torch.models.wan.dit import patchify, unpatchify
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.bsa import CHUNK_Q, bsa_attention_3d
from worldforge_tpu_torch.ops.quant import quantize_tree
from worldforge_tpu_torch.ops.rope import (apply_rope, apply_rope_qk,
                                           rope_cos_sin)
from worldforge_tpu_torch.parallel.bsa_cp import (block_order,
                                                  bsa_attention_3d_cp)
from worldforge_tpu_torch.parallel.sharding import gather_params
from worldforge_tpu_torch.parallel.ulysses import ulysses_attention


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


def _modulate_per_frame(x, shift, scale, T, eps, frames=None):
    """LN (no affine, fp32) then * (1 + scale) + shift per frame.
    x: [B, N, C]; shift / scale: [B, T, C]. ``frames``: each row's frame
    (a ``TokenSplit``'s rows), else the rows are T equal frames."""
    b, n, c = x.shape
    xf = P.layer_norm({}, x.float(), eps=eps, out_dtype=torch.float32)
    if frames is not None:
        return xf * (1.0 + scale[:, frames]) + shift[:, frames]
    xf = xf.reshape(b, T, n // T, c)
    y = xf * (1.0 + scale[:, :, None]) + shift[:, :, None]
    return y.reshape(b, n, c)


def _gated(g, y, T, frames=None):
    """The per-frame gate g [B, T, C] on rows y [B, N, C] (fp32)."""
    if frames is not None:
        return g[:, frames] * y
    b, n, c = y.shape
    return (g[:, :, None] * y.reshape(b, T, n // T, c)).reshape(b, n, c)


def _chunked(fn, token_chunk, *xs):
    """``fn`` over ``token_chunk`` chunks of the token axis of each x
    (dim 1 of [B, N, ...], dim 0 of the [N, D/2] RoPE tables), its
    outputs concatenated: row for row the same math, with smaller
    transients. One call when the chunks do not divide N."""
    n = xs[0].shape[1]
    if token_chunk <= 1 or n % token_chunk:
        return fn(*xs)
    parts = [fn(*args) for args in zip(*(
        x.chunk(token_chunk, dim=1 if x.dim() > 2 else 0) for x in xs))]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


def _qkv_prologue(p, cfg, x_m, cos, sin, cdt, token_chunk: int = 1):
    """QKV projection + head-dim RMSNorm + RoPE -> q, k, v in ``cdt``;
    ``token_chunk`` > 1 runs it over token chunks."""
    h = cfg.num_heads

    def pro(xc, cos_c, sin_c):
        qkv = P.dense(p["qkv"], xc.to(cdt))
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        q = _rms_hd(p["q_norm"], _heads_hd(q, h), cfg.eps)
        k = _rms_hd(p["k_norm"], _heads_hd(k, h), cfg.eps)
        q, k = apply_rope_qk(q, k, cos_c, sin_c, out_dtype=cdt)
        return q, k, _heads_hd(v, h)

    return _chunked(pro, token_chunk, x_m, cos, sin)


def _bsa_on(bsa_params, grid3d) -> bool:
    return bsa_params is not None and grid3d is not None and grid3d[0] > 1


def _check_bsa_grid(bsa_params, tq, tk):
    ct = bsa_params.get("chunk_3d_shape_q", (4, 4, 8))[0]
    if tq % ct or tk % ct:
        raise ValueError(
            f"BSA needs the temporal grid divisible by the chunk t ({ct}); "
            f"got Tq={tq}, Tk={tk}. The refine pipeline pads latents to "
            f"4-multiples; BSA cannot combine with cond-latent splitting "
            f"(the reference never does).")


def _attend(attn, q, k, v, nc):
    """Self-attention over full sequences; with ``nc`` cond tokens in
    front, the cond tokens attend only to cond, the noise tokens to all."""
    if not nc:
        return attn(q, k, v)
    o_cond = attn(q[:, :nc], k[:, :nc], v[:, :nc])
    o_noise = attn(q[:, nc:], k, v)
    return torch.cat([o_cond, o_noise], dim=1)


def _self_attention_lc(p, cfg, x_m, cos, sin, T, num_cond_latents,
                       policy, grid3d=None, bsa_params=None,
                       token_chunk: int = 1, mesh=None, split=None):
    """Under a ``split`` x_m holds this rank's tokens: Ulysses when the
    heads divide over the ranks, block-sparse ring CP when BSA is on (the
    split then cuts the chunk-contiguous order), else every rank gathers
    the keys and attends from its own queries."""
    b, n, c = x_m.shape
    cdt = policy.compute_dtype
    q, k, v = _qkv_prologue(p, cfg, x_m, cos, sin, cdt, token_chunk)
    n_glob = split.n if split is not None else n
    nc = num_cond_latents * (n_glob // T) if num_cond_latents else 0

    if _bsa_on(bsa_params, grid3d):
        if split is not None:
            if nc:
                raise ValueError("BSA context parallelism cannot combine "
                                 "with cond-latent splitting")
            o = bsa_attention_3d_cp(
                q, k, v, mesh=mesh, sparsity=bsa_params.get("sparsity",
                                                            0.875),
                cdf_threshold=bsa_params.get("cdf_threshold"))
            return P.dense(p["attn_proj"], o.reshape(b, n, c).to(cdt))

        def attn(q_, k_, v_):
            tq = q_.shape[1] // (grid3d[1] * grid3d[2])
            tk = k_.shape[1] // (grid3d[1] * grid3d[2])
            _check_bsa_grid(bsa_params, tq, tk)
            return bsa_attention_3d(q_, k_, v_, (tq, grid3d[1], grid3d[2]),
                                    (tk, grid3d[1], grid3d[2]), **bsa_params)
    else:
        attn = attention

    if split is None:
        o = _attend(attn, q, k, v, nc)
    elif cfg.num_heads % split.size == 0:
        o = split.from_heads(_attend(attn, split.to_heads(q),
                                     split.to_heads(k), split.to_heads(v),
                                     nc))
    else:
        kf, vf = split.gather_keys(k), split.gather_keys(v)
        o = attn(q, kf, vf)
        cond = (split.index < nc).nonzero()[:, 0]
        if cond.numel():
            # this rank's cond rows attend to the cond keys only
            o = o.index_copy(1, cond, attn(q[:, cond], kf[:, :nc],
                                           vf[:, :nc]))
    return P.dense(p["attn_proj"], o.reshape(b, n, c).to(cdt))


def _cross_attention_lc(p, cfg, x, ctx, kv_lens, T, num_cond_latents,
                        policy, split=None):
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

    if num_cond_latents and split is not None:
        # row by row the same math: the cond rows are computed and zeroed
        nc = num_cond_latents * (split.n // T)
        return run(x) * (split.index >= nc)[None, :, None]
    if num_cond_latents:
        nc = num_cond_latents * (n // T)
        o_noise = run(x[:, nc:])
        return torch.cat([torch.zeros((b, nc, c), dtype=o_noise.dtype,
                                      device=o_noise.device), o_noise], dim=1)
    return run(x)


def swiglu_ffn(p, x_m, token_chunk: int = 1):
    """SwiGLU FFN: w2(silu(w1 x) * w3 x), over ``token_chunk`` token
    chunks when that divides the tokens."""
    def ffn(xc):
        return P.dense(p["w2"], F.silu(P.dense(p["w1"], xc))
                       * P.dense(p["w3"], xc))

    return _chunked(ffn, token_chunk, x_m)


def _embed_t(params, cfg: LongCatDiTConfig, timestep, b: int, nt: int):
    te = timestep_embedding(timestep.reshape(-1),
                            cfg.frequency_embedding_size)
    te = P.dense(params["t_embedder"]["fc1"], te, compute_dtype=torch.float32)
    te = P.dense(params["t_embedder"]["fc2"], F.silu(te),
                 compute_dtype=torch.float32)
    return te.reshape(b, nt, cfg.adaln_tembed_dim)


def _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt, frames=None,
                  token_chunk: int = 1):
    x_m2 = _modulate_per_frame(xf, sh_f, sc_f, nt, cfg.eps, frames).to(cdt)
    ff = swiglu_ffn(layer, x_m2, token_chunk).float()
    return xf + _gated(g_f, ff, nt, frames)


def _frames(split, T):
    """Each local row's frame under a ``split`` (None without one)."""
    return None if split is None else split.frames(split.n // T)


def longcat_layer_forward(p, cfg: LongCatDiTConfig, x, t_emb, ctx, kv_lens,
                          cos, sin, T: int, num_cond_latents: int = 0,
                          policy: Policy = DEFAULT_POLICY, grid3d=None,
                          bsa_params=None, token_chunk: int = 1, mesh=None,
                          split=None):
    """x: [B, N, C] fp32 stream (this rank's rows under a ``split``);
    t_emb: [B, T, adaln_dim] fp32; ctx: [B, M, C]. An FSDP-sharded block
    is gathered first."""
    p = gather_params(p, mesh)
    frames = _frames(split, T)
    mod = P.dense(p["adaln"], F.silu(t_emb.float()),
                  compute_dtype=torch.float32)
    sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)  # [B,T,C]

    xf = x.float()
    x_m = _modulate_per_frame(xf, sh_a, sc_a, T, cfg.eps, frames)
    y = _self_attention_lc(p, cfg, x_m.to(policy.compute_dtype), cos, sin,
                           T, num_cond_latents, policy, grid3d, bsa_params,
                           token_chunk, mesh, split)
    xf = xf + _gated(g_a, y.float(), T, frames)

    h2 = P.layer_norm(p["pre_crs_norm"], xf, eps=cfg.eps,
                      out_dtype=policy.compute_dtype)
    xf = xf + _cross_attention_lc(p, cfg, h2, ctx, kv_lens, T,
                                  num_cond_latents, policy, split).float()

    return _ffn_residual(p, cfg, xf, sh_f, sc_f, g_f, T, policy.compute_dtype,
                         frames, token_chunk)


def _token_split(mesh, grid3d, dev, bsa_params=None):
    """The forward's ``TokenSplit`` on ``sp`` (None below 2 ranks): the
    raster order, or BSA's chunk order when BSA is on (whole chunks a
    rank, as JAX's ring CP requires)."""
    if sp_size(mesh) <= 1:
        return None
    n = grid3d[0] * grid3d[1] * grid3d[2]
    order = None
    if _bsa_on(bsa_params, grid3d):
        chunk = tuple(bsa_params.get("chunk_3d_shape_q", (4, 4, 8)))
        if tuple(bsa_params.get("chunk_3d_shape_k", chunk)) != chunk:
            raise ValueError("BSA context parallelism needs one chunk shape "
                             "for q and k")
        _check_bsa_grid(bsa_params, grid3d[0], grid3d[0])
        if (n // CHUNK_Q) % sp_size(mesh):
            raise ValueError(f"BSA context parallelism: {n // CHUNK_Q} "
                             f"chunks do not divide over sp="
                             f"{sp_size(mesh)}")
        order = block_order(grid3d, chunk, dev)
    return TokenSplit(n, mesh, (AXIS_SP,), order=order, device=dev)


def _rope_rows(cos, sin, split):
    if split is None:
        return cos, sin
    return split.split(cos, 0), split.split(sin, 0)


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
    is the same bit for bit). ``mesh``: the parallel layer (module
    docstring); every rank passes the global inputs and gets the global
    output. ``token_chunk`` > 1: the QKV prologue and the FFN over that
    many token chunks (exact math), ignored under a mesh."""
    b, _, T, H, W = hidden_states.shape
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    cdt = policy.compute_dtype
    dev = hidden_states.device

    if timestep.ndim == 1:
        timestep = timestep[:, None].expand(b, nt)
    split = None
    if mesh is not None:
        params = gather_params(params, mesh, skip=("blocks",))
        hidden_states, timestep, encoder_hidden_states, \
            encoder_attention_mask = (
                split_batch(a, mesh, b) for a in (
                    hidden_states, timestep, encoder_hidden_states,
                    encoder_attention_mask))
        split = _token_split(mesh, (nt, nh, nw), dev, bsa_params)
        token_chunk = 1
    bl = hidden_states.shape[0]

    tokens = patchify(hidden_states.to(cdt), cfg.patch_size)
    if split is not None:
        tokens = split.split(tokens)
    x = P.dense(params["x_embedder"], tokens, compute_dtype=cdt)

    t_emb = _embed_t(params, cfg, timestep.to(dev), bl, nt)

    ctx = P.dense(params["y_embedder"]["fc2"], P.gelu_tanh(
        P.dense(params["y_embedder"]["fc1"], encoder_hidden_states.to(cdt))))
    kv_lens = (encoder_attention_mask.sum(dim=1).to(torch.int32)
               if encoder_attention_mask is not None else None)

    cos, sin = _rope_rows(*rope_cos_sin(nt, nh, nw, cfg.head_dim,
                                        device=dev), split)

    xN = x.float()
    for layer in params["blocks"]:
        args = (layer, cfg, xN, t_emb, ctx, kv_lens, cos, sin, nt,
                num_cond_latents, policy, (nt, nh, nw), bsa_params,
                token_chunk, mesh, split)
        if remat:
            xN = torch.utils.checkpoint.checkpoint(
                longcat_layer_forward, *args, use_reentrant=False)
        else:
            xN = longcat_layer_forward(*args)
    return gather_batch(_final_layer(params, cfg, xN, t_emb, (nt, nh, nw),
                                     split), mesh, b)


def _final_layer(params, cfg, xN, t_emb, grid, split=None):
    """The per-frame modulated LN and linear (the bf16-stored linear under
    an fp32 request takes the hi/lo split in P.dense), the tokens gathered
    under a ``split``, unpatchified to [B, C_out, T, H, W] fp32."""
    fmod = P.dense(params["final"]["adaln"], F.silu(t_emb.float()),
                   compute_dtype=torch.float32)
    sh, sc = torch.chunk(fmod, 2, dim=-1)
    xN = _modulate_per_frame(xN, sh, sc, grid[0], cfg.eps,
                             _frames(split, grid[0]))
    out = P.dense(params["final"]["linear"], xN, compute_dtype=torch.float32)
    if split is not None:
        out = split.gather(out)
    return unpatchify(out, grid, cfg.patch_size, cfg.out_channels).float()


# ----------------------------------------------------------- KV cache


def _cache_split(mesh, cfg, n, dev):
    """The vc pair's split of n tokens on ``sp``: Ulysses when the heads
    divide over the ranks (JAX's condition), else none (every rank runs
    the whole sequence)."""
    sp = sp_size(mesh)
    if sp <= 1 or cfg.num_heads % sp:
        return None
    return TokenSplit(n, mesh, (AXIS_SP,), device=dev)


@torch.inference_mode()
def longcat_dit_cache_cond(params, cfg: LongCatDiTConfig, cond_latents,
                           policy: Policy = DEFAULT_POLICY,
                           cache_dtype=torch.float32, mesh=None):
    """Run the DiT over the clean cond latents only (timestep 0, no
    cross-attention) and return each layer's (k, v) of the cond tokens,
    post-QK-norm and pre-RoPE: a list over layers of [2, B, Sc, H, D] in
    ``cache_dtype``. fp32 is exact; bf16 halves the cache and rounds k
    before its RoPE. Under a ``mesh`` with ``sp`` > 1 (heads dividing over
    it) the cache is sequence-sharded: each rank keeps its rows of the
    cond tokens (``TokenSplit(Sc)``, padded at the end), the layout
    ``longcat_dit_forward_with_cache`` takes under the same mesh."""
    b, _, T, H, W = cond_latents.shape
    pt, ph, pw = cfg.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    cdt = policy.compute_dtype
    dev = cond_latents.device
    h = cfg.num_heads
    split = None
    if mesh is not None:
        params = gather_params(params, mesh, skip=("blocks",))
        cond_latents = split_batch(cond_latents, mesh, b)
        split = _cache_split(mesh, cfg, nt * nh * nw, dev)
    bl = cond_latents.shape[0]
    frames = _frames(split, nt)

    tokens = patchify(cond_latents.to(cdt), cfg.patch_size)
    if split is not None:
        tokens = split.split(tokens)
    x = P.dense(params["x_embedder"], tokens, compute_dtype=cdt)
    t_emb = _embed_t(params, cfg, torch.zeros((bl * nt,), device=dev), bl,
                     nt)
    cos, sin = _rope_rows(*rope_cos_sin(nt, nh, nw, cfg.head_dim,
                                        device=dev), split)

    xf = x.float()
    cache = []
    for layer in params["blocks"]:
        layer = gather_params(layer, mesh)
        mod = P.dense(layer["adaln"], F.silu(t_emb),
                      compute_dtype=torch.float32)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)
        x_m = _modulate_per_frame(xf, sh_a, sc_a, nt, cfg.eps,
                                  frames).to(cdt)
        q, k, v = torch.chunk(P.dense(layer["qkv"], x_m), 3, dim=-1)
        q = _rms_hd(layer["q_norm"], _heads_hd(q, h), cfg.eps)
        k = _rms_hd(layer["k_norm"], _heads_hd(k, h), cfg.eps)
        v_h = _heads_hd(v, h)
        cache.append(torch.stack([k.to(cache_dtype), v_h.to(cache_dtype)]))
        # continue the forward so later layers cache the right activations
        qr, kr = apply_rope_qk(q, k, cos, sin, out_dtype=cdt)
        o = ulysses_attention(qr, kr, v_h.to(cdt), mesh=None, split=split)
        o = P.dense(layer["attn_proj"],
                    o.reshape(bl, xf.shape[1], cfg.hidden_size).to(cdt))
        xf = xf + _gated(g_a, o.float(), nt, frames)
        # no cross-attention while caching
        xf = _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt, frames)
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
    Under a ``mesh`` with ``sp`` > 1 the noise tokens and the cache are
    both sequence-sharded (the cache as ``longcat_dit_cache_cond`` made it
    under the same mesh); Ulysses gathers q over the noise tokens and k / v
    over cache || noise."""
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
    split = csplit = None
    if mesh is not None:
        params = gather_params(params, mesh, skip=("blocks",))
        hidden_states, timestep, encoder_hidden_states, \
            encoder_attention_mask = (
                split_batch(a, mesh, b) for a in (
                    hidden_states, timestep, encoder_hidden_states,
                    encoder_attention_mask))
        split = _cache_split(mesh, cfg, nt * nh * nw, dev)
        csplit = _cache_split(mesh, cfg, n_cond, dev)
    bl = hidden_states.shape[0]
    frames = _frames(split, nt)

    tokens = patchify(hidden_states.to(cdt), cfg.patch_size)
    if split is not None:
        tokens = split.split(tokens)
    x = P.dense(params["x_embedder"], tokens, compute_dtype=cdt)
    t_emb = _embed_t(params, cfg, timestep.to(dev), bl, nt)
    ctx = P.dense(params["y_embedder"]["fc2"], P.gelu_tanh(
        P.dense(params["y_embedder"]["fc1"], encoder_hidden_states.to(cdt))))
    kv_lens = (encoder_attention_mask.sum(dim=1).to(torch.int32)
               if encoder_attention_mask is not None else None)

    cos_full, sin_full = rope_cos_sin(tc + nt, nh, nw, cfg.head_dim,
                                      device=dev)
    cos_c, sin_c = _rope_rows(cos_full[:n_cond], sin_full[:n_cond], csplit)
    cos_q, sin_q = _rope_rows(cos_full[n_cond:], sin_full[n_cond:], split)

    xf = x.float()
    for layer, kv in zip(params["blocks"], kv_cache):
        layer = gather_params(layer, mesh)
        mod = P.dense(layer["adaln"], F.silu(t_emb),
                      compute_dtype=torch.float32)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)
        x_m = _modulate_per_frame(xf, sh_a, sc_a, nt, cfg.eps,
                                  frames).to(cdt)
        q, k, v = torch.chunk(P.dense(layer["qkv"], x_m), 3, dim=-1)
        q = _rms_hd(layer["q_norm"], _heads_hd(q, h), cfg.eps)
        k = _rms_hd(layer["k_norm"], _heads_hd(k, h), cfg.eps)
        v_h = _heads_hd(v, h).to(cdt)
        q = apply_rope(q, cos_q, sin_q, out_dtype=cdt)
        if split is None:
            k_full = torch.cat([kv[0].float(), k], dim=1)
            v_full = torch.cat([kv[1].to(cdt), v_h], dim=1)
            k_full = apply_rope(k_full, cos_full, sin_full, out_dtype=cdt)
            o = attention(q, k_full, v_full)
        else:
            k_c = apply_rope(kv[0].float(), cos_c, sin_c, out_dtype=cdt)
            k_n = apply_rope(k, cos_q, sin_q, out_dtype=cdt)
            k_full = torch.cat([csplit.to_heads(k_c), split.to_heads(k_n)],
                               dim=1)
            v_full = torch.cat([csplit.to_heads(kv[1].to(cdt)),
                                split.to_heads(v_h)], dim=1)
            o = split.from_heads(attention(split.to_heads(q), k_full,
                                           v_full))
        o = P.dense(layer["attn_proj"],
                    o.reshape(bl, xf.shape[1], cfg.hidden_size).to(cdt))
        xf = xf + _gated(g_a, o.float(), nt, frames)

        h2 = P.layer_norm(layer["pre_crs_norm"], xf, eps=cfg.eps,
                          out_dtype=cdt)
        xf = xf + _cross_attention_lc(layer, cfg, h2, ctx, kv_lens, nt, 0,
                                      policy).float()
        xf = _ffn_residual(layer, cfg, xf, sh_f, sc_f, g_f, nt, cdt, frames)
    return gather_batch(_final_layer(params, cfg, xf, t_emb, (nt, nh, nw),
                                     split), mesh, b)


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
