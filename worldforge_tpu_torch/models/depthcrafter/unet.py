"""SVD spatio-temporal UNet (DepthCrafter's denoiser) in PyTorch.

Counterpart of ``worldforge_tpu/models/depthcrafter/unet.py`` (diffusers'
UNetSpatioTemporalConditionModel): the same config, parameter tree
(diffusers names, dense kernels ``[in, out]``, conv kernels ``HWIO`` /
``DHWIO``, blocks as lists) and channels-last math.

  - conv_in (8 -> 320); sinusoidal time embedding ([cos|sin], dim 320) ->
    MLP 1280; added_time_ids (fps, motion_bucket, noise_aug) -> 3x256
    sinusoids -> MLP 1280, summed into the timestep embedding
  - 4 down blocks (320, 640, 1280, 1280; 3 cross-attn + 1 plain), mirrored
    up blocks with skip concatenation, mid block
  - every res stage is a SpatioTemporalResBlock: spatial ResnetBlock2D +
    temporal ResnetBlock (k=(3,1,1)) blended by an AlphaBlender
  - every attention stage is a TransformerSpatioTemporalModel: a spatial
    block (self + cross + GEGLU ff) and a temporal block over frames (ff_in
    residual, self-attn over time, cross-attn to the FIRST frame's CLIP
    context, ff) with sinusoidal frame-position embeddings, blended by an
    AlphaBlender. LayerNorm eps 1e-5 there (torch's nn.LayerNorm default),
    GroupNorm eps 1e-6 before proj_in.

Kernels on this path (CUDA tensors launch them; CPU tensors take each
kernel's plain version):
  - every attention -> flash attention (kernel 1), fp32 with heads of 64:
    spatial over B*F rows of H*W tokens, temporal over B*H*W rows of F
    frames, cross-attention over the one CLIP token;
  - on the card, every stride-1 3x3 conv -> ``ops/conv3d.conv2d_3x3``
    (kernel 4 with one temporal tap; inputs rounded to bf16, fp32 sums).
The other convs (the (3,1,1) temporal convs, the 1x1 shortcuts, the stride-2
downsamplers) are XLA convs given no precision in JAX, which run bf16
operands with fp32 sums on its chip; on the card they run so too
(``P.conv(bf16_operands=True)``). On the CPU every conv stays full fp32, as
the JAX package's CPU tests run them. ``_bf16_convs`` makes that choice
for every conv of the UNet and the VAE; where it says yes on the CPU, the
CPU computes the card's conv arithmetic in plain PyTorch (the 3x3 convs
through ``conv2d_3x3``'s plain version).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.conv3d import conv2d_3x3


@dataclasses.dataclass(frozen=True)
class SVDUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    addition_time_embed_dim: int = 256
    projection_dim: int = 768  # 3 ids x 256
    transformer_layers: int = 1
    norm_eps: float = 1e-5

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def svd(cls) -> "SVDUNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SVDUNetConfig":
        return cls(block_out_channels=(8, 16, 16, 16),
                   num_attention_heads=(1, 2, 2, 2), layers_per_block=1,
                   cross_attention_dim=16, addition_time_embed_dim=8,
                   projection_dim=24)


# ---------------------------------------------------------------- pieces


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int,
                                  max_period: float = 10000.0,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0
                                  ) -> torch.Tensor:
    """diffusers Timesteps: exp(-ln(P) * i / (half - shift)) freqs;
    flip_sin_to_cos=True -> [cos | sin]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _conv(gen, cin, cout, k, dtype):
    return P.conv_init(gen, cin, cout, (k, k), dtype=dtype)


def _bf16_convs(x) -> bool:
    """Whether the convs of x round their operands to bf16: on the card."""
    return x.device.type == "cuda"


def _xla_conv(p, x, *, stride=1, padding=0):
    """A conv the JAX package leaves to XLA: bf16 operands with fp32 sums
    on the card, full fp32 on the CPU."""
    return P.conv(p, x, stride=stride, padding=padding,
                  bf16_operands=_bf16_convs(x))


def _conv2d(p, x, stride: int = 1):
    """x [N, H, W, C], kernel [k, k, in, out]: SAME for stride 1, padding 1
    for stride 2 (the UNet's downsamplers)."""
    kh = p["w"].shape[0]
    if _bf16_convs(x) and stride == 1 and kh == 3:
        return conv2d_3x3(x, p["w"], p.get("b"), out_dtype=x.dtype)
    return _xla_conv(p, x, stride=stride,
                     padding=kh // 2 if stride == 1 else 1)


def _conv_t(p, x):
    """Temporal conv (3,1,1) over x [N, F, H, W, C], zero-padded in time."""
    return _xla_conv(p, x, padding=(1, 0, 0))


def _upsample2(x):
    """Nearest x2 of [N, H, W, C] (``jax.image.resize`` "nearest" at an
    integer factor repeats each pixel)."""
    n, hh, ww, c = x.shape
    return x[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(
        n, 2 * hh, 2 * ww, c)


# ------------------------------------------------------- res blocks


def _res2d_init(gen, cin, cout, temb, dtype):
    dev = gen.device
    p = {
        "norm1": P.group_norm_init(cin, dtype, dev),
        "conv1": _conv(gen, cin, cout, 3, dtype),
        "time_emb_proj": P.dense_init(gen, temb, cout, dtype=dtype),
        "norm2": P.group_norm_init(cout, dtype, dev),
        "conv2": _conv(gen, cout, cout, 3, dtype),
    }
    if cin != cout:
        p["conv_shortcut"] = _conv(gen, cin, cout, 1, dtype)
    return p


def _res2d(p, x, temb, eps):
    """ResnetBlock2D: x [N,H,W,C], temb [N, temb_dim] or None."""
    h = F.silu(P.group_norm(p["norm1"], x, eps=eps))
    h = _conv2d(p["conv1"], h)
    if temb is not None and "time_emb_proj" in p:
        t = P.dense(p["time_emb_proj"], F.silu(temb))
        h = h + t[:, None, None, :]
    h = F.silu(P.group_norm(p["norm2"], h, eps=eps))
    h = _conv2d(p["conv2"], h)
    skip = _conv2d(p["conv_shortcut"], x) if "conv_shortcut" in p else x
    return h + skip


def _res_temporal_init(gen, c, temb, dtype):
    dev = gen.device
    return {
        "norm1": P.group_norm_init(c, dtype, dev),
        "conv1": P.conv_init(gen, c, c, (3, 1, 1), dtype=dtype),
        "time_emb_proj": P.dense_init(gen, temb, c, dtype=dtype),
        "norm2": P.group_norm_init(c, dtype, dev),
        "conv2": P.conv_init(gen, c, c, (3, 1, 1), dtype=dtype),
    }


def _res_temporal(p, x, temb, eps):
    """TemporalResnetBlock: x [B, F, H, W, C], temb [B, F, temb_dim]|None."""
    b, f, hh, ww, c = x.shape
    flat = x.reshape(b * f, hh, ww, c)
    h = F.silu(P.group_norm(p["norm1"], flat, eps=eps)).reshape(x.shape)
    h = _conv_t(p["conv1"], h)
    if temb is not None and "time_emb_proj" in p:
        t = P.dense(p["time_emb_proj"], F.silu(temb))
        h = h + t[:, :, None, None, :]
    hf = h.reshape(b * f, hh, ww, c)
    hf = F.silu(P.group_norm(p["norm2"], hf, eps=eps)).reshape(x.shape)
    h = _conv_t(p["conv2"], hf)
    return h + x


def _alpha_blend(p, x_spatial, x_temporal, switch: bool):
    """AlphaBlender 'learned_with_images' for video (image_only_indicator
    all zero): alpha = sigmoid(mix_factor); if switch: alpha = 1 - alpha;
    x = alpha*x_spatial + (1-alpha)*x_temporal."""
    alpha = torch.sigmoid(p["mix_factor"].float())
    if switch:
        alpha = 1.0 - alpha
    return (alpha * x_spatial.float()
            + (1.0 - alpha) * x_temporal.float()).to(x_spatial.dtype)


def _st_res_init(gen, cin, cout, temb, dtype):
    p = {
        "spatial_res_block": _res2d_init(gen, cin, cout, max(temb, 1),
                                         dtype),
        "temporal_res_block": _res_temporal_init(gen, cout, max(temb, 1),
                                                 dtype),
        "time_mixer": {"mix_factor": torch.full((1,), 0.5,
                                                device=gen.device)},
    }
    if temb <= 0:  # no timestep conditioning (temporal VAE decoder)
        p["spatial_res_block"].pop("time_emb_proj")
        p["temporal_res_block"].pop("time_emb_proj")
    return p


def _st_res(p, x, temb, num_frames, eps):
    """SpatioTemporalResBlock: x [B*F, H, W, C], temb [B*F, D] or None."""
    h_sp = _res2d(p["spatial_res_block"], x, temb, eps)
    bf, hh, ww, c = h_sp.shape
    b = bf // num_frames
    h5 = h_sp.reshape(b, num_frames, hh, ww, c)
    temb5 = temb.reshape(b, num_frames, -1) if temb is not None else None
    h_tp = _res_temporal(p["temporal_res_block"], h5, temb5, eps)
    out = _alpha_blend(p["time_mixer"], h5, h_tp, switch=True)
    return out.reshape(bf, hh, ww, c)


# ------------------------------------------------------- transformers


def _attn_init(gen, dim, ctx_dim, dtype):
    return {
        "to_q": P.dense_init(gen, dim, dim, bias=False, dtype=dtype),
        "to_k": P.dense_init(gen, ctx_dim, dim, bias=False, dtype=dtype),
        "to_v": P.dense_init(gen, ctx_dim, dim, bias=False, dtype=dtype),
        "to_out": P.dense_init(gen, dim, dim, dtype=dtype),
    }


def _attn(p, x, ctx, heads):
    b, s, d = x.shape
    q = P.dense(p["to_q"], x).reshape(b, s, heads, d // heads)
    k = P.dense(p["to_k"], ctx).reshape(b, ctx.shape[1], heads, d // heads)
    v = P.dense(p["to_v"], ctx).reshape(b, ctx.shape[1], heads, d // heads)
    o = attention(q, k, v).reshape(b, s, d)
    return P.dense(p["to_out"], o)


def _geglu_init(gen, dim, dtype):
    return {"proj": P.dense_init(gen, dim, dim * 8, dtype=dtype),
            "out": P.dense_init(gen, dim * 4, dim, dtype=dtype)}


def _geglu(p, x):
    a, g = P.dense(p["proj"], x).chunk(2, dim=-1)
    return P.dense(p["out"], a * F.gelu(g))


def _basic_block_init(gen, dim, ctx_dim, dtype):
    dev = gen.device
    return {
        "norm1": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "attn1": _attn_init(gen, dim, dim, dtype),
        "norm2": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "attn2": _attn_init(gen, dim, ctx_dim, dtype),
        "norm3": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "ff": _geglu_init(gen, dim, dtype),
    }


def _basic_block(p, x, ctx, heads):
    """BasicTransformerBlock (LayerNorm eps 1e-5)."""
    h = P.layer_norm(p["norm1"], x, eps=1e-5)
    x = x + _attn(p["attn1"], h, h, heads)
    x = x + _attn(p["attn2"], P.layer_norm(p["norm2"], x, eps=1e-5), ctx,
                  heads)
    return x + _geglu(p["ff"], P.layer_norm(p["norm3"], x, eps=1e-5))


def _temporal_block_init(gen, dim, ctx_dim, dtype):
    dev = gen.device
    return {
        "norm_in": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "ff_in": _geglu_init(gen, dim, dtype),
        "norm1": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "attn1": _attn_init(gen, dim, dim, dtype),
        "norm2": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "attn2": _attn_init(gen, dim, ctx_dim, dtype),
        "norm3": P.layer_norm_init(dim, dtype=dtype, device=dev),
        "ff": _geglu_init(gen, dim, dtype),
    }


def _temporal_block(p, x, time_ctx, heads):
    """TemporalBasicTransformerBlock: x [B*HW, F, C] (LayerNorm eps 1e-5)."""
    x = x + _geglu(p["ff_in"], P.layer_norm(p["norm_in"], x, eps=1e-5))
    h = P.layer_norm(p["norm1"], x, eps=1e-5)
    x = x + _attn(p["attn1"], h, h, heads)
    x = x + _attn(p["attn2"], P.layer_norm(p["norm2"], x, eps=1e-5),
                  time_ctx, heads)
    return x + _geglu(p["ff"], P.layer_norm(p["norm3"], x, eps=1e-5))


def _st_transformer_init(gen, c, heads, ctx_dim, layers, dtype):
    return {
        "norm": P.group_norm_init(c, dtype, gen.device),
        "proj_in": P.dense_init(gen, c, c, dtype=dtype),
        "blocks": [_basic_block_init(gen, c, ctx_dim, dtype)
                   for _ in range(layers)],
        "temporal_blocks": [_temporal_block_init(gen, c, ctx_dim, dtype)
                            for _ in range(layers)],
        "time_pos_embed": {
            "fc1": P.dense_init(gen, c, c * 4, dtype=dtype),
            "fc2": P.dense_init(gen, c * 4, c, dtype=dtype)},
        "time_mixer": {"mix_factor": torch.full((1,), 0.5,
                                                device=gen.device)},
        "proj_out": P.dense_init(gen, c, c, dtype=dtype),
    }


def _map_chunked(fn, n, *arrs):
    """Run fn over ``n`` equal chunks of the leading axis, one after the
    other, and concatenate: exact math (every row is independent through
    fn), with the transformer block's transients (q/k/v, the GEGLU's dim*8
    inner) made per chunk instead of for the whole batch. The count rounds
    UP to the nearest divisor of the leading axis (the spatial blocks chunk
    over B*F, the temporal blocks over B*H*W: one knob serves both), and an
    axis whose nearest divisor is above 4n runs unchunked
    (``worldforge_tpu/models/depthcrafter/unet.py::_map_chunked``)."""
    lead = arrs[0].shape[0]
    if n > 1 and lead % n:
        d = next((d for d in range(n, lead + 1) if lead % d == 0), 1)
        n = d if d <= 4 * n else 1  # prime-ish lead: don't serialize rows
    if n <= 1 or lead % n:
        return fn(*arrs)
    step = lead // n
    return torch.cat([fn(*(a[i * step:(i + 1) * step] for a in arrs))
                      for i in range(n)])


def _st_transformer(p, x, ctx, num_frames, heads, chunks=1):
    """TransformerSpatioTemporalModel: x [B*F, H, W, C], ctx [B*F, L, D]."""
    bf, hh, ww, c = x.shape
    b = bf // num_frames
    residual = x

    # temporal cross-attn context = the FIRST frame's conditioning of each
    # batch row, for every spatial location (diffusers semantics)
    ctx_first = ctx.reshape(b, num_frames, *ctx.shape[1:])[:, 0]  # [B, L, D]
    time_ctx = ctx_first[:, None].expand(
        b, hh * ww, ctx.shape[1], ctx.shape[2]).reshape(
        b * hh * ww, ctx.shape[1], ctx.shape[2])

    h = P.group_norm(p["norm"], x, eps=1e-6)
    h = P.dense(p["proj_in"], h.reshape(bf, hh * ww, c))

    # frame position embeddings
    fpos = sinusoidal_timestep_embedding(
        torch.arange(num_frames, dtype=torch.float32, device=x.device), c)
    fpos = P.dense(p["time_pos_embed"]["fc2"], F.silu(
        P.dense(p["time_pos_embed"]["fc1"], fpos)))  # [F, C]

    for blk, tblk in zip(p["blocks"], p["temporal_blocks"]):
        h = _map_chunked(
            lambda hc, cc, _blk=blk: _basic_block(_blk, hc, cc, heads),
            chunks, h, ctx)
        ht = h.reshape(b, num_frames, hh * ww, c).transpose(1, 2)
        ht = ht.reshape(b * hh * ww, num_frames, c)
        ht = ht + fpos[None]
        ht = _map_chunked(
            lambda hc, cc, _blk=tblk: _temporal_block(_blk, hc, cc, heads),
            chunks, ht, time_ctx)
        ht = ht.reshape(b, hh * ww, num_frames, c).transpose(1, 2)
        ht = ht.reshape(bf, hh * ww, c)
        h = _alpha_blend(p["time_mixer"], h, ht, switch=False)

    h = P.dense(p["proj_out"], h).reshape(bf, hh, ww, c)
    return h + residual


# ------------------------------------------------------- top level


def init_svd_unet(gen: torch.Generator, cfg: SVDUNetConfig,
                  dtype=torch.float32) -> dict:
    """Random parameters drawn from ``gen`` on its device (the tree of
    ``worldforge_tpu``'s ``init_svd_unet``)."""
    boc = cfg.block_out_channels
    temb = cfg.temb_dim
    dev = gen.device
    params = {
        "conv_in": _conv(gen, cfg.in_channels, boc[0], 3, dtype),
        "time_embedding": {
            "fc1": P.dense_init(gen, boc[0], temb, dtype=dtype),
            "fc2": P.dense_init(gen, temb, temb, dtype=dtype)},
        "add_embedding": {
            "fc1": P.dense_init(gen, cfg.projection_dim, temb, dtype=dtype),
            "fc2": P.dense_init(gen, temb, temb, dtype=dtype)},
        "down_blocks": [],
        "up_blocks": [],
        "conv_norm_out": P.group_norm_init(boc[0], dtype, dev),
        "conv_out": _conv(gen, boc[0], cfg.out_channels, 3, dtype),
    }

    n = len(boc)
    for i in range(n):
        cin = boc[max(i - 1, 0)]
        cout = boc[i]
        has_attn = i < n - 1  # last down block is plain
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            blk["resnets"].append(_st_res_init(
                gen, cin if j == 0 else cout, cout, temb, dtype))
            if has_attn:
                blk["attentions"].append(_st_transformer_init(
                    gen, cout, cfg.num_attention_heads[i],
                    cfg.cross_attention_dim, cfg.transformer_layers, dtype))
        if i < n - 1:
            blk["downsampler"] = _conv(gen, cout, cout, 3, dtype)
        params["down_blocks"].append(blk)

    params["mid_block"] = {
        "resnets": [_st_res_init(gen, boc[-1], boc[-1], temb, dtype),
                    _st_res_init(gen, boc[-1], boc[-1], temb, dtype)],
        "attentions": [_st_transformer_init(
            gen, boc[-1], cfg.num_attention_heads[-1],
            cfg.cross_attention_dim, cfg.transformer_layers, dtype)],
    }

    rev = list(reversed(boc))
    for i in range(n):
        cout = rev[i]
        prev = rev[max(i - 1, 0)]
        has_attn = i > 0  # first up block is plain (mirrors down)
        blk = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            skip = rev[min(i + 1, n - 1)] if j == cfg.layers_per_block \
                else cout
            cin = (prev if j == 0 else cout) + skip
            blk["resnets"].append(_st_res_init(gen, cin, cout, temb, dtype))
            if has_attn:
                blk["attentions"].append(_st_transformer_init(
                    gen, cout, cfg.num_attention_heads[n - 1 - i],
                    cfg.cross_attention_dim, cfg.transformer_layers, dtype))
        if i < n - 1:
            blk["upsampler"] = _conv(gen, cout, cout, 3, dtype)
        params["up_blocks"].append(blk)
    return params


@torch.inference_mode()
def svd_unet_forward(params, cfg: SVDUNetConfig, sample: torch.Tensor,
                     timestep, encoder_hidden_states: torch.Tensor,
                     added_time_ids: torch.Tensor,
                     attn_chunks: int = 1) -> torch.Tensor:
    """sample: [B, F, C_in, H, W]; timestep: scalar or [B];
    encoder_hidden_states: [B, F, 1, 1024] per-frame CLIP tokens;
    added_time_ids: [B, 3]. Returns [B, F, C_out, H, W].

    attn_chunks: the exact-math capacity knob: every spatio-temporal
    transformer block runs over that many leading-axis chunks
    (``_map_chunked``); 1 runs each block in one pass."""
    b, f, cin, H, W = sample.shape
    eps = cfg.norm_eps
    dev = sample.device

    t = torch.as_tensor(timestep, dtype=torch.float32,
                        device=dev).reshape(-1).expand(b)
    t_emb = sinusoidal_timestep_embedding(t, cfg.block_out_channels[0])
    emb = P.dense(params["time_embedding"]["fc2"], F.silu(
        P.dense(params["time_embedding"]["fc1"], t_emb)))
    ids = sinusoidal_timestep_embedding(
        added_time_ids.to(dev).reshape(-1), cfg.addition_time_embed_dim)
    ids = ids.reshape(b, -1)
    aug = P.dense(params["add_embedding"]["fc2"], F.silu(
        P.dense(params["add_embedding"]["fc1"], ids)))
    emb = emb + aug                                # [B, temb]
    emb = emb.repeat_interleave(f, dim=0)          # [B*F, temb]

    ctx = encoder_hidden_states.reshape(b * f,
                                        *encoder_hidden_states.shape[2:])

    x = sample.reshape(b * f, cin, H, W).permute(0, 2, 3, 1).contiguous()
    x = _conv2d(params["conv_in"], x)

    res_stack = [x]
    n = len(cfg.block_out_channels)
    for i, blk in enumerate(params["down_blocks"]):
        for j, res in enumerate(blk["resnets"]):
            x = _st_res(res, x, emb, f, eps)
            if blk["attentions"]:
                x = _st_transformer(blk["attentions"][j], x, ctx, f,
                                    cfg.num_attention_heads[i],
                                    chunks=attn_chunks)
            res_stack.append(x)
        if "downsampler" in blk:
            x = _conv2d(blk["downsampler"], x, stride=2)
            res_stack.append(x)

    mid = params["mid_block"]
    x = _st_res(mid["resnets"][0], x, emb, f, eps)
    x = _st_transformer(mid["attentions"][0], x, ctx, f,
                        cfg.num_attention_heads[-1], chunks=attn_chunks)
    x = _st_res(mid["resnets"][1], x, emb, f, eps)

    for i, blk in enumerate(params["up_blocks"]):
        for j, res in enumerate(blk["resnets"]):
            skip = res_stack.pop()
            x = torch.cat([x, skip], dim=-1)
            x = _st_res(res, x, emb, f, eps)
            if blk["attentions"]:
                x = _st_transformer(blk["attentions"][j], x, ctx, f,
                                    cfg.num_attention_heads[n - 1 - i],
                                    chunks=attn_chunks)
        if "upsampler" in blk:
            x = _conv2d(blk["upsampler"], _upsample2(x))

    x = F.silu(P.group_norm(params["conv_norm_out"], x, eps=eps))
    x = _conv2d(params["conv_out"], x)
    return x.permute(0, 3, 1, 2).reshape(b, f, cfg.out_channels, H, W)
