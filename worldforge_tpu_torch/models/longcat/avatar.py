"""LongCat avatar DiT: the audio-conditioned talking-head variant.

Counterpart of ``worldforge_tpu/models/longcat/avatar.py``:
  - each block is the base LongCat block with an audio cross-attention
    inserted between the text cross-attention and the FFN, modulated by its
    own 3-way adaLN (``audio_adaln``, fp32) over the noise frames only; the
    cond frames get zero audio;
  - the audio windows are regrouped (``regroup_audio_windows``): frame 0
    keeps its 5-sample window, each later latent frame (4 video frames)
    packs [first half of frame a | middles | last half of frame d] into 8
    samples; ``audio_proj_forward`` maps them to 32 context tokens a frame;
  - the audio cross-attention runs per frame: the frames fold into the
    batch, so each latent frame's tokens attend to that frame's 32 audio
    tokens (64 in multitalk) in one call of flash attention (kernel 1);
  - multitalk (two speakers, ``ref_target_masks``): an fp32 attention map
    of the noise queries on each speaker's reference tokens
    (``attn_map_with_target``, plain matmuls) places every query token in
    its speaker's band of a 1-D RoPE (``multitalk_positions``,
    ``rope_1d_rotate``), and each speaker's audio keys at its band centre;
  - the reference-frame self-attention partitions
    (``avatar_self_attention``: ref, cond, noise, ``mask_frame_range``);
  - the k/v-cache pair ``avatar_dit_cache_cond`` /
    ``avatar_dit_forward_with_cache``.

Kernels: every self- and cross-attention (text and audio) goes through
``ops/attention`` (kernel 1) and the q/k RoPE of the self-attention through
``apply_rope_qk`` (kernel 2), where the JAX module calls ``attention`` and
``apply_rope_qk``; the cached step rotates q and the joint k with the plain
``apply_rope``, as the base model does. The per-frame modulation is a plain
LayerNorm, as in the base LongCat model. ``avatar_dit_forward`` takes a
``mesh`` (the base model's parallel layer: ``dp``, ``sp`` through Ulysses
outside the ref and multitalk modes, FSDP) and ``token_chunk`` (the FFN
over token chunks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.core.mesh import (AXIS_SP, TokenSplit,
                                            gather_batch, split_batch,
                                            sp_size)
from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                     _cross_attention_lc,
                                                     _embed_t, _final_layer,
                                                     _ffn_residual, _frames,
                                                     _gated, _heads_hd,
                                                     _modulate_per_frame,
                                                     _rms_hd, _rope_rows,
                                                     _self_attention_lc,
                                                     init_longcat_dit,
                                                     init_longcat_layer,
                                                     longcat_dit_cache_cond)
from worldforge_tpu_torch.models.wan.dit import patchify
from worldforge_tpu_torch.ops.attention import attention
from worldforge_tpu_torch.ops.rope import (apply_rope, apply_rope_qk,
                                           rope_cos_sin)
from worldforge_tpu_torch.ops.sampling import jax_nearest_index
from worldforge_tpu_torch.parallel.sharding import gather_params


@dataclasses.dataclass(frozen=True)
class AvatarConfig:
    base: LongCatDiTConfig = dataclasses.field(
        default_factory=LongCatDiTConfig)
    audio_window: int = 5
    audio_blocks: int = 12          # stacked wav2vec2 encoder layers
    audio_channels: int = 768
    intermediate_dim: int = 512
    output_dim: int = 768
    context_tokens: int = 32
    vae_scale: int = 4
    audio_prenorm: bool = False
    class_range: int = 24           # multitalk RoPE band span
    class_interval: int = 4

    @property
    def window_vf(self) -> int:
        return self.audio_window + self.vae_scale - 1

    @classmethod
    def tiny(cls) -> "AvatarConfig":
        return cls(base=LongCatDiTConfig.tiny(), audio_blocks=2,
                   audio_channels=8, intermediate_dim=16, output_dim=8,
                   context_tokens=4)


# ----------------------------------------------------------- audio proj


def init_audio_proj(gen: torch.Generator, cfg: AvatarConfig,
                    dtype=torch.float32) -> dict:
    in_dim = cfg.audio_window * cfg.audio_blocks * cfg.audio_channels
    in_dim_vf = cfg.window_vf * cfg.audio_blocks * cfg.audio_channels
    return {
        "proj1": P.dense_init(gen, in_dim, cfg.intermediate_dim, dtype=dtype),
        "proj1_vf": P.dense_init(gen, in_dim_vf, cfg.intermediate_dim,
                                 dtype=dtype),
        "proj2": P.dense_init(gen, cfg.intermediate_dim,
                              cfg.intermediate_dim, dtype=dtype),
        "proj3": P.dense_init(gen, cfg.intermediate_dim,
                              cfg.context_tokens * cfg.output_dim,
                              dtype=dtype),
        "norm": P.layer_norm_init(cfg.output_dim, dtype=dtype,
                                  device=gen.device),
    }


def audio_proj_forward(p, cfg: AvatarConfig, first: torch.Tensor,
                       latter: torch.Tensor) -> torch.Tensor:
    """first [B, 1, W, S, C]; latter [B, T-1, W+vs-1, S, C] ->
    [B, T, context_tokens, output_dim]."""
    b = first.shape[0]
    f = F.relu(P.dense(p["proj1"], first.reshape(b, 1, -1)))
    lf = F.relu(P.dense(p["proj1_vf"],
                        latter.reshape(b, latter.shape[1], -1)))
    x = torch.cat([f, lf], dim=1)                          # [B, T, inter]
    x = F.relu(P.dense(p["proj2"], x))
    tok = P.dense(p["proj3"], x).reshape(b, x.shape[1], cfg.context_tokens,
                                         cfg.output_dim)
    return P.layer_norm(p["norm"], tok, eps=1e-5)


def regroup_audio_windows(cfg: AvatarConfig, audio_cond: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio_cond [B, T_video, W, S, C] (per-video-frame windows of W = 5
    wav2vec features x S blocks) -> (first [B, 1, W, S, C], latter
    [B, (T_video-1)//vae_scale, W+vs-1, S, C]): per latent frame of
    vae_scale video frames, [first half of frame a | middle samples | last
    half of frame d]."""
    first = audio_cond[:, :1]
    latter = audio_cond[:, 1:]
    b, tm1, w, s, c = latter.shape
    vs = cfg.vae_scale
    mid = cfg.audio_window // 2
    lat = latter.reshape(b, tm1 // vs, vs, w, s, c)
    head = lat[:, :, :1, :mid + 1].reshape(b, tm1 // vs, -1, s, c)
    tail = lat[:, :, -1:, mid:].reshape(b, tm1 // vs, -1, s, c)
    midp = lat[:, :, 1:-1, mid:mid + 1].reshape(b, tm1 // vs, -1, s, c)
    return first, torch.cat([head, midp, tail], dim=2)


# ------------------------------------------------------------ multitalk


def rope_1d_rotate(x: torch.Tensor, pos: torch.Tensor,
                   base: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair 1-D RoPE of x [..., S, H, D] at positions [..., S],
    fp32 math, x's dtype out."""
    d = x.shape[-1]
    freqs = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d))
    ang = pos.float()[..., None] * freqs                   # [..., S, D/2]
    ang = torch.repeat_interleave(ang, 2, dim=-1)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x2 = xf.reshape(xf.shape[:-1] + (d // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


def attn_map_with_target(noise_q: torch.Tensor, ref_k: torch.Tensor,
                         ref_target_masks: torch.Tensor,
                         split_num: int = 2) -> torch.Tensor:
    """Each speaker's attention mass from the noise queries on its masked
    reference tokens: the heads in ``split_num`` groups, per group
    softmax(q k^T / sqrt(d)) over the reference tokens in fp32, the masked
    mean over reference tokens and heads, averaged over the groups.
    noise_q [B, Sn, H, D]; ref_k [B, Sref, H, D]; masks [C, Sref] ->
    [C, Sn]. Each group holds a [B, H / split_num, Sn, Sref] fp32 map."""
    b, sn, h, d = noise_q.shape
    scale = 1.0 / math.sqrt(d)
    hc = h // split_num
    m = ref_target_masks.float()                          # [C, Sref]
    denom = torch.clamp(m.sum(dim=1), min=1e-8)[:, None, None, None]
    total = None
    for g in range(split_num):
        q = noise_q[:, :, g * hc:(g + 1) * hc].float().transpose(1, 2)
        k = ref_k[:, :, g * hc:(g + 1) * hc].float().transpose(1, 2)
        att = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
        num = torch.einsum("bhqk,ck->cbhq", att, m)
        del att
        per = (num / denom).mean(dim=(1, 2))               # [C, Sn]
        total = per if total is None else total + per
    return total / split_num


def normalize_and_scale(column: torch.Tensor, source_range, target_range,
                        epsilon: float = 1e-8) -> torch.Tensor:
    """Linear rescale from source_range into target_range."""
    smin, smax = source_range
    tmin, tmax = target_range
    return (column - smin) / (smax - smin + epsilon) * (tmax - tmin) + tmin


def multitalk_positions(x_ref_attn_map: torch.Tensor,
                        class_range: int = 24,
                        class_interval: int = 4) -> torch.Tensor:
    """RoPE positions [Sn] from the 2-speaker map [2, Sn]: speaker 1
    normalised into [0, interval], speaker 2 into [range - interval,
    range]; each token takes the band of its argmax speaker (the first on a
    tie)."""
    h1 = normalize_and_scale(
        x_ref_attn_map[0],
        (x_ref_attn_map[0].min(), x_ref_attn_map[0].max()),
        (0.0, float(class_interval)))
    h2 = normalize_and_scale(
        x_ref_attn_map[1],
        (x_ref_attn_map[1].min(), x_ref_attn_map[1].max()),
        (float(class_range - class_interval), float(class_range)))
    back = torch.full_like(h1, class_range // 2)
    stacked = torch.stack([h1, h2, back], dim=1)          # [Sn, 3]
    idx = torch.argmax(x_ref_attn_map, dim=0)             # [Sn]
    return torch.gather(stacked, 1, idx[:, None])[:, 0]


# ------------------------------------------------- ref-aware self-attn


def _attend(q, k, v):
    """``attention`` over one partition; an empty one (no query rows, as
    the cond partition when it has no frames beyond the ref frame) gives an
    empty output without a launch."""
    if q.shape[1] == 0:
        return q.new_zeros(q.shape[:-1] + (v.shape[-1],))
    return attention(q, k, v)


def avatar_self_attention(p, cfg: AvatarConfig, x_m, cos, sin, T: int,
                          num_cond_latents: int, num_ref_latents: int,
                          ref_img_index: Optional[int],
                          mask_frame_range: Optional[int], policy: Policy,
                          ref_target_masks: Optional[torch.Tensor] = None):
    """Self-attention with reference-frame partitions: the ref frames (the
    first num_ref_latents) attend to themselves, the cond frames to the
    cond frames, the noise frames to everything except that the noise
    frames within mask_frame_range of ref_img_index attend to the non-ref
    keys only. Returns (out, the multitalk attention map or None)."""
    base = cfg.base
    b, n, c = x_m.shape
    cdt = policy.compute_dtype
    h = base.num_heads
    sf = n // T
    q, k, v = torch.chunk(P.dense(p["qkv"], x_m.to(cdt)), 3, dim=-1)
    q = _rms_hd(p["q_norm"], _heads_hd(q, h), base.eps)
    k = _rms_hd(p["k_norm"], _heads_hd(k, h), base.eps)
    v = _heads_hd(v, h)
    q, k = apply_rope_qk(q, k, cos, sin, out_dtype=cdt)

    nr = num_ref_latents * sf
    nc = num_cond_latents * sf
    o_ref = _attend(q[:, :nr], k[:, :nr], v[:, :nr])
    o_cond = _attend(q[:, nr:nc], k[:, nr:nc], v[:, nr:nc])

    x_ref_attn_map = None
    if ref_target_masks is not None and num_cond_latents < T:
        x_ref_attn_map = attn_map_with_target(q[:, nc:], k[:, :sf],
                                              ref_target_masks)

    if num_cond_latents == T:
        o = torch.cat([o_ref, o_cond], dim=1)
        return (P.dense(p["attn_proj"], o.reshape(b, n, c).to(cdt)),
                x_ref_attn_map)

    q_noise = q[:, nc:]
    num_noisy = T - num_cond_latents
    start = end = 0
    if mask_frame_range is not None and mask_frame_range > 0 \
            and ref_img_index is not None:
        start = (ref_img_index - mask_frame_range - num_cond_latents
                 + num_ref_latents)
        end = (ref_img_index + mask_frame_range - num_cond_latents
               + num_ref_latents + 1)
    if start >= 0 and end > start and end <= num_noisy:
        sp, ep = start * sf, end * sf
        o_noise = torch.cat([
            _attend(q_noise[:, :sp], k, v),
            _attend(q_noise[:, sp:ep], k[:, nr:], v[:, nr:]),
            _attend(q_noise[:, ep:], k, v)], dim=1)
    else:
        o_noise = _attend(q_noise, k, v)
    o = torch.cat([o_ref, o_cond, o_noise], dim=1)
    return (P.dense(p["attn_proj"], o.reshape(b, n, c).to(cdt)),
            x_ref_attn_map)


# -------------------------------------------------------------- block


def init_avatar_layer(gen: torch.Generator, cfg: AvatarConfig,
                      dtype=torch.float32) -> dict:
    c = cfg.base.hidden_size
    hd = cfg.base.head_dim
    dev = gen.device
    p = init_longcat_layer(gen, cfg.base, dtype)
    p.update({
        "audio_adaln": P.dense_init(gen, cfg.base.adaln_tembed_dim, 3 * c,
                                    dtype=torch.float32),
        "pre_video_norm": P.layer_norm_init(c, dtype=dtype, device=dev),
        "pre_audio_norm": P.layer_norm_init(cfg.output_dim, dtype=dtype,
                                            device=dev),
        "a_q": P.dense_init(gen, c, c, dtype=dtype),
        "a_kv": P.dense_init(gen, cfg.output_dim, 2 * c, dtype=dtype),
        "a_q_norm": P.rms_norm_init(hd, device=dev),
        "a_k_norm": P.rms_norm_init(hd, device=dev),
        "a_proj": P.dense_init(gen, c, c, dtype=dtype),
    })
    return p


def _audio_qkv(p, cfg: AvatarConfig, x_noise, audio, t_noise, policy):
    """Per-frame q [B*T_n, S_f, H, D] (fp32, RMS-normed), k (fp32) and v
    from x_noise [B, T_n*S_f, C] and audio [B, T_n, M, C_a]."""
    b, n, c = x_noise.shape
    cdt = policy.compute_dtype
    h = cfg.base.num_heads
    xq = x_noise.reshape(b * t_noise, n // t_noise, c)
    q = _rms_hd(p["a_q_norm"], _heads_hd(P.dense(p["a_q"], xq.to(cdt)), h),
                cfg.base.eps)
    cond = audio.reshape(b * t_noise, audio.shape[2], -1)
    k, v = torch.chunk(P.dense(p["a_kv"], cond.to(cdt)), 2, dim=-1)
    k = _rms_hd(p["a_k_norm"], _heads_hd(k, h), cfg.base.eps)
    return q, k, _heads_hd(v, h)


def _audio_out(p, o, x_noise, policy):
    b, n, c = x_noise.shape
    o = P.dense(p["a_proj"],
                o.reshape(o.shape[0], o.shape[1], c).to(policy.compute_dtype))
    return o.reshape(b, n, c)


def _audio_cross_attention(p, cfg: AvatarConfig, x_noise: torch.Tensor,
                           audio: torch.Tensor, t_noise: int,
                           policy: Policy) -> torch.Tensor:
    """Per-frame cross-attention (singletalk): the frames fold into the
    batch. x_noise [B, T_n*S_f, C]; audio [B, T_n, M, C_a]."""
    cdt = policy.compute_dtype
    q, k, v = _audio_qkv(p, cfg, x_noise, audio, t_noise, policy)
    o = attention(q.to(cdt), k.to(cdt), v)
    return _audio_out(p, o, x_noise, policy)


def _audio_cross_attention_multitalk(p, cfg: AvatarConfig,
                                     x_noise: torch.Tensor,
                                     audio: torch.Tensor, t_noise: int,
                                     x_ref_attn_map: torch.Tensor,
                                     policy: Policy) -> torch.Tensor:
    """Two-speaker audio cross-attention: the query tokens take 1-D RoPE
    positions in the band of the speaker they attend to most, each
    speaker's audio keys sit at its band centre; audio holds both
    speakers' tokens per frame ([B, T_n, 2M, C_a])."""
    b, n, _ = x_noise.shape
    cdt = policy.compute_dtype
    h = cfg.base.num_heads
    ci, cr = cfg.class_interval, cfg.class_range
    q, k, v = _audio_qkv(p, cfg, x_noise, audio, t_noise, policy)
    # positions over the whole noise sequence
    pos = multitalk_positions(x_ref_attn_map, cr, ci)      # [n]
    qf = rope_1d_rotate(q.reshape(b, n, h, -1), pos[None].expand(b, n))
    q = qf.reshape(b * t_noise, n // t_noise, h, -1).to(cdt)
    na = k.shape[1]
    per_frame = torch.where(torch.arange(na, device=k.device) < na // 2,
                            (0.0 + ci) / 2.0, (cr - ci + cr) / 2.0)
    kf = k.reshape(b, t_noise * na, h, -1)
    kf = rope_1d_rotate(kf, per_frame.repeat(t_noise)[None].expand(
        b, t_noise * na))
    k = kf.reshape(b * t_noise, na, h, -1).to(cdt)
    o = attention(q, k, v)
    return _audio_out(p, o, x_noise, policy)


def _audio_residual(p, cfg: AvatarConfig, xf, t_emb, audio, T: int,
                    num_cond_latents: int, x_ref_attn_map, policy: Policy,
                    split=None):
    """The audio branch over the noise frames with its own fp32 modulation;
    the cond frames get zeros. Returns xf + the branch. Under a ``split``
    (this rank's rows of the sequence) the rank's noise rows are laid into
    whole frames (zeros elsewhere) for the per-frame attention, which is
    row by row the same math."""
    base = cfg.base
    b, n, c = xf.shape
    t_noise = T - num_cond_latents
    amod = P.dense(p["audio_adaln"], F.silu(t_emb[:, num_cond_latents:]
                                           .float()),
                   compute_dtype=torch.float32)
    a_sh, a_sc, a_g = torch.chunk(amod, 3, dim=-1)          # [B, T_n, C]
    audio_n = audio[:, num_cond_latents:]
    if cfg.audio_prenorm:
        audio_n = P.layer_norm(p["pre_audio_norm"], audio_n, eps=base.eps)
    if split is not None:
        s_f = split.n // T
        g = split.index - num_cond_latents * s_f             # noise index
        rows = torch.arange(n, device=xf.device)
        sel = ((rows < split.n_real) & (g >= 0)).nonzero()[:, 0]
        if sel.numel() == 0:
            return xf
        g = g[sel]
        fr = torch.div(g, s_f, rounding_mode="floor")
        f_lo, f_hi = int(fr.min()), int(fr.max()) + 1
        pos = g - f_lo * s_f
        xv = P.layer_norm(p["pre_video_norm"], xf[:, sel], eps=base.eps,
                          out_dtype=policy.compute_dtype)
        buf = xv.new_zeros((b, (f_hi - f_lo) * s_f, c)).index_copy(1, pos,
                                                                   xv)
        a_out = _audio_cross_attention(p, cfg, buf, audio_n[:, f_lo:f_hi],
                                       f_hi - f_lo, policy)[:, pos]
        a_out = _modulate_per_frame(a_out.float(), a_sh, a_sc, t_noise,
                                    base.eps, fr)
        a_out = a_g[:, fr] * a_out
        return xf.index_add(1, sel, a_out)
    nc = num_cond_latents * (n // T) if num_cond_latents else 0
    xv = P.layer_norm(p["pre_video_norm"], xf[:, nc:], eps=base.eps,
                      out_dtype=policy.compute_dtype)
    if x_ref_attn_map is not None:
        a_out = _audio_cross_attention_multitalk(
            p, cfg, xv, audio_n, t_noise, x_ref_attn_map, policy)
    else:
        a_out = _audio_cross_attention(p, cfg, xv, audio_n, t_noise, policy)
    a_out = _modulate_per_frame(a_out.float(), a_sh, a_sc, t_noise, base.eps)
    a_out = (a_g[:, :, None] * a_out.reshape(b, t_noise, -1, c)
             ).reshape(b, n - nc, c)
    if nc:
        a_out = torch.cat([torch.zeros((b, nc, c), dtype=a_out.dtype,
                                       device=a_out.device), a_out], dim=1)
    return xf + a_out


def avatar_layer_forward(p, cfg: AvatarConfig, x, t_emb, ctx, kv_lens,
                         audio, cos, sin, T: int, num_cond_latents: int = 0,
                         num_ref_latents: int = 0,
                         ref_img_index: Optional[int] = None,
                         mask_frame_range: Optional[int] = None,
                         ref_target_masks: Optional[torch.Tensor] = None,
                         policy: Policy = DEFAULT_POLICY,
                         token_chunk: int = 1, mesh=None, split=None):
    """The base LongCat block with the audio branch between the text
    cross-attention and the FFN. audio: [B, T, M, C_a] per-latent-frame
    tokens (2M a frame in multitalk); ref_target_masks [2, Nh*Nw] turns on
    multitalk. Under a ``split`` x holds this rank's rows (the base
    self-attention through Ulysses; never in the ref or multitalk modes,
    whose attention maps need the whole sequence). An FSDP-sharded block
    is gathered first."""
    base = cfg.base
    b, n, c = x.shape
    cdt = policy.compute_dtype
    p = gather_params(p, mesh)
    frames = _frames(split, T)
    mod = P.dense(p["adaln"], F.silu(t_emb.float()),
                  compute_dtype=torch.float32)
    sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)

    xf = x.float()
    x_m = _modulate_per_frame(xf, sh_a, sc_a, T, base.eps, frames)
    x_ref_attn_map = None
    if (num_ref_latents > 0 and num_cond_latents > 1) \
            or ref_target_masks is not None:
        y, x_ref_attn_map = avatar_self_attention(
            p, cfg, x_m.to(cdt), cos, sin, T, max(num_cond_latents, 1),
            max(num_ref_latents, 1), ref_img_index, mask_frame_range,
            policy, ref_target_masks=ref_target_masks)
    else:
        y = _self_attention_lc(p, base, x_m.to(cdt), cos, sin, T,
                               num_cond_latents, policy, mesh=mesh,
                               split=split)
    xf = xf + _gated(g_a, y.float(), T, frames)

    h2 = P.layer_norm(p["pre_crs_norm"], xf, eps=base.eps, out_dtype=cdt)
    xf = xf + _cross_attention_lc(p, base, h2, ctx, kv_lens, T,
                                  num_cond_latents, policy, split).float()

    xf = _audio_residual(p, cfg, xf, t_emb, audio, T, num_cond_latents,
                         x_ref_attn_map, policy, split)
    return _ffn_residual(p, base, xf, sh_f, sc_f, g_f, T, cdt, frames,
                         token_chunk)


# ----------------------------------------------------------- shared


def _embed(params, cfg: AvatarConfig, hidden_states, timestep,
           encoder_hidden_states, encoder_attention_mask, audio_embs,
           policy: Policy, split=None):
    """Patch, timestep, text and audio embeddings of a forward: (x fp32
    [B, N, C] (this rank's rows under a ``split``), t_emb [B, T, adaln],
    ctx, kv_lens, audio tokens [B, T_video_lat, M, C_a], (nt, nh, nw))."""
    base = cfg.base
    cdt = policy.compute_dtype
    b, _, T, H, W = hidden_states.shape
    pt, ph, pw = base.patch_size
    nt, nh, nw = T // pt, H // ph, W // pw
    dev = hidden_states.device
    if timestep.ndim == 1:
        timestep = timestep[:, None].expand(b, nt)
    tokens = patchify(hidden_states.to(cdt), base.patch_size)
    if split is not None:
        tokens = split.split(tokens)
    x = P.dense(params["x_embedder"], tokens, compute_dtype=cdt)
    t_emb = _embed_t(params, base, timestep.to(dev), b, nt)
    ctx = P.dense(params["y_embedder"]["fc2"], P.gelu_tanh(
        P.dense(params["y_embedder"]["fc1"], encoder_hidden_states.to(cdt))))
    kv_lens = (encoder_attention_mask.sum(dim=1).to(torch.int32)
               if encoder_attention_mask is not None else None)
    first, latter = regroup_audio_windows(cfg, audio_embs)
    audio = audio_proj_forward(params["audio_proj"], cfg, first, latter)
    return x.float(), t_emb, ctx, kv_lens, audio, (nt, nh, nw)


def _final(params, cfg: AvatarConfig, xN, t_emb, grid, split=None):
    return _final_layer(params, cfg.base, xN, t_emb, grid, split)


# ----------------------------------------------------------- KV cache


def avatar_dit_cache_cond(params, cfg: AvatarConfig, cond_latents,
                          policy: Policy = DEFAULT_POLICY):
    """The clean cond frames' k/v of every block. Caching skips both the
    text and the audio branch, so this is the base model's cache pass over
    the avatar blocks (their audio parameters unused)."""
    return longcat_dit_cache_cond(params, cfg.base, cond_latents,
                                  policy=policy)


@torch.inference_mode()
def avatar_dit_forward_with_cache(params, cfg: AvatarConfig, hidden_states,
                                  timestep, encoder_hidden_states,
                                  audio_embs, kv_cache, cond_grid,
                                  encoder_attention_mask=None,
                                  policy: Policy = DEFAULT_POLICY):
    """Denoise the noise latents [B, C, T_noise, H, W] against the cached
    cond k/v with audio: the text cross-attention over all noise tokens,
    the audio branch with num_cond_latents = 0. audio_embs covers the whole
    video ([B, T_video, W, S, C_a]); the last T_noise latent frames' tokens
    are used."""
    base = cfg.base
    cdt = policy.compute_dtype
    h = base.num_heads
    xf, t_emb, ctx, kv_lens, audio, grid = _embed(
        params, cfg, hidden_states, timestep, encoder_hidden_states,
        encoder_attention_mask, audio_embs, policy)
    nt, nh, nw = grid
    b = xf.shape[0]
    audio = audio[:, -nt:]
    tc = cond_grid[0]
    n_cond = tc * nh * nw
    cos_full, sin_full = rope_cos_sin(tc + nt, nh, nw, base.head_dim,
                                      device=xf.device)
    cos_q, sin_q = cos_full[n_cond:], sin_full[n_cond:]

    for layer, kv in zip(params["blocks"], kv_cache):
        mod = P.dense(layer["adaln"], F.silu(t_emb),
                      compute_dtype=torch.float32)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = torch.chunk(mod, 6, dim=-1)
        x_m = _modulate_per_frame(xf, sh_a, sc_a, nt, base.eps).to(cdt)
        q, k, v = torch.chunk(P.dense(layer["qkv"], x_m), 3, dim=-1)
        q = _rms_hd(layer["q_norm"], _heads_hd(q, h), base.eps)
        k = _rms_hd(layer["k_norm"], _heads_hd(k, h), base.eps)
        k_full = torch.cat([kv[0].float(), k], dim=1)
        v_full = torch.cat([kv[1].to(cdt), _heads_hd(v, h).to(cdt)], dim=1)
        q = apply_rope(q, cos_q, sin_q, out_dtype=cdt)
        k_full = apply_rope(k_full, cos_full, sin_full, out_dtype=cdt)
        o = attention(q, k_full, v_full)
        o = P.dense(layer["attn_proj"],
                    o.reshape(b, nt * nh * nw, base.hidden_size).to(cdt))
        of = o.float().reshape(b, nt, -1, base.hidden_size)
        xf = xf + (g_a[:, :, None] * of).reshape(xf.shape)

        h2 = P.layer_norm(layer["pre_crs_norm"], xf, eps=base.eps,
                          out_dtype=cdt)
        xf = xf + _cross_attention_lc(layer, base, h2, ctx, kv_lens, nt, 0,
                                      policy).float()
        xf = _audio_residual(layer, cfg, xf, t_emb, audio, nt, 0, None,
                             policy)
        xf = _ffn_residual(layer, base, xf, sh_f, sc_f, g_f, nt, cdt)
    return _final(params, cfg, xf, t_emb, grid)


# -------------------------------------------------------------- model


def init_avatar_dit(gen: torch.Generator, cfg: AvatarConfig,
                    dtype=torch.bfloat16) -> dict:
    """Random init on ``gen.device``: the base LongCat DiT's embedders and
    final layer, the avatar blocks one at a time, and the fp32 audio
    projection."""
    params = init_longcat_dit(gen, dataclasses.replace(cfg.base, depth=0),
                              dtype)
    params["blocks"] = [init_avatar_layer(gen, cfg, dtype)
                        for _ in range(cfg.base.depth)]
    params["audio_proj"] = init_audio_proj(gen, cfg, torch.float32)
    return params


@torch.inference_mode()
def avatar_dit_forward(params, cfg: AvatarConfig, hidden_states, timestep,
                       encoder_hidden_states, audio_embs,
                       encoder_attention_mask=None,
                       num_cond_latents: int = 0,
                       num_ref_latents: Optional[int] = None,
                       ref_img_index: Optional[int] = None,
                       mask_frame_range: Optional[int] = None,
                       ref_target_masks: Optional[torch.Tensor] = None,
                       policy: Policy = DEFAULT_POLICY, token_chunk: int = 1,
                       mesh=None):
    """hidden_states [B, C_in, T, H, W]; timestep [B] or [B, T];
    audio_embs [B, T_video, W, S, C_a] per-video-frame wav2vec windows, the
    batch axis holding the two speakers when ref_target_masks ([2, H, W]
    pixel masks, multitalk) is given. Returns [B, C_out, T, H, W] fp32.
    ``mesh``: the parallel layer (``models/longcat/dit.py``): the batch on
    ``dp``, the tokens on ``sp`` with the base self-attention through
    Ulysses, except in the ref and multitalk modes, which run every token
    on every rank. ``token_chunk`` > 1: the FFN over that many token
    chunks (exact math)."""
    base = cfg.base
    b, _, T, H, W = hidden_states.shape
    pt, ph, pw = base.patch_size
    grid = (T // pt, H // ph, W // pw)
    nt, nh, nw = grid
    split = None
    if mesh is not None:
        params = gather_params(params, mesh, skip=("blocks",))
        if timestep.ndim == 1:
            timestep = timestep[:, None].expand(b, nt)
        ins = [hidden_states, timestep, encoder_hidden_states,
               encoder_attention_mask]
        if ref_target_masks is None:
            ins.append(audio_embs)
        ins = [split_batch(a, mesh, b) for a in ins]
        hidden_states, timestep, encoder_hidden_states, \
            encoder_attention_mask = ins[:4]
        if ref_target_masks is None:
            audio_embs = ins[4]
        ref_mode = ((num_ref_latents or 0) > 0 and num_cond_latents > 1)
        if sp_size(mesh) > 1 and not ref_mode and ref_target_masks is None:
            split = TokenSplit(nt * nh * nw, mesh, (AXIS_SP,),
                               device=hidden_states.device)
    xN, t_emb, ctx, kv_lens, audio, grid = _embed(
        params, cfg, hidden_states, timestep, encoder_hidden_states,
        encoder_attention_mask, audio_embs, policy, split)
    dev = xN.device
    if num_ref_latents:
        # a ref image in front reuses frame 0's audio as padding
        audio = torch.cat([audio[:, :1], audio], dim=1)
    audio = audio[:, -nt:]

    token_masks = None
    if ref_target_masks is not None:
        if num_cond_latents <= 0:
            raise ValueError(
                "multitalk (ref_target_masks) only supports image-to-video"
                " or video continuation: num_cond_latents must be > 0")
        # [2, H, W] pixel masks -> [2, Nh*Nw] token masks (nearest); both
        # speakers' audio tokens side by side per frame
        rtm = ref_target_masks.float().to(dev)
        tm = rtm[:, jax_nearest_index(rtm.shape[1], nh, dev)]
        tm = tm[:, :, jax_nearest_index(rtm.shape[2], nw, dev)]
        token_masks = (tm > 0).reshape(rtm.shape[0], -1)
        audio = audio.transpose(0, 1).reshape(1, nt, -1, cfg.output_dim)

    if num_ref_latents and ref_img_index is not None:
        # ref-image mode: the ref frame keeps its own temporal position,
        # the cond / noise frames start at 0
        tpos = (float(ref_img_index), *range(nt - num_ref_latents))
        cos, sin = rope_cos_sin(nt, nh, nw, base.head_dim, t_positions=tpos,
                                device=dev)
    else:
        cos, sin = rope_cos_sin(nt, nh, nw, base.head_dim, device=dev)
    cos, sin = _rope_rows(cos, sin, split)

    for layer in params["blocks"]:
        xN = avatar_layer_forward(layer, cfg, xN, t_emb, ctx, kv_lens, audio,
                                  cos, sin, nt, num_cond_latents,
                                  num_ref_latents or 0, ref_img_index,
                                  mask_frame_range, token_masks, policy,
                                  token_chunk, mesh, split)
    return gather_batch(_final(params, cfg, xN, t_emb, grid, split), mesh, b)
