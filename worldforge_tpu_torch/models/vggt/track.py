"""VGGT track head: CoTracker-style iterative point tracking.

Counterpart of ``worldforge_tpu/models/vggt/track.py``, fp32, the same
param tree:

  - the DPT feature extractor (``heads.py`` with ``feature_only`` and
    ``down_ratio`` 2, no position embedding);
  - ``corr_pyramid`` (2x average pools) and ``corr_sample``: per level a
    dot-product correlation of the track features with the feature map,
    sampled on a (2r+1)^2 delta grid around each track with zeros padding.
    The delta grid is stacked (dy, dx) and added to (x, y) centres, a swap
    the reference makes and JAX keeps: so does the port;
  - the updateformer: 64 virtual tracks, time attention over the S frames,
    then virtual-to-point, virtual and point-to-virtual attention over the
    N tracks of each frame. Its blocks add the residual to the normed input
    (the reference overwrites x with norm1(x)), as JAX does;
  - ``track_predictor_forward``: 4 refinements; frame 0 is pinned to the
    query points from a copy of the initial coordinates.

The attentions are small (S frames or N tracks, head dim 48) and run as an
explicit softmax of q.k^T, as JAX's ``_mha`` does outside any Pallas
kernel; kernel 1 has no head dim 48.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.consts import device_constant
from worldforge_tpu_torch.models.vggt.heads import (DPTHeadConfig,
                                                    dpt_head_forward,
                                                    init_dpt_head)
from worldforge_tpu_torch.ops.sampling import bilinear_sample

_EPS = 1e-5  # torch LayerNorm / GroupNorm default


@dataclasses.dataclass(frozen=True)
class TrackHeadConfig:
    dim_in: int = 2048
    patch_size: int = 14
    features: int = 128          # latent_dim
    iters: int = 4
    stride: int = 2
    corr_levels: int = 7
    corr_radius: int = 4
    hidden_size: int = 384
    depth: int = 6               # time depth == space depth
    num_heads: int = 8
    num_virtual: int = 64
    max_scale: int = 518
    mlp_ratio: float = 4.0
    predict_conf: bool = True
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)

    @property
    def transformer_dim(self) -> int:
        return 3 * self.features + 4

    @property
    def dpt(self) -> DPTHeadConfig:
        return DPTHeadConfig(dim_in=self.dim_in, patch_size=self.patch_size,
                             features=self.features,
                             out_channels=(self.features * 2,) * 4
                             if self.features < 64 else
                             (256, 512, 1024, 1024),
                             pos_embed=False, feature_only=True, down_ratio=2)

    @classmethod
    def tiny(cls) -> "TrackHeadConfig":
        return cls(dim_in=64, patch_size=14, features=16, iters=2,
                   corr_levels=2, corr_radius=2, hidden_size=32, depth=2,
                   num_heads=2, num_virtual=4,
                   intermediate_layer_idx=(0, 1, 2, 3))


# ------------------------------------------------------------- primitives


def sincos_pos_embed_2d(dim: int, gh: int, gw: int) -> np.ndarray:
    """[gh, gw, dim] = cat(sincos(x), sincos(y)), in float64 on the host,
    cast to float32."""
    half = dim // 2
    omega = 1.0 / (10000.0 ** (np.arange(half // 2, dtype=np.float64)
                               / (half / 2.0)))

    def emb(pos):
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    xx, yy = np.meshgrid(np.arange(gw, dtype=np.float64),
                         np.arange(gh, dtype=np.float64), indexing="xy")
    return np.concatenate([emb(xx), emb(yy)],
                          axis=1).reshape(gh, gw, dim).astype(np.float32)


def pos_grid(dim: int, gh: int, gw: int, device) -> torch.Tensor:
    """``sincos_pos_embed_2d`` on ``device``, made once per shape."""
    return device_constant(
        ("sincos_pos_embed_2d", dim, gh, gw),
        lambda: torch.from_numpy(sincos_pos_embed_2d(dim, gh, gw)), device)


def sample_pos_grid(dim: int, hh: int, ww: int, pts: torch.Tensor
                    ) -> torch.Tensor:
    """The sincos grid [hh, ww, dim] sampled (border) at pts [B, N, 2] ->
    [B, N, dim]. One grid serves every batch row, so the points of all
    rows sample it in one call (JAX broadcasts the grid to the batch)."""
    grid = pos_grid(dim, hh, ww, pts.device)
    b, n = pts.shape[:2]
    return bilinear_sample(grid[None], pts.reshape(1, b * n, 2),
                           padding="border").reshape(b, n, dim)


def flow_embedding(flows: torch.Tensor, c: int) -> torch.Tensor:
    """Interleaved sin / cos embedding of 2D flows: [..., 2] -> [..., 2c]."""
    div = torch.arange(0, c, 2, dtype=torch.float32,
                       device=flows.device) * (1000.0 / c)
    x = flows[..., 0:1] * div
    y = flows[..., 1:2] * div

    def interleave(sin, cos):
        return torch.stack([sin, cos], dim=-1).flatten(-2)

    return torch.cat([interleave(torch.sin(x), torch.cos(x)),
                      interleave(torch.sin(y), torch.cos(y))], dim=-1)


def delta_grid(radius: int, device) -> torch.Tensor:
    """The (2r+1)^2 sampling offsets as (dy, dx) pairs, [K2, 2]."""
    def make():
        k = 2 * radius + 1
        dx = np.linspace(-radius, radius, k)
        return torch.from_numpy(np.stack(np.meshgrid(dx, dx, indexing="ij"),
                                         axis=-1).reshape(-1, 2)).float()
    return device_constant(("delta_grid", radius), make, device)


# ---------------------------------------------------------------- modules


def mha_init(gen, dim, dtype):
    """torch nn.MultiheadAttention's layout: a fused in-projection and an
    out-projection."""
    return {"in_proj": P.dense_init(gen, dim, 3 * dim, dtype=dtype),
            "out_proj": P.dense_init(gen, dim, dim, dtype=dtype)}


def mha(p, q, kv, num_heads):
    """Multi-head attention of q [..., Lq, D] over kv [..., Lk, D]: an
    explicit fp32 softmax."""
    dim = q.shape[-1]
    w = p["in_proj"]["w"].float()
    b = p["in_proj"]["b"].float()
    qq = q @ w[:, :dim] + b[:dim]
    kk = kv @ w[:, dim:2 * dim] + b[dim:2 * dim]
    vv = kv @ w[:, 2 * dim:] + b[2 * dim:]
    hd = dim // num_heads

    def split(t):
        return t.reshape(t.shape[:-1] + (num_heads, hd)).transpose(-3, -2)

    qh, kh, vh = split(qq), split(kk), split(vv)
    att = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    out = (att @ vh).transpose(-3, -2)
    return P.dense(p["out_proj"], out.reshape(out.shape[:-2] + (dim,)))


def mlp_init(gen, dim, hidden, dtype, out_dim=None):
    return {"fc1": P.dense_init(gen, dim, hidden, dtype=dtype),
            "fc2": P.dense_init(gen, hidden, out_dim or dim, dtype=dtype)}


def mlp(p, x):
    return P.dense(p["fc2"], F.gelu(P.dense(p["fc1"], x)))


def _attn_block_init(gen, dim, mlp_ratio, dtype):
    return {"norm1": P.layer_norm_init(dim, dtype=dtype, device=gen.device),
            "norm2": P.layer_norm_init(dim, dtype=dtype, device=gen.device),
            "attn": mha_init(gen, dim, dtype),
            "mlp": mlp_init(gen, dim, int(dim * mlp_ratio), dtype)}


def _attn_block(p, x, num_heads):
    """Self-attention block; the residual adds to norm1(x)."""
    x = P.layer_norm(p["norm1"], x, eps=_EPS)
    x = x + mha(p["attn"], x, x, num_heads)
    return x + mlp(p["mlp"], P.layer_norm(p["norm2"], x, eps=_EPS))


def _cross_block_init(gen, dim, mlp_ratio, dtype):
    return {"norm1": P.layer_norm_init(dim, dtype=dtype, device=gen.device),
            "norm_ctx": P.layer_norm_init(dim, dtype=dtype,
                                          device=gen.device),
            "norm2": P.layer_norm_init(dim, dtype=dtype, device=gen.device),
            "attn": mha_init(gen, dim, dtype),
            "mlp": mlp_init(gen, dim, int(dim * mlp_ratio), dtype)}


def _cross_block(p, x, ctx, num_heads):
    """Cross-attention block, with the same residual on norm1(x)."""
    x = P.layer_norm(p["norm1"], x, eps=_EPS)
    ctx = P.layer_norm(p["norm_ctx"], ctx, eps=_EPS)
    x = x + mha(p["attn"], x, ctx, num_heads)
    return x + mlp(p["mlp"], P.layer_norm(p["norm2"], x, eps=_EPS))


def init_updateformer(gen: torch.Generator, cfg: TrackHeadConfig,
                      dtype=torch.float32) -> dict:
    h = cfg.hidden_size
    dev = gen.device
    return {
        "input_norm": P.layer_norm_init(cfg.transformer_dim, dtype=dtype,
                                        device=dev),
        "input_transform": P.dense_init(gen, cfg.transformer_dim, h,
                                        dtype=dtype),
        "virtual": P.normal(gen, (1, cfg.num_virtual, 1, h)).to(dtype),
        "time_blocks": [_attn_block_init(gen, h, cfg.mlp_ratio, dtype)
                        for _ in range(cfg.depth)],
        "space_virtual": [_attn_block_init(gen, h, cfg.mlp_ratio, dtype)
                          for _ in range(cfg.depth)],
        "v2p": [_cross_block_init(gen, h, cfg.mlp_ratio, dtype)
                for _ in range(cfg.depth)],
        "p2v": [_cross_block_init(gen, h, cfg.mlp_ratio, dtype)
                for _ in range(cfg.depth)],
        "output_norm": P.layer_norm_init(h, dtype=dtype, device=dev),
        "flow_head": P.dense_init(gen, h, cfg.features + 2, dtype=dtype),
    }


def updateformer_forward(p, cfg: TrackHeadConfig,
                         x: torch.Tensor) -> torch.Tensor:
    """x [B, N, T, D] -> delta [B, N, T, features + 2]."""
    b, n, t, _ = x.shape
    nh = cfg.num_heads
    tokens = P.dense(p["input_transform"],
                     P.layer_norm(p["input_norm"], x, eps=_EPS))
    init_tokens = tokens
    virt = p["virtual"].float().expand(b, cfg.num_virtual, t,
                                       cfg.hidden_size)
    tokens = torch.cat([tokens, virt], dim=1)
    ntot = n + cfg.num_virtual
    for i in range(cfg.depth):
        tt = _attn_block(p["time_blocks"][i], tokens.reshape(b * ntot, t, -1),
                         nh)
        st = tt.reshape(b, ntot, t, -1).transpose(1, 2).reshape(b * t, ntot,
                                                                -1)
        pts, virt = st[:, :n], st[:, n:]
        virt = _cross_block(p["v2p"][i], virt, pts, nh)
        virt = _attn_block(p["space_virtual"][i], virt, nh)
        pts = _cross_block(p["p2v"][i], pts, virt, nh)
        st = torch.cat([pts, virt], dim=1)
        tokens = st.reshape(b, t, ntot, -1).transpose(1, 2)
    tokens = tokens[:, :n] + init_tokens
    return P.dense(p["flow_head"],
                   P.layer_norm(p["output_norm"], tokens, eps=_EPS))


# --------------------------------------------------------------- CorrBlock


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 average pool of [M, H, W, C], odd edges dropped; below 2 x 2
    the map is returned as it is (the SfM tracker's small levels)."""
    m, h, w, c = x.shape
    if h < 2 or w < 2:
        return x
    h2, w2 = h // 2, w // 2
    x = x[:, :h2 * 2, :w2 * 2]
    return x.reshape(m, h2, 2, w2, 2, c).mean(dim=(2, 4))


def corr_pyramid(fmaps: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """fmaps [B, S, H, W, C] -> ``num_levels`` maps [B*S, h, w, C]."""
    b, s, h, w, c = fmaps.shape
    cur = fmaps.reshape(b * s, h, w, c)
    pyr = [cur]
    for _ in range(num_levels - 1):
        cur = avg_pool2(cur)
        pyr.append(cur)
    return pyr


def corr_sample(pyramid: List[torch.Tensor], targets: torch.Tensor,
                coords: torch.Tensor, radius: int,
                collapse_unit_axes: bool = False) -> torch.Tensor:
    """targets [B, S, N, C], coords [B, S, N, 2] at full resolution ->
    [B, S, N, L * (2r+1)^2]. ``collapse_unit_axes`` is the SfM tracker's
    sampling: a level with an axis of size 1 is read at pixel 0 of that
    axis for any coordinate."""
    b, s, n, c = targets.shape
    k2 = (2 * radius + 1) ** 2
    delta = delta_grid(radius, targets.device)
    out = []
    for i, fm in enumerate(pyramid):
        hh, ww = fm.shape[1:3]
        fmap2 = fm.reshape(b, s, hh * ww, c)
        corr = torch.einsum("bsnc,bspc->bsnp", targets.float(),
                            fmap2.float()) / math.sqrt(c)
        corr = corr.reshape(b * s * n, hh, ww, 1)
        pts = coords.reshape(b * s * n, 1, 2) / (2.0 ** i) + delta[None]
        # grid_sample with align_corners collapses a size-1 axis to pixel 0
        # for any coordinate
        if collapse_unit_axes and ww == 1:
            pts = torch.cat([torch.zeros_like(pts[..., :1]), pts[..., 1:]],
                            dim=-1)
        if collapse_unit_axes and hh == 1:
            pts = torch.cat([pts[..., :1], torch.zeros_like(pts[..., 1:])],
                            dim=-1)
        samp = bilinear_sample(corr, pts, padding="zeros")
        out.append(samp.reshape(b, s, n, k2))
    return torch.cat(out, dim=-1)


# -------------------------------------------------------------- predictor


def init_track_predictor(gen: torch.Generator, cfg: TrackHeadConfig,
                         dtype=torch.float32) -> dict:
    lat = cfg.features
    dev = gen.device
    corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    return {
        "corr_mlp": mlp_init(gen, corr_dim, cfg.hidden_size, dtype,
                             out_dim=lat),
        "query_ref_token": P.normal(gen, (1, 2, cfg.transformer_dim)
                                    ).to(dtype),
        "updateformer": init_updateformer(gen, cfg, dtype),
        "fmap_norm": P.layer_norm_init(lat, dtype=dtype, device=dev),
        "ffeat_norm": P.group_norm_init(lat, dtype=dtype, device=dev),
        "ffeat_updater": P.dense_init(gen, lat, lat, dtype=dtype),
        "vis_predictor": P.dense_init(gen, lat, 1, dtype=dtype),
        "conf_predictor": P.dense_init(gen, lat, 1, dtype=dtype),
    }


def pin_query_frame(coords: torch.Tensor, coords0: torch.Tensor
                    ) -> torch.Tensor:
    """coords with frame 0 set to ``coords0``'s frame 0, on a copy (JAX's
    ``coords.at[:, 0].set(coords0[:, 0])``)."""
    out = coords.clone()
    out[:, 0] = coords0[:, 0]
    return out


def track_predictor_forward(p, cfg: TrackHeadConfig,
                            query_points: torch.Tensor, fmaps: torch.Tensor,
                            iters: Optional[int] = None,
                            apply_sigmoid: bool = True):
    """query_points [B, N, 2] (x, y in image pixels), fmaps [B, S, HH, WW,
    C] -> (coord_preds: a list of [B, S, N, 2] in image pixels, vis
    [B, S, N], conf [B, S, N])."""
    b, n, _ = query_points.shape
    s, hh, ww = fmaps.shape[1:4]
    lat = cfg.features
    iters = cfg.iters if iters is None else iters

    fmaps = P.layer_norm(p["fmap_norm"], fmaps.float(), eps=_EPS)
    qp = query_points.float() / float(cfg.stride)
    coords = qp[:, None].expand(b, s, n, 2)
    coords0 = coords

    query_feat = bilinear_sample(fmaps[:, 0], qp, padding="border")
    track_feats = query_feat[:, None].expand(b, s, n, lat)

    pyramid = corr_pyramid(fmaps, cfg.corr_levels)
    qrt = p["query_ref_token"].float()
    qref = torch.cat([qrt[:, 0:1],
                      qrt[:, 1:2].expand(1, s - 1, cfg.transformer_dim)],
                     dim=1)                                   # [1, S, D]

    coord_preds = []
    for _ in range(iters):
        coords = coords.detach()
        fcorrs = corr_sample(pyramid, track_feats, coords, cfg.corr_radius)
        fcorrs_ = mlp(p["corr_mlp"],
                      fcorrs.transpose(1, 2).reshape(b * n, s, -1))
        flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(b * n, s,
                                                                  2)
        femb = torch.cat([flow_embedding(flows, lat // 2),
                          flows / cfg.max_scale, flows / cfg.max_scale],
                         dim=-1)
        tfeats_ = track_feats.transpose(1, 2).reshape(b * n, s, lat)
        x = torch.cat([femb, fcorrs_, tfeats_], dim=-1)

        x = x + sample_pos_grid(cfg.transformer_dim, hh, ww,
                                coords[:, 0]).reshape(b * n, 1, -1) + qref
        delta = updateformer_forward(p["updateformer"], cfg,
                                     x.reshape(b, n, s, -1))
        delta = delta.reshape(b * n, s, -1)
        dcoords, dfeats = delta[..., :2], delta[..., 2:]

        upd = P.dense(p["ffeat_updater"],
                      P.group_norm(p["ffeat_norm"],
                                   dfeats.reshape(b * n * s, lat),
                                   groups=1, eps=_EPS))
        tfeats_ = F.gelu(upd) + tfeats_.reshape(b * n * s, lat)
        track_feats = tfeats_.reshape(b, n, s, lat).transpose(1, 2)

        coords = coords + dcoords.reshape(b, n, s, 2).transpose(1, 2)
        coords = pin_query_frame(coords, coords0)
        coord_preds.append(coords * cfg.stride)

    flat = track_feats.reshape(b * s * n, lat)
    vis = P.dense(p["vis_predictor"], flat).reshape(b, s, n)
    conf = (P.dense(p["conf_predictor"], flat).reshape(b, s, n)
            if cfg.predict_conf else None)
    if apply_sigmoid:
        vis = torch.sigmoid(vis)
        conf = torch.sigmoid(conf) if conf is not None else None
    return coord_preds, vis, conf


# -------------------------------------------------------------- track head


def init_track_head(gen: torch.Generator, cfg: TrackHeadConfig,
                    dtype=torch.float32) -> dict:
    return {"feature_extractor": init_dpt_head(gen, cfg.dpt, dtype),
            "tracker": init_track_predictor(gen, cfg, dtype)}


def track_head_forward(params, cfg: TrackHeadConfig,
                       tapped_tokens: List[torch.Tensor],
                       img_hw: Tuple[int, int], patch_start_idx: int,
                       query_points: torch.Tensor,
                       iters: Optional[int] = None):
    """tapped_tokens: 4 x [B, S, P, 2C] aggregator taps -> (coord_preds,
    vis, conf). The features come out at half resolution (``down_ratio``
    2) and the tracker's stride 2 maps query pixels onto them."""
    fmaps = dpt_head_forward(params["feature_extractor"], cfg.dpt,
                             tapped_tokens, img_hw, patch_start_idx)
    return track_predictor_forward(params["tracker"], cfg, query_points,
                                   fmaps, iters=iters)
