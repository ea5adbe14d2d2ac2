"""VGGSfM tracker: a coarse CNN + iterative predictor, then a fine patch
refinement.

Counterpart of ``worldforge_tpu/sfm/tracker.py``, NHWC, fp32, the same
param tree:

  - ``basic_encoder_forward``: the RAFT-style instance-norm residual CNN
    with its 4-scale concat; ``shallow_encoder_forward`` for 31x31
    patches; strided convs pad symmetrically, as torch does;
  - the predictor: raw multi-scale correlations (no correlation MLP),
    [flow embedding || flow || correlations || features] zero-padded to a
    fixed width, an updateformer without input / output norms whose
    attention blocks use non-affine LayerNorms (eps 1e-6) and whose
    cross blocks' context norm is affine (eps 1e-5); a visibility head on
    the coarse predictor only. A size-1 correlation axis reads pixel 0
    for any coordinate, as ``grid_sample`` does and JAX keeps;
  - ``refine_track``: 31x31 patches around the floored coarse track,
    the top-left corner clamped to [0, H - 31] in both coordinates (the
    reference assumes H = W; so does the port), the fine predictor at
    stride 1, frame 0 pinned to the query.

Everything runs on the device of its inputs without reading a value back
to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.models.vggt.track import (corr_pyramid,
                                                    corr_sample,
                                                    flow_embedding, mha,
                                                    mha_init, mlp, mlp_init,
                                                    pin_query_frame,
                                                    sample_pos_grid)
from worldforge_tpu_torch.ops.sampling import (bilinear_sample,
                                               resize_align_corners)

_EPS_LN = 1e-6   # the non-affine LayerNorms' eps


# ----------------------------------------------------------- CNN encoders


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free InstanceNorm2d over [B, H, W, C]."""
    var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _conv_init(gen, cin, cout, k, dtype):
    return P.conv_init(gen, cin, cout, (k, k), dtype=dtype)


def _res_block_init(gen, cin, cout, stride, dtype):
    p = {"conv1": _conv_init(gen, cin, cout, 3, dtype),
         "conv2": _conv_init(gen, cout, cout, 3, dtype)}
    if stride != 1:
        p["down"] = _conv_init(gen, cin, cout, 1, dtype)
    return p


def _res_block(p, x, stride):
    """Instance norm, relu(x + y)."""
    y = F.relu(_instance_norm(P.conv(p["conv1"], x, stride=stride,
                                     padding=1)))
    y = F.relu(_instance_norm(P.conv(p["conv2"], y, padding=1)))
    if "down" in p:
        x = _instance_norm(P.conv(p["down"], x, stride=stride))
    return F.relu(x + y)


def init_basic_encoder(gen: torch.Generator, dtype=torch.float32,
                       output_dim: int = 128) -> dict:
    d = output_dim
    dims = [d // 2, d // 4 * 3, d, d]
    p = {"conv1": _conv_init(gen, 3, d // 2, 7, dtype)}
    cin = d // 2
    for i, dim in enumerate(dims, start=1):
        p[f"layer{i}a"] = _res_block_init(gen, cin, dim, 1 if i == 1 else 2,
                                          dtype)
        p[f"layer{i}b"] = _res_block_init(gen, dim, dim, 1, dtype)
        cin = dim
    p["conv2"] = _conv_init(gen, sum(dims), 2 * d, 3, dtype)
    p["conv3"] = _conv_init(gen, 2 * d, d, 1, dtype)
    return p


def basic_encoder_forward(p, x: torch.Tensor, stride: int = 4
                          ) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H/stride, W/stride, 128]."""
    hh, ww = x.shape[1:3]
    h_out, w_out = hh // stride, ww // stride
    x = F.relu(_instance_norm(P.conv(p["conv1"], x, stride=2, padding=3)))
    feats = []
    for i in range(1, 5):
        x = _res_block(p[f"layer{i}a"], x, 1 if i == 1 else 2)
        x = _res_block(p[f"layer{i}b"], x, 1)
        feats.append(resize_align_corners(x, h_out, w_out))
    y = F.relu(_instance_norm(P.conv(p["conv2"], torch.cat(feats, dim=-1),
                                     padding=1)))
    return P.conv(p["conv3"], y)


def init_shallow_encoder(gen: torch.Generator, dtype=torch.float32,
                         output_dim: int = 32) -> dict:
    return {"conv1": _conv_init(gen, 3, output_dim, 3, dtype),
            "layer1": _res_block_init(gen, output_dim, output_dim, 2, dtype),
            "layer2": _res_block_init(gen, output_dim, output_dim, 2, dtype),
            "conv2": _conv_init(gen, output_dim, output_dim, 1, dtype)}


def shallow_encoder_forward(p, x: torch.Tensor,
                            stride: int = 1) -> torch.Tensor:
    """Patches [B, P, P, 3] -> [B, P/stride, P/stride, 32]."""
    hh, ww = x.shape[1:3]
    x = F.relu(_instance_norm(P.conv(p["conv1"], x, stride=2, padding=1)))
    tmp = _res_block(p["layer1"], x, 2)
    x = x + resize_align_corners(tmp, x.shape[1], x.shape[2])
    tmp = _res_block(p["layer2"], tmp, 2)
    x = x + resize_align_corners(tmp, x.shape[1], x.shape[2])
    x = P.conv(p["conv2"], x) + x
    return resize_align_corners(x, hh // stride, ww // stride)


# ------------------------------------------------------------- predictor


@dataclasses.dataclass(frozen=True)
class SfmTrackerConfig:
    stride: int = 4
    corr_levels: int = 5
    corr_radius: int = 4
    latent_dim: int = 128
    hidden_size: int = 384
    depth: int = 6
    num_heads: int = 8
    num_virtual: int = 64
    mlp_ratio: float = 4.0
    fine: bool = False
    use_spaceatt: bool = True

    @property
    def corr_dim(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @property
    def transformer_dim(self) -> int:
        """The reference's padding rule: the coarse width up to a multiple
        of 4, the fine width + 4 (even) or + 5 (odd)."""
        d = self.corr_dim + 2 * self.latent_dim
        if self.fine:
            return d + (4 if d % 2 == 0 else 5)
        return d + (4 - d % 4) % 4

    @classmethod
    def coarse(cls) -> "SfmTrackerConfig":
        return cls()

    @classmethod
    def fine_cfg(cls) -> "SfmTrackerConfig":
        return cls(stride=1, depth=4, corr_levels=3, corr_radius=3,
                   latent_dim=32, hidden_size=256, fine=True,
                   use_spaceatt=False)


def _attn_block_na_init(gen, dim, mlp_ratio, dtype, cross=False):
    p = {"attn": mha_init(gen, dim, dtype),
         "mlp": mlp_init(gen, dim, int(dim * mlp_ratio), dtype)}
    if cross:
        p["norm_ctx"] = P.layer_norm_init(dim, dtype=dtype,
                                          device=gen.device)
    return p


def _ln_na(x):
    return P.layer_norm({}, x.float(), eps=_EPS_LN)


def _attn_block_na(p, x, num_heads):
    """Self-attention block with non-affine norms; the residual adds to
    the normed x."""
    x = _ln_na(x)
    x = x + mha(p["attn"], x, x, num_heads)
    return x + mlp(p["mlp"], _ln_na(x))


def _cross_block_na(p, x, ctx, num_heads):
    """Cross-attention block: non-affine norm1 / norm2, an affine context
    norm with eps 1e-5."""
    x = _ln_na(x)
    ctx = P.layer_norm(p["norm_ctx"], ctx.float(), eps=1e-5)
    x = x + mha(p["attn"], x, ctx, num_heads)
    return x + mlp(p["mlp"], _ln_na(x))


def init_sfm_updateformer(gen: torch.Generator, cfg: SfmTrackerConfig,
                          dtype=torch.float32) -> dict:
    h = cfg.hidden_size
    p = {"input_transform": P.dense_init(gen, cfg.transformer_dim, h,
                                         dtype=dtype),
         "time_blocks": [_attn_block_na_init(gen, h, cfg.mlp_ratio, dtype)
                         for _ in range(cfg.depth)],
         "flow_head": P.dense_init(gen, h, cfg.latent_dim + 2, dtype=dtype)}
    if cfg.use_spaceatt:
        p["virtual"] = P.normal(gen, (1, cfg.num_virtual, 1, h)).to(dtype)
        p["space_virtual"] = [_attn_block_na_init(gen, h, cfg.mlp_ratio,
                                                  dtype)
                              for _ in range(cfg.depth)]
        p["v2p"] = [_attn_block_na_init(gen, h, cfg.mlp_ratio, dtype,
                                        cross=True)
                    for _ in range(cfg.depth)]
        p["p2v"] = [_attn_block_na_init(gen, h, cfg.mlp_ratio, dtype,
                                        cross=True)
                    for _ in range(cfg.depth)]
    return p


def sfm_updateformer_forward(p, cfg: SfmTrackerConfig,
                             x: torch.Tensor) -> torch.Tensor:
    """x [B, N, T, D] -> delta [B, N, T, latent + 2]."""
    b, n, t, _ = x.shape
    nh = cfg.num_heads
    tokens = P.dense(p["input_transform"], x)
    init_tokens = tokens
    ntot = n
    if cfg.use_spaceatt:
        virt = p["virtual"].float().expand(b, cfg.num_virtual, t,
                                           cfg.hidden_size)
        tokens = torch.cat([tokens, virt], dim=1)
        ntot = n + cfg.num_virtual
    for i in range(cfg.depth):
        tt = _attn_block_na(p["time_blocks"][i],
                            tokens.reshape(b * ntot, t, -1), nh)
        tokens = tt.reshape(b, ntot, t, -1)
        if cfg.use_spaceatt:
            st = tokens.transpose(1, 2).reshape(b * t, ntot, -1)
            pts, virt = st[:, :n], st[:, n:]
            virt = _cross_block_na(p["v2p"][i], virt, pts, nh)
            virt = _attn_block_na(p["space_virtual"][i], virt, nh)
            pts = _cross_block_na(p["p2v"][i], pts, virt, nh)
            st = torch.cat([pts, virt], dim=1)
            tokens = st.reshape(b, t, ntot, -1).transpose(1, 2)
    tokens = tokens[:, :n] + init_tokens
    return P.dense(p["flow_head"], tokens)


def init_sfm_predictor(gen: torch.Generator, cfg: SfmTrackerConfig,
                       dtype=torch.float32) -> dict:
    lat = cfg.latent_dim
    p = {"updateformer": init_sfm_updateformer(gen, cfg, dtype),
         "norm": P.group_norm_init(lat, dtype=dtype, device=gen.device),
         "ffeat_updater": P.dense_init(gen, lat, lat, dtype=dtype)}
    if not cfg.fine:
        p["vis_predictor"] = P.dense_init(gen, lat, 1, dtype=dtype)
    return p


def sfm_predictor_forward(p, cfg: SfmTrackerConfig,
                          query_points: torch.Tensor, fmaps: torch.Tensor,
                          iters: int = 4, down_ratio: int = 1,
                          return_feat: bool = False):
    """query_points [B, N, 2] image pixels, fmaps [B, S, HH, WW, C] ->
    (coord_preds: a list of [B, S, N, 2] in image pixels, vis [B, S, N] or
    None on the fine predictor)."""
    b, n, _ = query_points.shape
    s, hh, ww = fmaps.shape[1:4]
    lat = cfg.latent_dim
    fmaps = fmaps.float()
    qp = query_points.float()
    if down_ratio > 1:
        qp = qp / down_ratio
    qp = qp / cfg.stride
    coords = qp[:, None].expand(b, s, n, 2)
    coords0 = coords
    query_feat = bilinear_sample(fmaps[:, 0], qp, padding="border")
    track_feats = query_feat[:, None].expand(b, s, n, lat)

    pyramid = corr_pyramid(fmaps, cfg.corr_levels)

    coord_preds = []
    for _ in range(iters):
        coords = coords.detach()
        fcorrs = corr_sample(pyramid, track_feats, coords, cfg.corr_radius,
                             collapse_unit_axes=True)
        fcorrs_ = fcorrs.transpose(1, 2).reshape(b * n, s, -1)
        flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(b * n, s,
                                                                  2)
        femb = torch.cat([flow_embedding(flows, lat // 2), flows], dim=-1)
        tfeats_ = track_feats.transpose(1, 2).reshape(b * n, s, lat)
        x = torch.cat([femb, fcorrs_, tfeats_], dim=-1)
        pad = cfg.transformer_dim - x.shape[-1]
        if pad > 0:
            x = F.pad(x, (0, pad))
        x = x + sample_pos_grid(cfg.transformer_dim, hh, ww,
                                coords[:, 0]).reshape(b * n, 1, -1)
        delta_out = sfm_updateformer_forward(p["updateformer"], cfg,
                                             x.reshape(b, n, s, -1))
        delta_out = delta_out.reshape(b * n, s, -1)
        dcoords, dfeats = delta_out[..., :2], delta_out[..., 2:]
        upd = P.dense(p["ffeat_updater"],
                      P.group_norm(p["norm"],
                                   dfeats.reshape(b * n * s, lat),
                                   groups=1, eps=1e-5))
        tfeats_ = F.gelu(upd) + tfeats_.reshape(b * n * s, lat)
        track_feats = tfeats_.reshape(b, n, s, lat).transpose(1, 2)
        coords = coords + dcoords.reshape(b, n, s, 2).transpose(1, 2)
        coords = pin_query_frame(coords, coords0)
        coord_preds.append(coords * cfg.stride * down_ratio)

    vis = None
    if not cfg.fine:
        vis = torch.sigmoid(P.dense(p["vis_predictor"],
                                    track_feats.reshape(b * s * n, lat)
                                    ).reshape(b, s, n))
    if return_feat:
        return coord_preds, vis, track_feats, query_feat
    return coord_preds, vis


# ----------------------------------------------------------- refine_track


def extract_patches(images: torch.Tensor, topleft: torch.Tensor,
                    psize: int) -> torch.Tensor:
    """images [M, H, W, C], topleft [M, N, 2] integer (x, y), already
    clamped -> patches [M, N, psize, psize, C]."""
    m, hh, ww, c = images.shape
    n = topleft.shape[1]
    d = torch.arange(psize, device=images.device)
    ys = topleft[..., 1][..., None] + d                       # [M, N, P]
    xs = topleft[..., 0][..., None] + d
    idx = (ys[..., :, None] * ww + xs[..., None, :]).reshape(m, -1, 1)
    out = torch.gather(images.reshape(m, hh * ww, c), 1,
                       idx.expand(-1, -1, c))
    return out.reshape(m, n, psize, psize, c)


def refine_track(images: torch.Tensor, fine_fnet_params,
                 fine_predictor_params, coarse_pred: torch.Tensor,
                 fine_cfg: Optional[SfmTrackerConfig] = None,
                 pradius: int = 15, fine_iters: int = 6) -> torch.Tensor:
    """images [B, S, H, W, 3] in [0, 1], coarse tracks [B, S, N, 2] ->
    refined tracks [B, S, N, 2]."""
    fine_cfg = fine_cfg or SfmTrackerConfig.fine_cfg()
    b, s, hh, ww, _ = images.shape
    n = coarse_pred.shape[2]
    psize = 2 * pradius + 1
    query_points = coarse_pred[:, 0]

    track_int = torch.floor(coarse_pred)
    track_frac = coarse_pred - track_int
    topleft_bsn = track_int.long() - pradius
    # both coordinates clamped by H, as the reference (H = W) does
    topleft = topleft_bsn.clamp(0, hh - psize).reshape(b * s, n, 2)

    patches = extract_patches(images.reshape(b * s, hh, ww, 3), topleft,
                              psize)
    feats = shallow_encoder_forward(
        fine_fnet_params, patches.reshape(b * s * n, psize, psize, 3),
        stride=fine_cfg.stride)
    fh = feats.shape[1]
    feats = feats.reshape(b, s, n, fh, fh, -1).transpose(1, 2)
    feats = feats.reshape(b * n, s, fh, fh, -1)

    patch_queries = (track_frac[:, 0] + pradius).reshape(b * n, 1, 2)
    preds, _ = sfm_predictor_forward(fine_predictor_params, fine_cfg,
                                     patch_queries, feats, iters=fine_iters)
    fine = preds[-1].reshape(b, n, s, 1, 2)[:, :, :, 0]
    fine = fine.transpose(1, 2) + topleft_bsn
    fine = fine.clone()
    fine[:, 0] = query_points
    return fine


# -------------------------------------------------------------- top level


def init_sfm_tracker(gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random init on ``gen.device``: the coarse and fine encoders and
    predictors at the published widths."""
    return {"coarse_fnet": init_basic_encoder(gen, dtype),
            "coarse_predictor": init_sfm_predictor(
                gen, SfmTrackerConfig.coarse(), dtype),
            "fine_fnet": init_shallow_encoder(gen, dtype),
            "fine_predictor": init_sfm_predictor(
                gen, SfmTrackerConfig.fine_cfg(), dtype)}


def compute_tracker_fmaps(params, images: torch.Tensor,
                          coarse_down_ratio: int = 2) -> torch.Tensor:
    """The coarse encoder's feature maps of the whole sequence, computed
    once and reused by every query frame and chunk: images [B, S, H, W, 3]
    -> fmaps [B, S, HH, WW, C]."""
    b, s, hh, ww, _ = images.shape
    imgs = images.float().reshape(b * s, hh, ww, 3)
    if coarse_down_ratio > 1:
        imgs = resize_align_corners(imgs, hh // coarse_down_ratio,
                                    ww // coarse_down_ratio)
    fmaps = basic_encoder_forward(params["coarse_fnet"], imgs,
                                  stride=SfmTrackerConfig.coarse().stride)
    return fmaps.reshape(b, s, *fmaps.shape[1:])


def sfm_tracker_forward(params, images: torch.Tensor,
                        query_points: torch.Tensor, coarse_iters: int = 6,
                        fine_tracking: bool = True,
                        coarse_down_ratio: int = 2,
                        fmaps: Optional[torch.Tensor] = None):
    """images [B, S, H, W, 3] in [0, 1], query_points [B, N, 2] ->
    (fine_track, coarse_track, vis). With ``fmaps`` (from
    ``compute_tracker_fmaps``) the coarse encoder is skipped and the
    images feed only the fine refinement."""
    if fmaps is None:
        fmaps = compute_tracker_fmaps(params, images,
                                      coarse_down_ratio=coarse_down_ratio)
    preds, vis = sfm_predictor_forward(params["coarse_predictor"],
                                       SfmTrackerConfig.coarse(),
                                       query_points, fmaps,
                                       iters=coarse_iters,
                                       down_ratio=coarse_down_ratio)
    coarse = preds[-1]
    if fine_tracking:
        fine = refine_track(images.float(), params["fine_fnet"],
                            params["fine_predictor"], coarse)
    else:
        fine = coarse
    return fine, coarse, vis
