"""VGGT (facebook/VGGT-1B) checkpoint conversion.

Counterpart of ``worldforge_tpu/io/convert_vggt.py``: the aggregator with
its DINOv2 backbone, the camera head, the depth head, and the world-point
and track heads when the checkpoint has them (``convert_track_head`` :212:
the feature-only DPT extractor and ``convert_track_predictor`` :128, the
updateformer's ``virual_tracks`` (sic) and its four block lists).
"""

from __future__ import annotations

import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import (conv, deconv_to_hwio, dense,
                                                layer_norm, load_state_dict,
                                                to_leaf)
from worldforge_tpu_torch.models.vggt.model import VGGTConfig


def _vit_block(sd, prefix, dtype, dev, qk_norm=False):
    p = {
        "norm1": layer_norm(sd, f"{prefix}.norm1", dtype, dev),
        "qkv": dense(sd, f"{prefix}.attn.qkv", dtype, dev),
        "proj": dense(sd, f"{prefix}.attn.proj", dtype, dev),
        "ls1": {"gamma": to_leaf(sd[f"{prefix}.ls1.gamma"], dtype, dev)},
        "norm2": layer_norm(sd, f"{prefix}.norm2", dtype, dev),
        "fc1": dense(sd, f"{prefix}.mlp.fc1", dtype, dev),
        "fc2": dense(sd, f"{prefix}.mlp.fc2", dtype, dev),
        "ls2": {"gamma": to_leaf(sd[f"{prefix}.ls2.gamma"], dtype, dev)},
    }
    if qk_norm:
        p["q_norm"] = layer_norm(sd, f"{prefix}.attn.q_norm", dtype, dev)
        p["k_norm"] = layer_norm(sd, f"{prefix}.attn.k_norm", dtype, dev)
    return p


def convert_vggt_aggregator(sd, cfg: VGGTConfig, dtype=torch.float32,
                            prefix: str = "aggregator",
                            device=None) -> dict:
    """Aggregator (+ DINOv2 backbone) weights -> the port's aggregator tree
    (JAX ``convert_vggt_aggregator``, :45); ``prefix=''`` for a bare
    Aggregator state dict. The DINOv2 patch conv [out, 3, 14, 14] becomes
    a dense [(ph pw c), out]."""
    dev = resolve_device(device)
    agg = f"{prefix}." if prefix else ""
    pe = f"{agg}patch_embed"
    backbone = {
        "patch": {"w": to_leaf(
            sd[f"{pe}.patch_embed.proj.weight"], dtype, dev,
            lambda w: w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])),
            "b": to_leaf(sd[f"{pe}.patch_embed.proj.bias"], dtype, dev)},
        "cls": to_leaf(sd[f"{pe}.cls_token"], dtype, dev),
        "registers": to_leaf(sd[f"{pe}.register_tokens"], dtype, dev),
        "pos": to_leaf(sd[f"{pe}.pos_embed"], dtype, dev),
        "blocks": [_vit_block(sd, f"{pe}.blocks.{i}", dtype, dev)
                   for i in range(cfg.backbone.depth)],
        "norm": layer_norm(sd, f"{pe}.norm", dtype, dev),
    }
    return {
        "backbone": backbone,
        "camera_token": to_leaf(sd[f"{agg}camera_token"], dtype, dev),
        "register_token": to_leaf(sd[f"{agg}register_token"], dtype, dev),
        "frame_blocks": [
            _vit_block(sd, f"{agg}frame_blocks.{i}", dtype, dev, True)
            for i in range(cfg.depth)],
        "global_blocks": [
            _vit_block(sd, f"{agg}global_blocks.{i}", dtype, dev, True)
            for i in range(cfg.depth)],
    }


def _convert_dpt(sd, prefix: str, dtype, dev,
                 feature_only: bool = False) -> dict:
    """A DPT head (JAX ``_convert_dpt``, :165): the resize deconvs in the
    flipped HWIO layout; refinenet4's missing first residual unit as
    zeros; no ``output_conv2`` for a feature-only head (the track head's
    extractor)."""
    def cv(name, bias=True):
        return conv(sd, name, dtype, dev,
                    bias=bias and f"{name}.bias" in sd)

    def dcv(name):
        return {"w": to_leaf(sd[f"{name}.weight"], dtype, dev,
                             deconv_to_hwio),
                "b": to_leaf(sd[f"{name}.bias"], dtype, dev)}

    head = {
        "norm": layer_norm(sd, f"{prefix}.norm", dtype, dev),
        "projects": [cv(f"{prefix}.projects.{i}") for i in range(4)],
        "resize0": dcv(f"{prefix}.resize_layers.0"),
        "resize1": dcv(f"{prefix}.resize_layers.1"),
        "resize3": cv(f"{prefix}.resize_layers.3"),
        "layer_rn": [cv(f"{prefix}.scratch.layer{i}_rn", bias=False)
                     for i in (1, 2, 3, 4)],
        "out_conv1": cv(f"{prefix}.scratch.output_conv1"),
    }
    if not feature_only:
        head["out_conv2a"] = cv(f"{prefix}.scratch.output_conv2.0")
        head["out_conv2b"] = cv(f"{prefix}.scratch.output_conv2.2")
    f = head["layer_rn"][0]["w"].shape[-1]
    for i in range(1, 5):
        rn = f"{prefix}.scratch.refinenet{i}"
        rcu = {}
        if f"{rn}.resConfUnit1.conv1.weight" in sd:
            rcu["rcu1_conv1"] = cv(f"{rn}.resConfUnit1.conv1")
            rcu["rcu1_conv2"] = cv(f"{rn}.resConfUnit1.conv2")
        else:   # refinenet4 has no residual unit 1
            for k in ("rcu1_conv1", "rcu1_conv2"):
                rcu[k] = {"w": torch.zeros((3, 3, f, f), dtype=dtype,
                                           device=dev),
                          "b": torch.zeros((f,), dtype=dtype, device=dev)}
        rcu["rcu2_conv1"] = cv(f"{rn}.resConfUnit2.conv1")
        rcu["rcu2_conv2"] = cv(f"{rn}.resConfUnit2.conv2")
        rcu["out"] = cv(f"{rn}.out_conv")
        head[f"refine{i}"] = rcu
    return head


def convert_vggt(sd, cfg: VGGTConfig, dtype=torch.float32,
                 device=None, point_and_track: bool = True) -> dict:
    """A VGGT state dict -> the port's tree (JAX ``convert_vggt``, :83):
    aggregator, camera head, depth head, and, unless ``point_and_track``
    is false, the point head when the checkpoint has ``point_head.*`` and
    the track head when it has ``track_head.*``."""
    dev = resolve_device(device)
    ch = "camera_head"
    camera = {
        "trunk": [_vit_block(sd, f"{ch}.trunk.{i}", dtype, dev)
                  for i in range(4)],
        "token_norm": layer_norm(sd, f"{ch}.token_norm", dtype, dev),
        "trunk_norm": layer_norm(sd, f"{ch}.trunk_norm", dtype, dev),
        "empty_pose": to_leaf(sd[f"{ch}.empty_pose_tokens"], dtype, dev),
        "embed_pose": dense(sd, f"{ch}.embed_pose", dtype, dev),
        "mod": dense(sd, f"{ch}.poseLN_modulation.1", dtype, dev),
        "branch_fc1": dense(sd, f"{ch}.pose_branch.fc1", dtype, dev),
        "branch_fc2": dense(sd, f"{ch}.pose_branch.fc2", dtype, dev),
    }
    out = {"aggregator": convert_vggt_aggregator(sd, cfg, dtype,
                                                 device=dev),
           "camera_head": camera,
           "depth_head": _convert_dpt(sd, "depth_head", dtype, dev)}
    if not point_and_track:
        return out
    if "point_head.norm.weight" in sd:
        out["point_head"] = _convert_dpt(sd, "point_head", dtype, dev)
    if "track_head.tracker.fmap_norm.weight" in sd:
        out["track_head"] = convert_track_head(sd, dtype=dtype, device=dev)
    return out


def _mha(sd, name, dtype, dev):
    """torch nn.MultiheadAttention -> a fused in-projection [D, 3D] and an
    out-projection."""
    return {"in_proj": {"w": to_leaf(sd[f"{name}.in_proj_weight"], dtype,
                                     dev, torch.t),
                        "b": to_leaf(sd[f"{name}.in_proj_bias"], dtype,
                                     dev)},
            "out_proj": dense(sd, f"{name}.out_proj", dtype, dev)}


def _attn_block(sd, prefix, dtype, dev, attn="attn"):
    p = {"norm1": layer_norm(sd, f"{prefix}.norm1", dtype, dev),
         "norm2": layer_norm(sd, f"{prefix}.norm2", dtype, dev),
         "attn": _mha(sd, f"{prefix}.{attn}", dtype, dev),
         "mlp": {"fc1": dense(sd, f"{prefix}.mlp.fc1", dtype, dev),
                 "fc2": dense(sd, f"{prefix}.mlp.fc2", dtype, dev)}}
    if f"{prefix}.norm_context.weight" in sd:
        p["norm_ctx"] = layer_norm(sd, f"{prefix}.norm_context", dtype, dev)
    return p


def convert_track_predictor(sd, depth: int, prefix: str = "",
                            dtype=torch.float32, device=None) -> dict:
    """BaseTrackerPredictor weights -> ``models/vggt/track.py``'s tree
    (JAX :128); ``prefix`` e.g. ``'track_head.tracker.'``."""
    dev = resolve_device(device)
    uf = f"{prefix}updateformer"

    def blocks(name, attn="attn"):
        return [_attn_block(sd, f"{uf}.{name}.{i}", dtype, dev, attn)
                for i in range(depth)]

    return {
        "corr_mlp": {"fc1": dense(sd, f"{prefix}corr_mlp.fc1", dtype, dev),
                     "fc2": dense(sd, f"{prefix}corr_mlp.fc2", dtype, dev)},
        "query_ref_token": to_leaf(sd[f"{prefix}query_ref_token"], dtype,
                                   dev),
        "updateformer": {
            "input_norm": layer_norm(sd, f"{uf}.input_norm", dtype, dev),
            "input_transform": dense(sd, f"{uf}.input_transform", dtype,
                                     dev),
            "virtual": to_leaf(sd[f"{uf}.virual_tracks"], dtype, dev),
            "time_blocks": blocks("time_blocks"),
            "space_virtual": blocks("space_virtual_blocks"),
            "v2p": blocks("space_virtual2point_blocks", "cross_attn"),
            "p2v": blocks("space_point2virtual_blocks", "cross_attn"),
            "output_norm": layer_norm(sd, f"{uf}.output_norm", dtype, dev),
            "flow_head": dense(sd, f"{uf}.flow_head", dtype, dev),
        },
        "fmap_norm": layer_norm(sd, f"{prefix}fmap_norm", dtype, dev),
        "ffeat_norm": layer_norm(sd, f"{prefix}ffeat_norm", dtype, dev),
        "ffeat_updater": dense(sd, f"{prefix}ffeat_updater.0", dtype, dev),
        "vis_predictor": dense(sd, f"{prefix}vis_predictor.0", dtype, dev),
        "conf_predictor": dense(sd, f"{prefix}conf_predictor.0", dtype, dev),
    }


def convert_track_head(sd, depth: int = 6, dtype=torch.float32,
                       device=None) -> dict:
    """The track head (JAX :212): the feature-only DPT extractor and the
    tracker."""
    dev = resolve_device(device)
    return {
        "feature_extractor": _convert_dpt(sd, "track_head.feature_extractor",
                                          dtype, dev, feature_only=True),
        "tracker": convert_track_predictor(sd, depth,
                                           prefix="track_head.tracker.",
                                           dtype=dtype, device=dev),
    }


def load_converted_vggt(path: str, cfg: VGGTConfig, device=None,
                        point_and_track: bool = True) -> dict:
    """``convert_vggt`` of a checkpoint file or directory (JAX :225)."""
    return convert_vggt(load_state_dict(path), cfg, device=device,
                        point_and_track=point_and_track)
