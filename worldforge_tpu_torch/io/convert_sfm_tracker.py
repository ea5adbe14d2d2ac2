"""VGGSfM tracker checkpoint conversion (torch state dict -> the port's
tree).

Counterpart of ``worldforge_tpu/io/convert_sfm_tracker.py``: the coarse
BasicEncoder and predictor, the fine ShallowEncoder and predictor; the
attention blocks' non-affine norms have no weights, the cross blocks'
``norm_context`` has.
"""

from __future__ import annotations

import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import (conv, dense, layer_norm,
                                                to_leaf)
from worldforge_tpu_torch.sfm.tracker import SfmTrackerConfig


def _cv(sd, name, dtype, dev):
    return conv(sd, name, dtype, dev, bias=f"{name}.bias" in sd)


def _res(sd, name, dtype, dev):
    p = {"conv1": _cv(sd, f"{name}.conv1", dtype, dev),
         "conv2": _cv(sd, f"{name}.conv2", dtype, dev)}
    if f"{name}.downsample.0.weight" in sd:
        p["down"] = _cv(sd, f"{name}.downsample.0", dtype, dev)
    return p


def _mha(sd, name, dtype, dev):
    return {"in_proj": {"w": to_leaf(sd[f"{name}.in_proj_weight"], dtype,
                                     dev, torch.t),
                        "b": to_leaf(sd[f"{name}.in_proj_bias"], dtype,
                                     dev)},
            "out_proj": dense(sd, f"{name}.out_proj", dtype, dev)}


def _attn_na(sd, prefix, dtype, dev, attn="attn"):
    p = {"attn": _mha(sd, f"{prefix}.{attn}", dtype, dev),
         "mlp": {"fc1": dense(sd, f"{prefix}.mlp.fc1", dtype, dev),
                 "fc2": dense(sd, f"{prefix}.mlp.fc2", dtype, dev)}}
    if f"{prefix}.norm_context.weight" in sd:
        p["norm_ctx"] = layer_norm(sd, f"{prefix}.norm_context", dtype, dev)
    return p


def _updateformer(sd, prefix, cfg: SfmTrackerConfig, dtype, dev):
    def blocks(name, attn="attn"):
        return [_attn_na(sd, f"{prefix}.{name}.{i}", dtype, dev, attn)
                for i in range(cfg.depth)]

    p = {"input_transform": dense(sd, f"{prefix}.input_transform", dtype,
                                  dev),
         "flow_head": dense(sd, f"{prefix}.flow_head", dtype, dev),
         "time_blocks": blocks("time_blocks")}
    if cfg.use_spaceatt:
        p["virtual"] = to_leaf(sd[f"{prefix}.virual_tracks"], dtype, dev)
        p["space_virtual"] = blocks("space_virtual_blocks")
        p["v2p"] = blocks("space_virtual2point_blocks", "cross_attn")
        p["p2v"] = blocks("space_point2virtual_blocks", "cross_attn")
    return p


def _predictor(sd, prefix, cfg: SfmTrackerConfig, dtype, dev):
    p = {"updateformer": _updateformer(sd, f"{prefix}.updateformer", cfg,
                                       dtype, dev),
         "norm": layer_norm(sd, f"{prefix}.norm", dtype, dev),
         "ffeat_updater": dense(sd, f"{prefix}.ffeat_updater.0", dtype, dev)}
    if not cfg.fine:
        p["vis_predictor"] = dense(sd, f"{prefix}.vis_predictor.0", dtype,
                                   dev)
    return p


def convert_sfm_tracker(sd, dtype=torch.float32, device=None) -> dict:
    """A VGGSfM TrackerPredictor state dict -> ``sfm/tracker.py``'s tree
    (JAX :87)."""
    dev = resolve_device(device)
    coarse = {k: _cv(sd, f"coarse_fnet.{k}", dtype, dev)
              for k in ("conv1", "conv2", "conv3")}
    for i in range(1, 5):
        coarse[f"layer{i}a"] = _res(sd, f"coarse_fnet.layer{i}.0", dtype,
                                    dev)
        coarse[f"layer{i}b"] = _res(sd, f"coarse_fnet.layer{i}.1", dtype,
                                    dev)
    fine_fnet = {"conv1": _cv(sd, "fine_fnet.conv1", dtype, dev),
                 "layer1": _res(sd, "fine_fnet.layer1", dtype, dev),
                 "layer2": _res(sd, "fine_fnet.layer2", dtype, dev),
                 "conv2": _cv(sd, "fine_fnet.conv2", dtype, dev)}
    return {
        "coarse_fnet": coarse,
        "coarse_predictor": _predictor(sd, "coarse_predictor",
                                       SfmTrackerConfig.coarse(), dtype, dev),
        "fine_fnet": fine_fnet,
        "fine_predictor": _predictor(sd, "fine_predictor",
                                     SfmTrackerConfig.fine_cfg(), dtype,
                                     dev),
    }
