"""VGGT inference: image(s) -> depth + camera (the warp's first stage), and
world points and tracks.

Counterpart of ``worldforge_tpu/models/vggt/inference.py``
(``init_vggt_full`` :34, ``vggt_forward`` :59, ``vggt_estimate`` :97):
the camera and depth heads always, the world-point head (``inv_log``
points, ``expp1`` confidence) when the tree has one, and the track head
(``models/vggt/track.py``) when the tree has one and query points are
given.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.models.vggt.heads import (CameraHeadConfig,
                                                    DPTHeadConfig,
                                                    camera_head_forward,
                                                    dpt_head_forward,
                                                    init_camera_head,
                                                    init_dpt_head)
from worldforge_tpu_torch.models.vggt.model import (VGGTConfig,
                                                    init_vggt_aggregator,
                                                    vggt_aggregator_forward)
from worldforge_tpu_torch.models.vggt.track import (TrackHeadConfig,
                                                    init_track_head,
                                                    track_head_forward)
from worldforge_tpu_torch.models.vggt.utils import (
    load_and_preprocess_images, pose_encoding_to_extri_intri)


def point_head_config(cfg: VGGTConfig) -> DPTHeadConfig:
    """The world-point DPT head: xyz + confidence, ``inv_log`` points."""
    return DPTHeadConfig(dim_in=cfg.embed_dim * 2,
                         patch_size=cfg.patch_size, output_dim=4,
                         activation="inv_log", conf_activation="expp1")


def track_head_config(cfg: VGGTConfig) -> TrackHeadConfig:
    return TrackHeadConfig(dim_in=cfg.embed_dim * 2,
                           patch_size=cfg.patch_size)


def init_vggt_full(gen: torch.Generator, cfg: VGGTConfig,
                   dtype=torch.float32, enable_point: bool = False,
                   enable_track: bool = False) -> dict:
    """Random init on ``gen.device``: aggregator, camera head, depth head,
    and the world-point and track heads when asked for."""
    d2 = cfg.embed_dim * 2
    params = {
        "aggregator": init_vggt_aggregator(gen, cfg, dtype),
        "camera_head": init_camera_head(
            gen, CameraHeadConfig(dim_in=d2, num_heads=cfg.num_heads), dtype),
        "depth_head": init_dpt_head(
            gen, DPTHeadConfig(dim_in=d2, patch_size=cfg.patch_size), dtype),
    }
    if enable_point:
        params["point_head"] = init_dpt_head(gen, point_head_config(cfg),
                                             dtype)
    if enable_track:
        params["track_head"] = init_track_head(gen, track_head_config(cfg),
                                               dtype)
    return params


@torch.inference_mode()
def vggt_forward(params, cfg: VGGTConfig, images: torch.Tensor,
                 query_points: Optional[torch.Tensor] = None) -> dict:
    """images [B, S, 3, H, W] in [0, 1] -> pose_enc [B, S, 9], depth
    [B, S, H, W, 1], depth_conf [B, S, H, W]; world_points [B, S, H, W, 3]
    and world_points_conf with a point head; track [B, S, N, 2] (the last
    refinement), vis and track_conf [B, S, N] with a track head and
    query_points [B, N, 2]."""
    taps = vggt_aggregator_forward(params["aggregator"], cfg, images)
    d2 = cfg.embed_dim * 2
    pose_enc = camera_head_forward(
        params["camera_head"], CameraHeadConfig(dim_in=d2,
                                                num_heads=cfg.num_heads),
        taps[cfg.depth - 1][:, :, 0])
    tapped = [taps[i] for i in cfg.intermediate_layer_idx]
    hw = tuple(images.shape[-2:])
    depth, conf = dpt_head_forward(
        params["depth_head"], DPTHeadConfig(dim_in=d2,
                                            patch_size=cfg.patch_size),
        tapped, hw, cfg.patch_start_idx)
    out = {"pose_enc": pose_enc, "depth": depth, "depth_conf": conf}
    if "point_head" in params:
        out["world_points"], out["world_points_conf"] = dpt_head_forward(
            params["point_head"], point_head_config(cfg), tapped, hw,
            cfg.patch_start_idx)
    if "track_head" in params and query_points is not None:
        preds, out["vis"], out["track_conf"] = track_head_forward(
            params["track_head"], track_head_config(cfg), tapped, hw,
            cfg.patch_start_idx, query_points)
        out["track"] = preds[-1]
    return out


_DEPTH_CAMERA = ("aggregator", "camera_head", "depth_head")


def depth_and_camera(params, cfg: VGGTConfig, images: np.ndarray,
                     camera_index: int = 0, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """``vggt_forward`` on preprocessed images [S, 3, H, W] (one scene)
    -> (depth [H, W], conf [H, W], extrinsic [4, 4] w2c, intrinsic [3, 3])
    of frame ``camera_index``, on the host. Only the aggregator, camera
    and depth head are run: a point or track head in the tree is left
    alone."""
    dev = resolve_device(device)
    out = vggt_forward({k: params[k] for k in _DEPTH_CAMERA}, cfg,
                       torch.as_tensor(images, dtype=torch.float32,
                                       device=dev)[None])
    extr, intr = pose_encoding_to_extri_intri(
        out["pose_enc"].cpu().numpy(), images.shape[-2:])
    e44 = np.eye(4)
    e44[:3] = extr[0, camera_index]
    return (out["depth"][0, camera_index, :, :, 0].cpu().numpy(),
            out["depth_conf"][0, camera_index].cpu().numpy(), e44,
            intr[0, camera_index])


def vggt_estimate(image_paths: Union[str, List[str]],
                  checkpoint: Optional[str] = None, camera_index: int = 0,
                  device=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The warp's stage 1 from image files: the converted VGGT-1B
    checkpoint (``io/convert_vggt.py``) on ``device`` (the card by
    default), then ``depth_and_camera`` at the preprocessed size (518
    wide). The checkpoint's point and track heads are not converted: the
    warp reads neither. Without a checkpoint it stops with the JAX
    package's message."""
    if isinstance(image_paths, str):
        image_paths = [image_paths]
    images = load_and_preprocess_images(image_paths)
    if checkpoint is None:
        raise SystemExit(
            "VGGT weights required: pass --vggt_checkpoint (converted from "
            "facebook/VGGT-1B) or use --depth_npz with precomputed depth.")
    from worldforge_tpu_torch.io.convert_vggt import load_converted_vggt
    dev = resolve_device(device)
    cfg = VGGTConfig.vggt_1b()
    params = load_converted_vggt(checkpoint, cfg, device=dev,
                                 point_and_track=False)
    return depth_and_camera(params, cfg, images, camera_index, device=dev)
