"""VGGT inference: image(s) -> depth + camera, the warp stage's first half.

Counterpart of ``worldforge_tpu/models/vggt/inference.py``
(``init_vggt_full`` :34, ``vggt_forward`` :59, ``vggt_estimate`` :97)
without the track branch, which comes with ``models/vggt/track.py``, and
the world-point head, which no path of the warp reads (a converted
checkpoint's point head is kept in the tree and not run).
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
from worldforge_tpu_torch.models.vggt.utils import (
    load_and_preprocess_images, pose_encoding_to_extri_intri)

def init_vggt_full(gen: torch.Generator, cfg: VGGTConfig,
                   dtype=torch.float32) -> dict:
    """Random init on ``gen.device``: aggregator, camera head and depth
    head."""
    d2 = cfg.embed_dim * 2
    return {
        "aggregator": init_vggt_aggregator(gen, cfg, dtype),
        "camera_head": init_camera_head(
            gen, CameraHeadConfig(dim_in=d2, num_heads=cfg.num_heads), dtype),
        "depth_head": init_dpt_head(
            gen, DPTHeadConfig(dim_in=d2, patch_size=cfg.patch_size), dtype),
    }


@torch.inference_mode()
def vggt_forward(params, cfg: VGGTConfig, images: torch.Tensor) -> dict:
    """images [B, S, 3, H, W] in [0, 1] -> pose_enc [B, S, 9], depth
    [B, S, H, W, 1], depth_conf [B, S, H, W]."""
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
    return {"pose_enc": pose_enc, "depth": depth, "depth_conf": conf}


def depth_and_camera(params, cfg: VGGTConfig, images: np.ndarray,
                     camera_index: int = 0, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """``vggt_forward`` on preprocessed images [S, 3, H, W] (one scene)
    -> (depth [H, W], conf [H, W], extrinsic [4, 4] w2c, intrinsic [3, 3])
    of frame ``camera_index``, on the host."""
    dev = resolve_device(device)
    out = vggt_forward(params, cfg,
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
    wide). Without a checkpoint it stops with the JAX package's
    message."""
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
    params = load_converted_vggt(checkpoint, cfg, device=dev)
    return depth_and_camera(params, cfg, images, camera_index, device=dev)
