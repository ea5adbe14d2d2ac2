"""Single-image 3D warp: unproject -> camera trajectory -> splat -> fill.

Counterpart of ``worldforge_tpu/warp/vggt_warp.py``
(``_filter_depth_by_confidence``, ``warp_single_image`` :26-145). The
unprojection and every frame's projection and z-buffer splat run as one
batched computation on the device; the per-frame crack filling stays on
the host, as in JAX and the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.warp.cameras import vggt_camera_seq
from worldforge_tpu_torch.warp.cracks import (DEFAULT_CRACK_PARAMS,
                                              depth_aware_crack_filling,
                                              fill_small_cracks)
from worldforge_tpu_torch.warp.geometry import (_mat3, cam_to_world,
                                                unproject_depth)
from worldforge_tpu_torch.warp.splat import splat_nearest


def _filter_depth_by_confidence(depth: np.ndarray,
                                conf: Optional[np.ndarray],
                                conf_threshold: float):
    """Percentile confidence filtering, the reference's three branches: with
    conf and a threshold other than 1.0, NaN the pixels below the
    percentile; with conf and 1.0, keep the depth un-NaN'd; without conf,
    NaN the invalid (NaN or <= 0) pixels."""
    filtered = depth.astype(np.float32).copy()
    if conf is not None and conf_threshold == 1.0:
        mask = ~np.isnan(filtered) & (filtered > 0)
    elif conf is not None:
        thr = np.percentile(conf.flatten(), (1 - conf_threshold) * 100)
        mask = conf > thr
        filtered[~mask] = np.nan
    else:
        mask = ~np.isnan(filtered) & (filtered > 0)
        filtered[~mask] = np.nan
    mean_depth = np.nanmean(filtered[mask]) if mask.any() else 1.0
    return filtered, mask, float(mean_depth)


def splat_trajectory(extrinsic: np.ndarray, intrinsic: np.ndarray,
                     image: np.ndarray, depth: np.ndarray,
                     cams: np.ndarray, device=None):
    """The device half of the warp: unproject ``depth`` (NaN = invalid)
    through the source camera and splat ``image`` [H, W, C] into every
    camera of ``cams`` [F, 4, 4]. Returns (images [F, H, W, C], masks
    [F, H, W] bool, depths [F, H, W]) as numpy."""
    dev = resolve_device(device)
    h, w, c = image.shape
    valid = ~np.isnan(depth) & (np.nan_to_num(depth) > 0)
    pts = unproject_depth(torch.as_tensor(np.nan_to_num(depth, nan=0.0),
                                          device=dev), intrinsic)
    e44 = np.eye(4)
    e44[:3] = extrinsic[:3]
    world = cam_to_world(pts, e44)
    cams_t = torch.as_tensor(np.asarray(cams, np.float32), device=dev)
    pc = _mat3(cams_t[:, :3, :3], world) + cams_t[:, :3, 3, None]
    imgs, masks, depths = splat_nearest(
        pc, torch.as_tensor(image.reshape(-1, c), device=dev), intrinsic,
        torch.as_tensor(valid.reshape(-1), device=dev), h=h, w=w)
    return imgs.cpu().numpy(), masks.cpu().numpy(), depths.cpu().numpy()


def warp_single_image(
    extrinsic: np.ndarray,            # [3,4] or [4,4] w2c
    intrinsic: np.ndarray,            # [3,3]
    image: np.ndarray,                # [H,W,3] float in [0,1] or uint8
    depth_map: np.ndarray,            # [H,W]
    depth_conf: Optional[np.ndarray] = None,
    *,
    direction: str = "right",
    degree: float = 15.0,
    conf_threshold: float = 0.5,
    frame_num: int = 24,
    look_at_depth: float = 1.0,
    fill_cracks: bool = True,
    crack_params: Optional[Dict] = None,
    depth_segments: int = 5,
    disable_depth_aware_fill: bool = False,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[Dict]]:
    """Returns (warped images uint8, warped masks {0, 1} uint8, camera
    info). Frame 0 is the original image with an all-ones mask. The splat
    runs on ``device`` (the card unless the caller asks for the CPU)."""
    # colours keep the input's scale through the splat; unit_scale says
    # whether a *255 is due at the uint8 output
    img = image.astype(np.float32)
    unit_scale = img.max() <= 1.0
    H, W, _ = img.shape
    filtered_depth, _, mean_depth = _filter_depth_by_confidence(
        depth_map, depth_conf, conf_threshold)
    cams = vggt_camera_seq(extrinsic, direction, degree, frame_num,
                           mean_depth * look_at_depth)
    imgs_np, masks_np, depths_np = splat_trajectory(
        extrinsic, intrinsic, img, filtered_depth, cams[1:], device)

    params = {**DEFAULT_CRACK_PARAMS, **(crack_params or {})}
    warped_images = [(img * 255).astype(np.uint8) if unit_scale
                     else img.astype(np.uint8)]
    warped_masks = [np.ones((H, W), np.uint8)]
    infos = [{"type": "original", "camera_name": "original",
              "direction": direction, "angle": 0.0}]
    for i in range(len(cams) - 1):
        # the splatted frame is quantized to uint8 BEFORE the crack fill,
        # as in the reference: filled colours are means of the quantized
        # values, so the round trip is load-bearing for parity
        wi8 = ((imgs_np[i] * 255).astype(np.uint8) if unit_scale
               else imgs_np[i].astype(np.uint8))
        bm = masks_np[i].astype(np.uint8)
        wd = depths_np[i]
        if fill_cracks:
            wi = wi8.astype(np.float32) / 255.0
            if (not disable_depth_aware_fill
                    and np.sum(~np.isnan(wd)) > 100):
                fi, fm, _ = depth_aware_crack_filling(
                    wi, bm, wd, params, num_segments=depth_segments)
            else:
                fi, fm = fill_small_cracks(
                    wi, bm, filtered_depth, depth_conf=depth_conf,
                    depth_threshold=params["depth_threshold"],
                    max_crack_size=params["max_crack_size"],
                    min_valid_neighbors=params["min_valid_neighbors"])
            wi8, bm = (fi * 255).astype(np.uint8), fm
        warped_images.append(wi8)
        warped_masks.append(bm.astype(np.uint8))
        angle = degree * (i + 2) / frame_num
        infos.append({"type": "single_view_warped", "direction": direction,
                      "angle": angle,
                      "camera_name": f"{direction}_{angle:.2f}_deg"})
    return warped_images, warped_masks, infos
