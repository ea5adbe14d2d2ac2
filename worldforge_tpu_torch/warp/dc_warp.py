"""Video 4D warp: per-frame inverse-depth point clouds splatted along a
camera trajectory.

Counterpart of ``worldforge_tpu/warp/dc_warp.py``: fixed intrinsics f = 525
c = (W/2, H/2), each frame's points from 1/(depth+0.1), the look-at value
= median(1/(depth[0]+0.1)) * look_at_depth, the trajectory matrices used
directly as the splat's w2c, the disk splat on the device, then the 5x5
morphological open on the host; the optional depth-edge point filter runs
on the host and is skipped on frame 0. A dropped point is pushed behind the
camera, not compacted away, as the JAX package does. The device defaults to
the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.warp.cameras import dc_camera_seq
from worldforge_tpu_torch.warp.edge_filter import edge_point_mask
from worldforge_tpu_torch.warp.geometry import dc_intrinsic, dc_unproject
from worldforge_tpu_torch.warp.splat import morph_open, splat_disk


def warp_video(
    frames: np.ndarray,              # [T, H, W, 3] float in [0,1]
    depth: np.ndarray,               # [T, H, W] normalized depth
    *,
    direction: str = "up",
    degree: float = 30.0,
    look_at_depth: float = 0.9,
    stable: bool = False,
    stable_frame: int = 17,
    zoom: str = "none",
    rate: float = 1.0,
    circle_radius: Optional[float] = None,
    enable_edge_filter: bool = False,
    edge_threshold: float = 0.1,
    edge_dilation: int = 3,
    depth_jump_threshold: float = 0.3,
    neighbor_check_radius: int = 2,
    focal: float = 525.0,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Returns (rendered_frames [H,W,3] float32, masks [H,W,1] uint8)."""
    dev = resolve_device(device)
    T, H, W, _ = frames.shape
    K = dc_intrinsic(H, W, focal)

    inv0 = 1.0 / (depth[0] + 0.1)
    look_at_value = float(np.median(inv0)) * look_at_depth
    cams = dc_camera_seq(direction, degree, T, look_at_value, stable=stable,
                         stable_frame=stable_frame, zoom=zoom, rate=rate,
                         circle_radius=circle_radius)

    behind = torch.tensor([0.0, 0.0, -1.0], device=dev)
    rendered, masks = [], []
    for idx in range(T):
        inv_d = 1.0 / (depth[idx] + 0.1)
        pts = dc_unproject(torch.as_tensor(inv_d, dtype=torch.float32,
                                           device=dev), f=focal)  # [N, 3]
        rgb = torch.as_tensor(frames[idx].reshape(-1, 3),
                              dtype=torch.float32, device=dev)
        if enable_edge_filter and idx > 0:
            keep = edge_point_mask(inv_d.astype(np.float64), edge_threshold,
                                   edge_dilation, depth_jump_threshold,
                                   neighbor_check_radius)
            keep_t = torch.as_tensor(keep, device=dev)
            pts = torch.where(keep_t[:, None], pts, behind)
        img_t, mask_t = splat_disk(pts, rgb, cams[idx], K, h=H, w=W)
        img = img_t.cpu().numpy()
        mask = morph_open(mask_t.cpu().numpy().astype(np.uint8), 5)
        img[mask == 0] = 0
        rendered.append(img.astype(np.float32))
        masks.append(mask[..., None])
    return rendered, masks
