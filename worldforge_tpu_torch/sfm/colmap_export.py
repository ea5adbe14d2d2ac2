"""COLMAP reconstruction export in COLMAP's text model format.

Counterpart of ``worldforge_tpu/sfm/colmap_export.py``: reprojection-error
inliers (optional), a minimum of inliers per frame, tracks kept with two
or more inliers, 1-indexed cameras, images and points, written as
``cameras.txt`` / ``images.txt`` / ``points3D.txt`` (which COLMAP and
pycolmap read) with no native dependency. Host numpy; the reprojection
goes through ``sfm/projection.py`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.sfm.projection import project_3d_points


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """[3,3] rotation -> COLMAP quaternion (w, x, y, z)."""
    m = np.asarray(r, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _camera_params(fidx: int, intrinsics: np.ndarray, camera_type: str,
                   extra_params: Optional[np.ndarray]) -> List[float]:
    """COLMAP's parameter vector of frame ``fidx``'s camera."""
    K = intrinsics[fidx]
    if camera_type == "SIMPLE_PINHOLE":
        return [float((K[0, 0] + K[1, 1]) / 2), float(K[0, 2]),
                float(K[1, 2])]
    if camera_type == "PINHOLE":
        return [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                float(K[1, 2])]
    if camera_type == "SIMPLE_RADIAL":
        k = float(extra_params[fidx, 0]) if extra_params is not None else 0.0
        return [float((K[0, 0] + K[1, 1]) / 2), float(K[0, 2]),
                float(K[1, 2]), k]
    raise ValueError(f"unsupported camera_type {camera_type}")


@dataclasses.dataclass
class ColmapReconstruction:
    cameras: List[dict]      # {id, model, width, height, params}
    images: List[dict]       # {id, qvec, tvec, camera_id, name,
    #                            points2d: [(x, y, point3d_id)]}
    points3d: Dict[int, dict]  # id -> {xyz, rgb, track: [(img_id, p2d_idx)]}

    def write_text(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
            f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
            for c in self.cameras:
                params = " ".join(f"{p:.10g}" for p in c["params"])
                f.write(f"{c['id']} {c['model']} {c['width']} "
                        f"{c['height']} {params}\n")
        with open(os.path.join(out_dir, "images.txt"), "w") as f:
            f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID "
                    "NAME / POINTS2D[] as (X, Y, POINT3D_ID)\n")
            for im in self.images:
                q = " ".join(f"{x:.10g}" for x in im["qvec"])
                t = " ".join(f"{x:.10g}" for x in im["tvec"])
                f.write(f"{im['id']} {q} {t} {im['camera_id']} "
                        f"{im['name']}\n")
                f.write(" ".join(
                    f"{x:.10g} {y:.10g} {pid}"
                    for x, y, pid in im["points2d"]) + "\n")
        with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
            f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                    "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            for pid, p in self.points3d.items():
                xyz = " ".join(f"{x:.10g}" for x in p["xyz"])
                rgb = " ".join(str(int(c)) for c in p["rgb"])
                trk = " ".join(f"{i} {j}" for i, j in p["track"])
                f.write(f"{pid} {xyz} {rgb} 0 {trk}\n")


def build_reconstruction(
    points3d: np.ndarray,          # [P, 3]
    extrinsics: np.ndarray,        # [N, 3, 4] world-to-camera
    intrinsics: np.ndarray,        # [N, 3, 3]
    tracks: np.ndarray,            # [N, P, 2]
    image_size,                    # (W, H)
    masks: Optional[np.ndarray] = None,
    max_reproj_error: Optional[float] = None,
    max_points3d_val: float = 3000.0,
    shared_camera: bool = False,
    camera_type: str = "SIMPLE_PINHOLE",
    extra_params: Optional[np.ndarray] = None,
    min_inlier_per_frame: int = 64,
    points_rgb: Optional[np.ndarray] = None,
) -> Tuple[Optional[ColmapReconstruction], Optional[np.ndarray]]:
    """The reference's ``batch_np_matrix_to_pycolmap`` as plain data ->
    (reconstruction, valid_track_mask), or (None, None) when a frame has
    fewer than ``min_inlier_per_frame`` inliers."""
    n, p, _ = tracks.shape
    reproj_mask = None
    if max_reproj_error is not None:
        p2d, _ = project_3d_points(torch.as_tensor(points3d),
                                   torch.as_tensor(extrinsics),
                                   torch.as_tensor(intrinsics))
        # the reference takes the difference before its behind-camera
        # write, which so changes nothing: points behind a camera can
        # still be inliers, as in JAX
        diff = np.linalg.norm(p2d.numpy() - tracks, axis=-1)
        reproj_mask = diff < max_reproj_error
    if masks is not None and reproj_mask is not None:
        masks = np.logical_and(masks, reproj_mask)
    elif masks is None:
        masks = reproj_mask
    assert masks is not None, "need masks or max_reproj_error"

    if masks.sum(1).min() < min_inlier_per_frame:
        return None, None

    valid_mask = masks.sum(0) >= 2          # tracks need two inliers
    valid_idx = np.nonzero(valid_mask)[0]

    points = {}
    for pid, vidx in enumerate(valid_idx, start=1):
        rgb = (points_rgb[vidx] if points_rgb is not None
               else np.zeros(3))
        points[pid] = {"xyz": points3d[vidx], "rgb": rgb, "track": []}

    cameras: List[dict] = []
    images: List[dict] = []
    for fidx in range(n):
        if not shared_camera or not cameras:
            cameras.append({
                "id": fidx + 1, "model": camera_type,
                "width": int(image_size[0]), "height": int(image_size[1]),
                "params": _camera_params(fidx, intrinsics, camera_type,
                                         extra_params)})
        cam_id = cameras[-1]["id"]
        points2d = []
        for pid, vidx in enumerate(valid_idx, start=1):
            # a one-sided bound, as in the reference: only large positive
            # coordinates are rejected
            if not (points[pid]["xyz"] < max_points3d_val).all():
                continue
            if masks[fidx][vidx]:
                xy = tracks[fidx][vidx]
                points[pid]["track"].append((fidx + 1, len(points2d)))
                points2d.append((float(xy[0]), float(xy[1]), pid))
        images.append({
            "id": fidx + 1,
            "qvec": rotmat_to_qvec(extrinsics[fidx][:3, :3]),
            "tvec": np.asarray(extrinsics[fidx][:3, 3], np.float64),
            "camera_id": cam_id, "name": f"image_{fidx + 1}",
            "points2d": points2d})
    return ColmapReconstruction(cameras, images, points), valid_mask
