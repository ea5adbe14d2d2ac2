"""VGGT utilities: pose encoding to cameras, and image preprocessing.

Host numpy copy of ``worldforge_tpu/models/vggt/utils.py`` (``quat_to_mat``
:15, ``pose_encoding_to_extri_intri`` :30, ``load_and_preprocess_images``
:53; the port imports nothing of the JAX package). PIL is imported where
it is used, so the module imports on a machine without it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """XYZW (scalar-last) quaternion -> rotation matrix (rotation.py:14-44)."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / np.maximum((q * q).sum(-1), 1e-12)
    o = np.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], axis=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc: np.ndarray,
                                 image_size_hw: Tuple[int, int]
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[..., 9] (absT, quatXYZW, fov_h, fov_w) -> (extrinsic [...,3,4] w2c
    OpenCV, intrinsic [...,3,3]) (pose_enc.py:62-124)."""
    T = pose_enc[..., :3]
    quat = pose_enc[..., 3:7]
    fov_h = pose_enc[..., 7]
    fov_w = pose_enc[..., 8]
    R = quat_to_mat(quat)
    extr = np.concatenate([R, T[..., None]], axis=-1)
    H, W = image_size_hw
    fy = (H / 2.0) / np.tan(np.maximum(fov_h, 1e-6) / 2.0)
    fx = (W / 2.0) / np.tan(np.maximum(fov_w, 1e-6) / 2.0)
    K = np.zeros(pose_enc.shape[:-1] + (3, 3), np.float64)
    K[..., 0, 0] = fx
    K[..., 1, 1] = fy
    K[..., 0, 2] = W / 2
    K[..., 1, 2] = H / 2
    K[..., 2, 2] = 1.0
    return extr, K


def load_and_preprocess_images(paths: List[str], mode: str = "crop",
                               target: int = 518) -> np.ndarray:
    """Resize to width `target` (aspect preserving, 14-divisible), crop or
    pad the height (load_fn.py:97-230). Returns [S, 3, H, W] float32 [0,1].
    """
    from PIL import Image
    images = []
    shapes = set()
    for path in paths:
        img = Image.open(path).convert("RGB")
        w, h = img.size
        if mode == "pad":
            if w >= h:
                nw = target
                nh = round(h * (nw / w) / 14) * 14
            else:
                nh = target
                nw = round(w * (nh / h) / 14) * 14
        else:
            nw = target
            nh = round(h * (nw / w) / 14) * 14
        img = img.resize((nw, nh), Image.BICUBIC)
        arr = np.asarray(img).astype(np.float32) / 255.0

        if mode == "crop" and nh > target:
            top = (nh - target) // 2
            arr = arr[top:top + target]
        if mode == "pad":
            ph, pw = target - arr.shape[0], target - arr.shape[1]
            if ph > 0 or pw > 0:
                arr = np.pad(arr, ((ph // 2, ph - ph // 2),
                                   (pw // 2, pw - pw // 2), (0, 0)),
                             constant_values=1.0)
        images.append(arr.transpose(2, 0, 1))
        shapes.add(arr.shape[:2])

    if len(shapes) > 1:
        hmax = max(s[0] for s in shapes)
        wmax = max(s[1] for s in shapes)
        padded = []
        for arr in images:
            ph, pw = hmax - arr.shape[1], wmax - arr.shape[2]
            padded.append(np.pad(arr, ((0, 0), (ph // 2, ph - ph // 2),
                                       (pw // 2, pw - pw // 2)),
                                 constant_values=1.0))
        images = padded
    return np.stack(images)
