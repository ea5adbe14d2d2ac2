"""Camera trajectories of the VGGT and DepthCrafter warps (world-to-camera extrinsics,
x_cam = R x_world + t): orbit look-at (up/down/left/right), dolly
(forward/backward) and four pure pans.

Host numpy copy of the VGGT half of ``worldforge_tpu/warp/cameras.py``
(:28-186; the port imports nothing of the JAX package). The DepthCrafter
trajectories (``dc_look_at`` ... ``dc_camera_seq``, :188-330) are a copy
of the JAX package's too: up, down, left and right orbits by position
offset, the stable schedule, zoom in and out, and the circle. Each
function returns [F, 4, 4] float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


# ------------------------------------------------------------------ helpers


def _rot_x(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _orthonormal_frame(z_axis: np.ndarray, y_hint: np.ndarray) -> np.ndarray:
    """Rows of a w2c rotation whose camera z looks along z_axis, y close to
    y_hint (Gram-Schmidt, utils_warp.py:88-97)."""
    z = z_axis / np.linalg.norm(z_axis)
    y = y_hint - np.dot(y_hint, z) * z
    n = np.linalg.norm(y)
    if n > 1e-6:
        y = y / n
    else:
        y = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
        y = y - np.dot(y, z) * z
        y = y / np.linalg.norm(y)
    x = np.cross(y, z)
    x = x / np.linalg.norm(x)
    return np.stack([x, y, z])  # rows


def _w2c_from(R: np.ndarray, cam_pos: np.ndarray, base: np.ndarray) -> np.ndarray:
    out = base.copy()
    out[:3, :3] = R
    out[:3, 3] = -R @ cam_pos
    return out


# ------------------------------------------------- VGGT (w2c) trajectories


def _as44(extrinsic: np.ndarray) -> np.ndarray:
    if extrinsic.shape == (3, 4):
        e = np.eye(4)
        e[:3] = extrinsic
        return e
    return extrinsic.astype(np.float64).copy()


def _orbit_seq(extrinsic, max_degree, frame_num, look_at_depth, axis: str):
    """Orbit the camera around the look-at point (utils_warp.py:64-145).
    axis 'x' = up/down, 'y' = left/right."""
    e = _as44(extrinsic)
    R, t = e[:3, :3], e[:3, 3]
    cam_pos = -R.T @ t
    look_at = cam_pos + R.T @ np.array([0.0, 0.0, look_at_depth])
    y_hint = R.T @ np.array([0.0, 1.0, 0.0])
    cams = []
    for deg in np.linspace(0, max_degree, frame_num):
        rad = np.deg2rad(deg)
        rot = _rot_x(rad) if axis == "x" else _rot_y(rad)
        new_pos = look_at - rot @ (look_at - cam_pos)
        newR = _orthonormal_frame(look_at - new_pos, y_hint)
        cams.append(_w2c_from(newR, new_pos, e))
    return np.stack(cams)


def look_up_seq(extrinsic, max_degree, frame_num, look_at_depth):
    return _orbit_seq(extrinsic, max_degree, frame_num, look_at_depth, "x")


def look_right_seq(extrinsic, max_degree, frame_num, look_at_depth):
    return _orbit_seq(extrinsic, max_degree, frame_num, look_at_depth, "y")


def _dolly_seq(extrinsic, max_degree, frame_num, look_at_depth, sign: float):
    """Dolly toward (+) / away from (-) the scene center
    (utils_warp.py:148-243); degree is a percentage of the distance."""
    e = _as44(extrinsic)
    R, t = e[:3, :3], e[:3, 3]
    cam_pos = -R.T @ t
    center = cam_pos + R.T @ np.array([0.0, 0.0, look_at_depth])
    vec = center - cam_pos
    radius = np.linalg.norm(vec)
    direction = sign * vec / radius
    y_hint = R.T @ np.array([0.0, 1.0, 0.0])
    cams = []
    for progress in np.linspace(0, max_degree / 100.0, frame_num):
        new_pos = cam_pos + direction * (radius * progress)
        to_center = center - new_pos
        if np.linalg.norm(to_center) > 1e-6:
            newR = _orthonormal_frame(to_center, y_hint)
        else:
            newR = R.copy()
        cams.append(_w2c_from(newR, new_pos, e))
    return np.stack(cams)


def look_forward_seq(extrinsic, max_degree, frame_num, look_at_depth):
    return _dolly_seq(extrinsic, max_degree, frame_num, look_at_depth, +1.0)


def look_backward_seq(extrinsic, max_degree, frame_num, look_at_depth):
    return _dolly_seq(extrinsic, max_degree, frame_num, look_at_depth, -1.0)


def _pan_seq(extrinsic, max_degree, frame_num, axis: str, sign: float):
    """Pure rotation pan, camera position fixed (utils_warp.py:246-379)."""
    e = _as44(extrinsic)
    R, t = e[:3, :3], e[:3, 3]
    cam_pos = -R.T @ t
    cams = []
    for deg in np.linspace(0, max_degree, frame_num):
        rad = np.deg2rad(sign * deg)
        rot = _rot_x(rad) if axis == "x" else _rot_y(rad)
        newR = R @ rot
        cams.append(_w2c_from(newR, cam_pos, e))
    return np.stack(cams)


def right_pan_seq(e, d, n, look_at_depth=None):
    return _pan_seq(e, d, n, "y", +1.0)


def left_pan_seq(e, d, n, look_at_depth=None):
    return _pan_seq(e, d, n, "y", -1.0)


def up_pan_seq(e, d, n, look_at_depth=None):
    return _pan_seq(e, d, n, "x", +1.0)


def down_pan_seq(e, d, n, look_at_depth=None):
    return _pan_seq(e, d, n, "x", -1.0)


def vggt_camera_seq(extrinsic, direction: str, degree: float, frame_num: int,
                    look_at_depth: float) -> np.ndarray:
    """Dispatch matching warp_single_img (utils_warp.py:818-840)."""
    d = direction.lower()
    if d in ("up", "down"):
        return look_up_seq(extrinsic, degree if d == "up" else -degree,
                           frame_num, look_at_depth)
    if d in ("left", "right"):
        return look_right_seq(extrinsic, degree if d == "right" else -degree,
                              frame_num, look_at_depth)
    if d == "forward":
        return look_forward_seq(extrinsic, degree, frame_num, look_at_depth)
    if d == "backward":
        return look_backward_seq(extrinsic, degree, frame_num, look_at_depth)
    if d == "up_pan":
        return up_pan_seq(extrinsic, degree, frame_num)
    if d == "down_pan":
        return down_pan_seq(extrinsic, degree, frame_num)
    if d == "left_pan":
        return left_pan_seq(extrinsic, degree, frame_num)
    if d == "right_pan":
        return right_pan_seq(extrinsic, degree, frame_num)
    raise ValueError(f"Unsupported direction: {direction}")


# ---------------------------------------- DepthCrafter (4D) trajectories


def dc_look_at(camera_pos: np.ndarray, target: np.ndarray,
               up: np.ndarray) -> np.ndarray:
    """DepthCrafter look_at (utils.py:240-251): columns [right, up, forward]
    transposed — reproduced verbatim in behavior (including its use as the
    OpenCV w2c input downstream)."""
    fwd = target - camera_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    return np.vstack([right, up2, fwd]).T


def _dc_cam(camera_pos, look_at_point) -> np.ndarray:
    e = np.eye(4)
    e[:3, :3] = dc_look_at(camera_pos, look_at_point, np.array([0.0, 1.0, 0.0]))
    e[:3, 3] = camera_pos
    return e


def _dc_degree_schedule(max_degree, frame_num, stable_frame: Optional[int]):
    if stable_frame is None:
        return np.linspace(0, max_degree, frame_num)
    sf = min(stable_frame, frame_num)
    degs = np.full(frame_num, float(max_degree))
    if sf > 1:
        degs[:sf] = np.arange(sf) / (sf - 1) * max_degree
    return degs


def dc_look_up_seq(extrinsic, max_degree, frame_num, look_at_depth,
                   stable_frame: Optional[int] = None) -> np.ndarray:
    """Orbit up via position offset (utils.py:253-290, stable :412-439)."""
    e = extrinsic.astype(np.float64)
    t, R = e[:3, 3], e[:3, :3]
    look_at_point = t + R @ np.array([0.0, 0.0, look_at_depth])
    cams = []
    for deg in _dc_degree_schedule(max_degree, frame_num, stable_frame):
        pos = t.copy()
        rad = np.deg2rad(deg)
        pos[1] = pos[1] + np.sin(rad) * look_at_depth
        pos[2] = pos[2] + (1 - np.cos(rad)) * look_at_depth
        cams.append(_dc_cam(pos, look_at_point))
    return np.stack(cams)


def dc_look_right_seq(extrinsic, max_degree, frame_num, look_at_depth,
                      stable_frame: Optional[int] = None) -> np.ndarray:
    """utils.py:281-306 (note the -degree sign on x), stable :442-460."""
    e = extrinsic.astype(np.float64)
    t, R = e[:3, 3], e[:3, :3]
    look_at_point = t + R @ np.array([0.0, 0.0, look_at_depth])
    cams = []
    for deg in _dc_degree_schedule(max_degree, frame_num, stable_frame):
        pos = t.copy()
        rad = np.deg2rad(-deg)
        pos[0] = pos[0] + np.sin(rad) * look_at_depth
        pos[2] = pos[2] + (1 - np.cos(rad)) * look_at_depth
        cams.append(_dc_cam(pos, look_at_point))
    return np.stack(cams)


def dc_circle_seq(extrinsic, radius, frame_num, look_at_depth,
                  direction: str = "right") -> np.ndarray:
    """Full-circle orbit (utils.py:335-368)."""
    e = extrinsic.astype(np.float64)
    t, R = e[:3, 3], e[:3, :3]
    look_at_point = t + R @ np.array([0.0, 0.0, look_at_depth])
    cams = []
    for ang in np.linspace(0, 2 * np.pi, frame_num):
        pos = t.copy()
        if direction == "right":
            pos[0] = pos[0] + radius * (np.cos(ang) - 1)
        elif direction == "left":
            pos[0] = pos[0] - radius * (np.cos(ang) - 1)
        else:
            raise ValueError("direction should be either right or left.")
        pos[1] = pos[1] + radius * np.sin(ang)
        cams.append(_dc_cam(pos, look_at_point))
    return np.stack(cams)


def dc_apply_zoom(cams: np.ndarray, zoom_mode: str, rate: float,
                  look_at_depth: float,
                  stable_frame: Optional[int] = None) -> np.ndarray:
    """Zoom in/out along the look-at axis (utils.py:371-409, stable
    :463-492)."""
    if zoom_mode == "none":
        return cams
    if not (0.0 < rate <= 1.0):
        raise ValueError("rate must be between 0.0 and 1.0")
    n = len(cams)
    out = []
    for i, cam in enumerate(cams):
        pos = cam[:3, 3].copy()
        R = cam[:3, :3]
        look_at_point = pos + R @ np.array([0.0, 0.0, look_at_depth])
        dist = pos - look_at_point
        if stable_frame is None:
            progress = i / (n - 1) if n > 1 else 0.0
        else:
            sf = min(stable_frame, n)
            progress = (i / (sf - 1) if sf > 1 else 1.0) if i < sf else 1.0
        if zoom_mode == "zoom_out":
            f = 1.0 - progress * (1.0 - rate)
        elif zoom_mode == "zoom_in":
            f = 1.0 + progress * (1.0 / rate - 1.0)
        else:
            f = 1.0
        new_pos = look_at_point + dist * f
        newR = dc_look_at(new_pos, look_at_point, np.array([0.0, 1.0, 0.0]))
        c = cam.copy()
        c[:3, :3] = newR
        c[:3, 3] = new_pos
        out.append(c)
    return np.stack(out)


def dc_camera_seq(direction: str, degree: float, frame_num: int,
                  look_at_depth: float, *, stable: bool = False,
                  stable_frame: int = 17, zoom: str = "none",
                  rate: float = 1.0, circle_radius: Optional[float] = None
                  ) -> np.ndarray:
    """Dispatch matching warp_depthcrafter.py:217-249 (identity initial
    extrinsics)."""
    e = np.eye(4)
    sf = stable_frame if stable else None
    if circle_radius is not None:
        cams = dc_circle_seq(e, circle_radius, frame_num, look_at_depth,
                             direction)
    elif direction == "up":
        cams = dc_look_up_seq(e, degree, frame_num, look_at_depth, sf)
    elif direction == "down":
        cams = dc_look_up_seq(e, -degree, frame_num, look_at_depth, sf)
    elif direction == "right":
        cams = dc_look_right_seq(e, degree, frame_num, look_at_depth, sf)
    elif direction == "left":
        cams = dc_look_right_seq(e, -degree, frame_num, look_at_depth, sf)
    else:
        raise ValueError(f"Unsupported direction: {direction}")
    if zoom != "none":
        cams = dc_apply_zoom(cams, zoom, rate, look_at_depth, sf)
    return cams
