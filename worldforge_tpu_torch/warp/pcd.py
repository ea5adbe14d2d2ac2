"""Point-cloud export for DepthCrafter disparity maps (host numpy).

A copy of ``worldforge_tpu/warp/pcd.py``: per-frame coloured point clouds
from a disparity stack and its video, written as binary PLY files:
  - disparity normalised over the WHOLE clip,
  - unprojection zc = 1/(d_norm + 0.1), xc = zc (u - W/2)/(W/2),
    yc = zc (v - H/2)/(H/2), then zc -= 4 (the fixed recentring),
  - colours sampled from the matching frame, every
    ``downsample_factor``-th pixel in raster order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_disparity", "disparity_to_pointcloud", "write_ply",
           "read_ply"]


def normalize_disparity(disp: np.ndarray) -> np.ndarray:
    """Clip-global min/max normalization (visualization_pcd.py:37-39)."""
    disp = np.asarray(disp, np.float32)
    lo, hi = float(disp.min()), float(disp.max())
    return (disp - lo) / (hi - lo) if hi > lo else np.zeros_like(disp)


def disparity_to_pointcloud(disp_norm: np.ndarray, frame: np.ndarray,
                            downsample_factor: int = 8,
                            z_offset: float = 4.0):
    """One frame's normalized disparity [H,W] + RGB frame [H,W,3]
    -> (points [N,3] float32, colors [N,3] uint8).

    Matches visualization_pcd.py:113-130: raster-order pixel list,
    zc = 1/(d+0.1), xc = zc*(u - W/2)/(W/2), yc = zc*(v - H/2)/(W/2 is
    NOT used for y — the reference divides by W/2 for x and H/2 for y),
    zc -= z_offset, then stride-`downsample_factor` subsampling.
    """
    h, w = disp_norm.shape
    v, u = np.where(np.zeros((h, w)) == 0)  # raster order, like :113-115
    d = disp_norm[v, u].astype(np.float32)
    zc = 1.0 / (d + 0.1)
    xc = zc * (u - w / 2.0) / (w / 2.0)
    yc = zc * (v - h / 2.0) / (h / 2.0)
    zc = zc - z_offset
    points = np.stack((xc, yc, zc), axis=1).astype(np.float32)
    colors = np.asarray(frame, np.uint8)[v, u]
    return points[::downsample_factor], colors[::downsample_factor]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Binary little-endian PLY with per-vertex uchar RGB."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    assert points.shape == (len(points), 3) and colors.shape == points.shape
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    rec = np.zeros(len(points), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"], rec["rgb"] = points, colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str):
    """Parse the PLY layout write_ply produces (for tests / round-trips)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = next(int(line.split()[-1]) for line in header
             if line.startswith("element vertex"))
    rec = np.frombuffer(data[end:],
                        dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
    return rec["xyz"].copy(), rec["rgb"].copy()
