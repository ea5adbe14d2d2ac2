"""Depth-edge point filtering: drops the points near depth edges before
the DepthCrafter splat, which would otherwise smear them into streaks.

A host copy of ``worldforge_tpu/warp/edge_filter.py`` (cv2 Sobel gradient
edge mask + dilation + scipy min/max depth-jump mask), run in float64 on
the host as there (cv2 and scipy imported where they are used).
"""

from __future__ import annotations

import numpy as np


def detect_depth_edges(depth_map: np.ndarray, edge_threshold: float = 0.1,
                       kernel_size: int = 3) -> np.ndarray:
    """Normalized Sobel gradient magnitude > threshold
    (DepthCrafter/utils.py:495-517)."""
    import cv2
    gx = cv2.Sobel(depth_map, cv2.CV_64F, 1, 0, ksize=kernel_size)
    gy = cv2.Sobel(depth_map, cv2.CV_64F, 0, 1, ksize=kernel_size)
    mag = np.sqrt(gx ** 2 + gy ** 2)
    if mag.max() > 0:
        mag = mag / mag.max()
    return mag > edge_threshold


def edge_point_mask(depth_2d: np.ndarray, edge_threshold: float = 0.1,
                    edge_dilation: int = 3,
                    depth_jump_threshold: float = 0.3,
                    neighbor_check_radius: int = 2) -> np.ndarray:
    """[H*W] bool: True = keep the point (not near a depth edge)
    (filter_edge_points, DepthCrafter/utils.py:520-567)."""
    import cv2
    from scipy import ndimage
    edge = detect_depth_edges(depth_2d, edge_threshold)
    if edge_dilation > 0:
        k = np.ones((edge_dilation * 2 + 1, edge_dilation * 2 + 1), np.uint8)
        edge = cv2.dilate(edge.astype(np.uint8), k, iterations=1).astype(bool)
    if depth_jump_threshold > 0 and neighbor_check_radius > 0:
        size = neighbor_check_radius * 2 + 1
        jump = (ndimage.maximum_filter(depth_2d, size=size)
                - ndimage.minimum_filter(depth_2d, size=size)
                ) > depth_jump_threshold
        edge = edge | jump
    return ~edge.flatten()
