"""Mask softening: smooth 1->0 transitions at warp-mask boundaries.

Host-side numpy copy of ``worldforge_tpu/warp/masks.py`` (the port imports
nothing of the JAX package); runs once per clip on small data.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import distance_transform_edt


def _smooth_transition(t: np.ndarray, decay_type: str) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    if decay_type == "linear":
        return t
    if decay_type == "exponential":
        return 1.0 - np.exp(-3.0 * t)
    if decay_type == "sine":
        return np.sin(np.pi / 2 * t)
    if decay_type == "cosine":
        return 1.0 - np.cos(np.pi / 2 * t)
    raise ValueError(f"Unsupported decay type: {decay_type}")


def soften_mask(mask_array: np.ndarray, transition_distance: int = 15,
                decay_type: str = "sine") -> np.ndarray:
    """Per frame: inside the mask (value 1), pixels within
    ``transition_distance`` of the boundary ramp 0 -> 1 with the chosen decay
    (distance-transform from the mask interior). mask_array: [F, H, W] of
    {0,1}. Returns float32 in [0, 1]."""
    softened = mask_array.astype(np.float32).copy()
    for f in range(mask_array.shape[0]):
        cur = mask_array[f].astype(bool)
        if cur.all() or (~cur).all():
            continue
        frame = mask_array[f].astype(np.float32).copy()
        dist = distance_transform_edt(cur)
        band = cur & (dist <= transition_distance)
        if band.any():
            frame[band] = _smooth_transition(dist[band] / transition_distance,
                                             decay_type)
        softened[f] = frame
    return softened
