"""Depth visualisation: the inferno LUT over normalised depth.

Counterpart of ``worldforge_tpu/utils/depth_vis.py``, a plain numpy copy.
Behavioural reference: DepthCrafter's ``ColorMapper`` /
``vis_sequence_depth`` (``depthcrafter/utils.py``): normalise to [v_min,
v_max], scale to 0..255 and index a 256-entry matplotlib colormap.
matplotlib is optional: without it the LUT is a gray ramp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _inferno_lut() -> np.ndarray:
    try:
        from matplotlib import cm
        return np.asarray(cm.get_cmap("inferno").colors, np.float32)
    except Exception:  # matplotlib-free fallback: perceptual gray ramp
        g = np.linspace(0.0, 1.0, 256, dtype=np.float32)
        return np.stack([g, g, g], axis=-1)


def vis_sequence_depth(depths: np.ndarray, v_min: Optional[float] = None,
                       v_max: Optional[float] = None) -> np.ndarray:
    """depths [T, H, W] -> RGB float [T, H, W, 3] in [0, 1]
    (vis_sequence_depth, utils.py:203-209; LUT index = long(norm*255))."""
    lut = _inferno_lut()
    if v_min is None:
        v_min = float(depths.min())
    if v_max is None:
        v_max = float(depths.max())
    norm = (depths - v_min) / max(v_max - v_min, 1e-12)
    idx = np.clip((norm * 255).astype(np.int64), 0, 255)
    return lut[idx]
