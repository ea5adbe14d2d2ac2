"""DepthCrafter inference entry: frames -> normalised depth (stage 1 of the
video 4D warp CLI, ``cli/warp_depthcrafter.py``).

Counterpart of ``worldforge_tpu/models/depthcrafter/inference.py``. The
frames are resized to multiples of 64 (PIL bicubic) first. Without a
checkpoint it stops with the JAX package's message; loading one waits for
the port of the checkpoint converters (``io/convert_depthcrafter.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

CHECKPOINT_NOT_PORTED = (
    "loading converted DepthCrafter weights waits for the port of the "
    "checkpoint converters (io/convert_depthcrafter.py); use --depth_npz "
    "with precomputed depth")


def resize_to_64(frames: np.ndarray, max_res: int = 1024) -> np.ndarray:
    """[T, H, W, 3] float [0, 1] -> the same, resized (PIL bicubic on the
    uint8 frames) so both sides are multiples of 64, the longer at most
    ``max_res``; returned as given when already so."""
    t, h, w, _ = frames.shape
    scale = min(max_res / max(h, w), 1.0)
    nh = round(h * scale / 64) * 64 or 64
    nw = round(w * scale / 64) * 64 or 64
    if (nh, nw) == (h, w):
        return frames
    from PIL import Image
    return np.stack([np.asarray(Image.fromarray(
        (f * 255).astype(np.uint8)).resize((nw, nh), Image.BICUBIC))
        for f in frames]).astype(np.float32) / 255.0


def estimate_depth(frames: np.ndarray, *, num_inference_steps: int = 5,
                   guidance_scale: float = 1.0, max_res: int = 1024,
                   window_size: int = 110, overlap: int = 25,
                   checkpoint: Optional[str] = None, seed: int = 42,
                   device=None) -> np.ndarray:
    """frames [T, H, W, 3] float [0, 1] -> depth [T, H', W'] in [0, 1] at
    the 64-multiple size. ``device`` defaults to the card."""
    frames = resize_to_64(frames, max_res)
    if checkpoint is None:
        raise SystemExit(
            "DepthCrafter weights required: convert the tencent/DepthCrafter "
            "checkpoint (see worldforge_tpu_torch.io.convert_depthcrafter, "
            "a later slice of the port) or pass --depth_npz with "
            "precomputed depth.")
    raise NotImplementedError(CHECKPOINT_NOT_PORTED)
