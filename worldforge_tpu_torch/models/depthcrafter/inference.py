"""DepthCrafter inference entry: frames -> normalised depth (stage 1 of the
video 4D warp CLI, ``cli/warp_depthcrafter.py``).

Counterpart of ``worldforge_tpu/models/depthcrafter/inference.py``. The
frames are resized to multiples of 64 (PIL bicubic) first. The weights
come from a converted checkpoint directory
(``io/convert_depthcrafter.py::load_converted_depthcrafter``); without one
it stops with the JAX package's message.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
    the 64-multiple size, from the DepthCrafter checkpoint directory
    ``checkpoint``. ``device`` defaults to the card; the pipeline's noise
    comes from a generator on it seeded ``seed``."""
    frames = resize_to_64(frames, max_res)
    if checkpoint is None:
        raise SystemExit(
            "DepthCrafter weights required: convert the tencent/DepthCrafter "
            "checkpoint (see worldforge_tpu_torch.io.convert_depthcrafter) "
            "or pass --depth_npz with precomputed depth.")
    import torch

    from worldforge_tpu_torch.core.dtypes import resolve_device
    from worldforge_tpu_torch.io.convert_depthcrafter import \
        load_converted_depthcrafter
    from worldforge_tpu_torch.pipelines.depthcrafter import normalize_depth
    dev = resolve_device(device)
    pipe = load_converted_depthcrafter(checkpoint, device=dev)
    out = pipe(torch.Generator(device=dev).manual_seed(seed), frames,
               num_inference_steps=num_inference_steps,
               guidance_scale=guidance_scale, window_size=window_size,
               overlap=overlap)
    return normalize_depth(out)
