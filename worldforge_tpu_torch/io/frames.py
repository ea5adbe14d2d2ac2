"""Frame-directory IO: the file-system contract between warp and repaint.

A copy of ``worldforge_tpu/io/frames.py`` (the port imports nothing of the
JAX package). The warp stage writes ``rendered_image_%02d.png`` /
``warp_*.png`` plus ``mask_*.png``; repaint reads any image directory and
splits on the ``mask_`` filename prefix. PIL and cv2 are imported where they
are used, so the module imports on a machine without them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def read_frames_from_directory(directory: str
                               ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                          Optional[np.ndarray]]:
    """Returns (frames [H,W,3] uint8, masks [H,W] uint8 {0,1}, first_frame).
    Files starting with ``mask_`` are masks; everything else is a frame;
    both sorted by filename. Mask-count normalization mirrors the
    reference (infer_worldforge.py:91-99): no masks -> all-ZERO masks
    (guided fusion trusts nothing), fewer masks than frames -> repeat the
    last, more -> truncate."""
    from PIL import Image
    names = sorted(os.listdir(directory))
    frames, masks = [], []
    for n in names:
        if not n.lower().endswith(IMG_EXTS):
            continue
        path = os.path.join(directory, n)
        img = np.asarray(Image.open(path))
        if n.startswith("mask_"):
            if img.ndim == 3:
                img = img[..., 0]
            masks.append((img > 127).astype(np.uint8))
        else:
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            frames.append(img[..., :3])
    first = frames[0] if frames else None
    if frames:
        zero = lambda: np.zeros(frames[0].shape[:2], np.uint8)
        while len(masks) < len(frames):
            masks.append(masks[-1].copy() if masks else zero())
        masks = masks[:len(frames)]
    return frames, masks, first


def save_warp_outputs(out_dir: str, images: List[np.ndarray],
                      masks: List[np.ndarray],
                      image_prefix: str = "rendered_image_",
                      mask_prefix: str = "mask_") -> None:
    """Write the warp-stage contract: <prefix>%02d.png + mask_%02d.png."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i, (img, m) in enumerate(zip(images, masks)):
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir,
                                               f"{image_prefix}{i:02d}.png"))
        mm = np.squeeze(m)
        Image.fromarray((mm * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"{mask_prefix}{i:02d}.png"))


def export_video(frames, path: str, fps: int = 16) -> None:
    """Write an mp4 (cv2 VideoWriter); frames: list of [H,W,3] uint8/float."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = []
    for f in frames:
        a = np.asarray(f)
        if a.dtype != np.uint8:
            a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
        if a.ndim == 2 or a.shape[-1] == 1:
            a = np.repeat(a.reshape(a.shape[0], a.shape[1], 1), 3, axis=-1)
        arrs.append(a)
    h, w = arrs[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for a in arrs:
        vw.write(cv2.cvtColor(a, cv2.COLOR_RGB2BGR))
    vw.release()


def load_image(path: str, size: Optional[Tuple[int, int]] = None
               ) -> np.ndarray:
    """[H,W,3] uint8, optionally resized to (H, W)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.LANCZOS)
    return np.asarray(img)


def load_frames(path: str) -> np.ndarray:
    """[T, H, W, 3] float32 in [0, 1] from a video file or a frame directory
    (a copy of ``worldforge_tpu/cli/warp_depthcrafter.py::_load_frames``)."""
    from PIL import Image
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".png", ".jpg", ".jpeg")))
        frames = [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                  for n in names]
        return np.stack(frames).astype(np.float32) / 255.0
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames).astype(np.float32) / 255.0


def resize_to_mod(frames: np.ndarray, mod: int = 16) -> np.ndarray:
    """Resize [T,H,W,3] so H,W are divisible by mod (infer_worldforge
    :219-222 mod-value resize)."""
    from PIL import Image
    t, h, w, _ = frames.shape
    nh, nw = (h // mod) * mod, (w // mod) * mod
    if (nh, nw) == (h, w):
        return frames
    out = np.stack([
        np.asarray(Image.fromarray(f).resize((nw, nh), Image.LANCZOS))
        for f in frames])
    return out
