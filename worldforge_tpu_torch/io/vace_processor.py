"""VACE source preprocessing (host side).

Counterpart of ``worldforge_tpu/io/vace_processor.py``:
  - ``VaceImageProcessor``: an output size capped by the sequence length
    (the latent-area square-root rule), max-scale resize and centre crop,
    normalised to [-1, 1];
  - ``VaceVideoProcessor``: latent-area sizing within the frame budget
    (``seq_len``), the fps-capped zero-start frame-id sampler or the
    keep-last uniform resampler (numpy RNG), the antialiased cubic resize
    and centre crop;
  - ``prepare_source``: empty slots become a zero video and a ones mask;
    reference images are fitted (bilinear) onto a white [-1, 1] canvas.

The resizes are ``jax.image.resize``'s: the antialiased cubic one through
``ops/sampling.py::jax_cubic_weights``, the letterbox's through
``jax_linear_weights`` (antialiased as well when it shrinks). It runs on the
CPU wherever the pipeline runs; callers pass decoded frame arrays
([T, H, W, 3] uint8 or float in [0, 1]) and get CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.ops.sampling import (jax_cubic_weights,
                                               jax_linear_weights,
                                               jax_resize2d)


def _resize_crop(frames: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[T, H, W, C] float in [0,1] -> [C, T, oh, ow] in [-1, 1]: the
    max-scale antialiased cubic resize, then the centre crop."""
    t, ih, iw, c = frames.shape
    if (ih, iw) != (oh, ow):
        scale = max(ow / iw, oh / ih)
        rh, rw = round(scale * ih), round(scale * iw)
        frames = jax_resize2d(frames, rh, rw, jax_cubic_weights)
        y1, x1 = (rh - oh) // 2, (rw - ow) // 2
        frames = frames[:, y1:y1 + oh, x1:x1 + ow]
    return frames.permute(3, 0, 1, 2) * 2.0 - 1.0


def _to_float01(frames) -> torch.Tensor:
    a = np.asarray(frames)
    if a.dtype == np.uint8:
        return torch.from_numpy(a.astype(np.float32) / np.float32(255.0))
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@dataclasses.dataclass
class VaceImageProcessor:
    """Image(s) -> normalised tensors at a size capped by ``seq_len``."""
    downsample: Tuple[int, int, int] = (4, 8, 8)
    seq_len: int = 32760

    def output_size(self, h: int, w: int,
                    seq_len: Optional[int] = None) -> Tuple[int, int]:
        seq_len = self.seq_len if seq_len is None else seq_len
        dh, dw = self.downsample[1:]
        scale = min(1.0, float(np.sqrt(seq_len / ((h / dh) * (w / dw)))))
        oh = int(h * scale) // dh * dh
        ow = int(w * scale) // dw * dw
        return oh, ow

    def load_image_batch(self, *images: np.ndarray,
                         seq_len: Optional[int] = None):
        """images: [H, W, 3] arrays. Returns (*tensors [3,1,oh,ow],
        (oh, ow))."""
        h, w = images[0].shape[:2]
        oh, ow = self.output_size(h, w, seq_len)
        outs = [_resize_crop(_to_float01(img)[None], oh, ow)
                for img in images]
        return (*outs, (oh, ow))


def _latent_size(h: int, w: int, num_src_frames: int, seq_len: int,
                 max_area: float, downsample: Tuple[int, int, int],
                 frame_cap: int) -> Tuple[int, int, int]:
    """The latent area capped by seq_len and max_area, the frames by the
    seq-len budget -> (frames, height, width) in pixels."""
    df, dh, dw = downsample
    ratio = h / w
    area_z = min(seq_len, max_area / (dh * dw), (h // dh) * (w // dw))
    of = min(frame_cap, int(seq_len / area_z))
    target_area_z = min(area_z, int(seq_len / of))
    oh = round(np.sqrt(target_area_z * ratio))
    ow = int(target_area_z / oh)
    return (of - 1) * df + 1, oh * dh, ow * dw


@dataclasses.dataclass
class VaceVideoProcessor:
    """Video -> (frame ids, crop box, output size, fps) + normalised
    tensors."""
    downsample: Tuple[int, int, int] = (4, 8, 8)
    min_area: float = 480 * 832
    max_area: float = 480 * 832
    min_fps: float = 16.0
    max_fps: float = 16.0
    zero_start: bool = True
    seq_len: int = 32760
    keep_last: bool = True

    def set_area(self, area: float) -> None:
        self.min_area = self.max_area = float(area)

    def set_seq_len(self, seq_len: int) -> None:
        self.seq_len = int(seq_len)

    # -- frame ids and shapes

    def _frameids_default(self, fps, frame_timestamps, h, w, crop_box, rng):
        """An fps-capped window from zero (or from a random start)."""
        target_fps = min(fps, self.max_fps)
        duration = float(frame_timestamps[-1].mean())
        x1, x2, y1, y2 = (0, w, 0, h) if crop_box is None else crop_box
        of, oh, ow = _latent_size(
            y2 - y1, x2 - x1, len(frame_timestamps), self.seq_len,
            self.max_area, self.downsample,
            (int(duration * target_fps) - 1) // self.downsample[0] + 1)
        target_duration = of / target_fps
        begin = 0.0 if self.zero_start else float(
            rng.uniform(0, duration - target_duration))
        ts = np.linspace(begin, begin + target_duration, of)
        ids = np.argmax((ts[:, None] >= frame_timestamps[None, :, 0])
                        & (ts[:, None] < frame_timestamps[None, :, 1]),
                        axis=1).tolist()
        return ids, (x1, x2, y1, y2), (oh, ow), target_fps

    def _frameids_keep_last(self, fps, frame_timestamps, h, w, crop_box, rng):
        """A uniform resample over the whole clip, the fps implied."""
        duration = float(frame_timestamps[-1].mean())
        x1, x2, y1, y2 = (0, w, 0, h) if crop_box is None else crop_box
        of, oh, ow = _latent_size(
            y2 - y1, x2 - x1, len(frame_timestamps), self.seq_len,
            self.max_area, self.downsample,
            (len(frame_timestamps) - 1) // self.downsample[0] + 1)
        ts = np.linspace(0.0, duration, of)
        ids = np.argmax((ts[:, None] >= frame_timestamps[None, :, 0])
                        & (ts[:, None] <= frame_timestamps[None, :, 1]),
                        axis=1).tolist()
        return ids, (x1, x2, y1, y2), (oh, ow), of / duration

    def get_frameid_bbox(self, fps, frame_timestamps, h, w, crop_box=None,
                         rng=None):
        rng = np.random.default_rng(2024) if rng is None else rng
        fn = (self._frameids_keep_last if self.keep_last
              else self._frameids_default)
        return fn(fps, frame_timestamps, h, w, crop_box, rng)

    # -- arrays

    def load_video_batch(self, *videos: np.ndarray, fps: float = 16.0,
                         crop_box=None, seed: int = 2024):
        """videos: [T, H, W, 3] decoded frames (uint8 or float in [0, 1]).
        Returns (*tensors [3, T', oh, ow] in [-1, 1], frame_ids, (oh, ow),
        fps)."""
        rng = np.random.default_rng(seed)
        length = min(v.shape[0] for v in videos)
        # synthetic per-frame [start, end) timestamps at the given fps
        starts = np.arange(length, dtype=np.float32) / fps
        frame_timestamps = np.stack([starts, starts + 1.0 / fps], axis=-1)
        h, w = videos[0].shape[1:3]
        ids, (x1, x2, y1, y2), (oh, ow), out_fps = self.get_frameid_bbox(
            fps, frame_timestamps, h, w, crop_box, rng)
        outs = [_resize_crop(_to_float01(np.asarray(v)[ids, y1:y2, x1:x2]),
                             oh, ow) for v in videos]
        return (*outs, ids, (oh, ow), out_fps)

    def load_video(self, video: np.ndarray, **kw):
        return self.load_video_batch(video, **kw)

    def load_video_pair(self, video: np.ndarray, mask: np.ndarray, **kw):
        return self.load_video_batch(video, mask, **kw)


def prepare_source(
    src_video: List[Optional[torch.Tensor]],
    src_mask: List[Optional[torch.Tensor]],
    src_ref_images: List[Optional[List[Optional[torch.Tensor]]]],
    num_frames: int,
    image_size: Tuple[int, int],
) -> Tuple[list, list, list]:
    """Fill the empty slots (a missing video -> zeros [3, T, H, W] and its
    mask -> ones [1, T, H, W]) and letterbox the reference images: fitted
    with the bilinear resize onto a white (+1) [3, 1, H, W] canvas,
    centred. Lists are updated in place and returned."""
    ch, cw = image_size
    for i, (v, m) in enumerate(zip(src_video, src_mask)):
        if v is None and m is None:
            src_video[i] = torch.zeros((3, num_frames, ch, cw))
            src_mask[i] = torch.ones((1, num_frames, ch, cw))
    for refs in src_ref_images:
        if refs is None:
            continue
        for j, ref in enumerate(refs):
            if ref is None or tuple(ref.shape[-2:]) == (ch, cw):
                continue
            rh, rw = ref.shape[-2:]
            scale = min(ch / rh, cw / rw)
            nh, nw = int(rh * scale), int(rw * scale)
            img = jax_resize2d(ref.reshape(3, rh, rw).permute(1, 2, 0)[None],
                               nh, nw, jax_linear_weights)[0]
            canvas = torch.ones((3, 1, ch, cw), dtype=ref.dtype)
            top, left = (ch - nh) // 2, (cw - nw) // 2
            canvas[:, 0, top:top + nh, left:left + nw] = img.permute(2, 0, 1)
            refs[j] = canvas
    return src_video, src_mask, src_ref_images
