"""Keypoint extractors for the tracking path.

Counterpart of ``worldforge_tpu/sfm/extractors.py``: "+"-separated method
strings ("aliked", "sp", "sift", "aliked+sp+sift"), each extractor giving
keypoints that are concatenated (sub-pixel unless rounding is asked for).

- aliked: ``sfm/aliked.py`` (the default) on the device;
- sp:     ``sfm/superpoint.py`` on the device;
- sift:   OpenCV SIFT on the host, as in JAX (only the coordinates are
          used downstream).

Every extractor is ``extract_fn(image_hw3 float [0, 1]) -> [K, 2] float
(x, y)`` on the host, which ``sfm/track_predict.py`` calls. Random init
(no converted weights) draws ALIKED from a generator seeded 0 and
SuperPoint from one seeded 1 on the device: the same seeds as JAX's keys,
other numbers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import numpy as np
import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import resolve_device


def sift_extract(image_hw3: np.ndarray, max_num_keypoints: int = 4096
                 ) -> np.ndarray:
    """cv2 SIFT keypoints, strongest first ([K, 2] float (x, y))."""
    import cv2

    gray = cv2.cvtColor((np.asarray(image_hw3) * 255.0).astype(np.uint8),
                        cv2.COLOR_RGB2GRAY)
    sift = cv2.SIFT_create(nfeatures=max_num_keypoints)
    kps = sift.detect(gray, None)
    if not kps:
        return np.zeros((0, 2), np.float32)
    kps = sorted(kps, key=lambda k: -k.response)[:max_num_keypoints]
    return np.asarray([k.pt for k in kps], np.float32)


def _device_of(params) -> torch.device:
    leaves = []
    P.tree_map(leaves.append, params)
    return leaves[0].device


@torch.inference_mode()
def _run(forward, params, cfg, image: np.ndarray):
    x = torch.as_tensor(image, dtype=torch.float32,
                        device=_device_of(params))[None]
    out = forward(params, cfg, x)
    return (out["keypoints"][0].cpu().numpy(),
            out["scores"][0].cpu().numpy())


def make_superpoint_extractor(params, cfg) -> Callable:
    """SuperPoint on the device of ``params``, on the NTSC grey image."""
    from worldforge_tpu_torch.sfm.superpoint import superpoint_forward

    def extract(image_hw3: np.ndarray) -> np.ndarray:
        img = np.asarray(image_hw3, np.float32)
        gray = img @ np.asarray([0.2989, 0.587, 0.114], np.float32)
        kpts, scores = _run(superpoint_forward, params, cfg,
                            gray[:, :, None])
        return kpts[scores > 0]

    return extract


def make_aliked_extractor(params, cfg) -> Callable:
    """ALIKED on the device of ``params``, on the image edge-padded to a
    multiple of 32; keypoints in the margin are dropped."""
    from worldforge_tpu_torch.sfm.aliked import aliked_forward, \
        pad_to_multiple

    def extract(image_hw3: np.ndarray) -> np.ndarray:
        hh, ww = image_hw3.shape[:2]
        padded = pad_to_multiple(np.asarray(image_hw3, np.float32))
        kpts, scores = _run(aliked_forward, params, cfg, padded)
        ok = (scores > 0) & (kpts[:, 0] < ww) & (kpts[:, 1] < hh)
        return kpts[ok]

    return extract


def make_extractors(method: str = "aliked", max_query_num: int = 4096,
                    det_thres: float = 0.005, superpoint_params=None,
                    superpoint_cfg=None, aliked_params=None, aliked_cfg=None,
                    device=None) -> Dict[str, Callable]:
    """{name: extract_fn} for a method string. Unknown methods are skipped
    with a warning; none left -> ALIKED. Extractors without converted
    weights are drawn on ``device`` (the card unless the CPU is asked
    for)."""
    extractors: Dict[str, Callable] = {}

    def _aliked():
        from worldforge_tpu_torch.sfm.aliked import ALIKEDConfig, init_aliked
        cfg = dataclasses.replace(aliked_cfg or ALIKEDConfig.n16(),
                                  max_num_keypoints=max_query_num,
                                  detection_threshold=det_thres)
        p = aliked_params
        if p is None:
            p = init_aliked(P.make_generator(0, resolve_device(device)), cfg)
        return make_aliked_extractor(p, cfg)

    for m in method.lower().split("+"):
        m = m.strip()
        if m == "aliked":
            extractors["aliked"] = _aliked()
        elif m == "sp":
            from worldforge_tpu_torch.sfm.superpoint import (
                SuperPointConfig, init_superpoint)
            cfg = dataclasses.replace(superpoint_cfg or SuperPointConfig(),
                                      max_num_keypoints=max_query_num,
                                      detection_threshold=det_thres)
            p = superpoint_params
            if p is None:
                p = init_superpoint(
                    P.make_generator(1, resolve_device(device)), cfg)
            extractors["sp"] = make_superpoint_extractor(p, cfg)
        elif m == "sift":
            extractors["sift"] = functools.partial(
                sift_extract, max_num_keypoints=max_query_num)
        else:
            print(f"Warning: unknown feature extractor '{m}', ignoring.")
    if not extractors:
        print(f"Warning: no valid extractors in '{method}', "
              f"using ALIKED by default.")
        extractors["aliked"] = _aliked()
    return extractors


def combined_extract_fn(extractors: Dict[str, Callable],
                        round_keypoints: bool = False) -> Callable:
    """Concatenate every extractor's keypoints, rounded if asked (the
    tracking path keeps them sub-pixel)."""

    def extract(image_hw3: np.ndarray) -> np.ndarray:
        parts = []
        for fn in extractors.values():
            k = np.asarray(fn(image_hw3), np.float32)
            if round_keypoints:
                k = np.round(k)
            parts.append(k.reshape(-1, 2))
        return np.concatenate(parts, axis=0) if parts else \
            np.zeros((0, 2), np.float32)

    return extract
