"""Crack filling and outlier removal for warped frames, on the host.

Host numpy / cv2 / scipy copy of ``worldforge_tpu/warp/cracks.py``
(``fill_small_cracks`` :35, ``depth_aware_crack_filling`` :221 and their
helpers; the port imports nothing of the JAX package). They run once per
output frame on small images, and cv2's morphology and filter borders keep
the warp masks bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
from scipy import ndimage

DEFAULT_CRACK_PARAMS: Dict = {
    "depth_threshold": 0.1,
    "max_crack_size": 5,
    "min_valid_neighbors": 3,
    "min_neighbors": 4,
    "neighbor_radius": 1,
    "skip_outlier_detection": False,
    "use_fast_outlier_detection": True,
}


def _neighbor_kernel(radius: int = 1, zero_center: bool = True) -> np.ndarray:
    k = np.ones((2 * radius + 1, 2 * radius + 1), np.float32)
    if zero_center:
        k[radius, radius] = 0
    return k


def fill_small_cracks(warped_image: np.ndarray, warped_mask: np.ndarray,
                      original_depth: Optional[np.ndarray],
                      depth_conf=None, depth_threshold: float = 0.1,
                      max_crack_size: int = 5,
                      min_valid_neighbors: int = 3
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Morphological close + neighbor-average fill, then a depth-guided fill
    for <=4-px connected holes (utils_warp.py:386-464)."""
    filled_image = warped_image.copy()
    filled_mask = warped_mask.copy()
    holes = warped_mask == 0
    if not holes.any():
        return filled_image, filled_mask
    H, W = warped_mask.shape

    closed = cv2.morphologyEx(filled_mask.astype(np.uint8), cv2.MORPH_CLOSE,
                              np.ones((3, 3), np.uint8))
    newly = (closed > filled_mask) & (filled_mask == 0)

    morph_count = 0
    if newly.any():
        kn = _neighbor_kernel(1)
        counts = cv2.filter2D(filled_mask.astype(np.float32), -1, kn)
        fill_ok = newly & (counts >= min_valid_neighbors)
        if fill_ok.any():
            safe = np.maximum(counts, 1e-6)
            mbool = filled_mask > 0
            if warped_image.ndim == 3:
                for c in range(warped_image.shape[2]):
                    ch = np.where(mbool, warped_image[:, :, c], 0.0).astype(
                        np.float32)
                    s = cv2.filter2D(ch, -1, kn)
                    filled_image[fill_ok, c] = (s / safe)[fill_ok]
            else:
                mi = np.where(mbool, warped_image, 0.0).astype(np.float32)
                s = cv2.filter2D(mi, -1, kn)
                filled_image[fill_ok] = (s / safe)[fill_ok]
            filled_mask[fill_ok] = 1
            morph_count = int(fill_ok.sum())

    if depth_conf is not None and original_depth is not None and \
            morph_count < holes.sum() * 0.5:
        cur_holes = filled_mask == 0
        labeled, n = ndimage.label(cur_holes)
        for hid in range(1, n + 1):
            hm = labeled == hid
            size = hm.sum()
            if size <= max_crack_size and size <= 4:
                ys, xs = np.where(hm)
                for y, x in zip(ys, xs):
                    y0, y1 = max(0, y - 1), min(H, y + 2)
                    x0, x1 = max(0, x - 1), min(W, x + 2)
                    nm = filled_mask[y0:y1, x0:x1] > 0
                    if nm.sum() >= min_valid_neighbors:
                        nd = original_depth[y0:y1, x0:x1][nm]
                        dv = np.abs(nd - original_depth[y, x]) <= depth_threshold
                        if dv.sum() >= min_valid_neighbors:
                            colors = filled_image[y0:y1, x0:x1][nm][dv]
                            filled_image[y, x] = colors.mean(axis=0)
                            filled_mask[y, x] = 1
    return filled_image, filled_mask


def remove_outliers(warped_image, warped_mask, warped_depth,
                    min_neighbors: int = 4, neighbor_radius: int = 1):
    """Drop valid pixels with too few valid neighbors (utils_warp:469-500)."""
    img, m, d = warped_image.copy(), warped_mask.copy(), warped_depth.copy()
    valid = int((warped_mask > 0).sum())
    if valid == 0 or valid < min_neighbors * 2:
        return img, m, d
    kn = _neighbor_kernel(neighbor_radius)
    mf = (warped_mask > 0).astype(np.float32)
    if valid > 5000:
        counts = cv2.filter2D(mf, -1, kn)        # reflect-101 border
    else:
        # the reference routes small data to scipy with a constant-0
        # border (utils_warp.py:486-489) — border pixels get FEWER
        # neighbors than under cv2's reflection, so edge outliers are
        # removed exactly as in the reference
        from scipy import ndimage
        counts = ndimage.convolve(mf, kn, mode="constant", cval=0.0)
    out = (warped_mask > 0) & (counts < min_neighbors)
    if out.any():
        m[out] = 0
        img[out] = 0
        d[out] = np.nan
    return img, m, d


def segment_depth_map(depth_map, depth_mask, num_segments: int = 5):
    """Split the depth range into equal bands (utils_warp.py:506-535)."""
    valid = depth_mask > 0
    vd = depth_map[valid]
    if vd.size == 0:
        return [], []
    lo, hi = np.nanmin(vd), np.nanmax(vd)
    if lo == hi:
        return [valid], [(lo, hi)]
    bounds = np.linspace(lo, hi, num_segments + 1)
    segs, ranges = [], []
    for i in range(num_segments):
        a, b = bounds[i], bounds[i + 1]
        if i == num_segments - 1:
            segs.append((depth_map >= a) & (depth_map <= b) & valid)
        else:
            segs.append((depth_map >= a) & (depth_map < b) & valid)
        ranges.append((a, b))
    return segs, ranges


def _estimate_filled_depth(depth, newly, ksize: int = 3):
    """Neighbor-average depth for filled pixels (utils_warp.py:538-561)."""
    if not newly.any():
        return depth.copy()
    valid = ~np.isnan(depth)
    k = _neighbor_kernel(ksize // 2)
    dsum = cv2.filter2D(np.where(valid, depth, 0.0).astype(np.float32), -1,
                        k, borderType=cv2.BORDER_REFLECT)
    cnt = cv2.filter2D(valid.astype(np.float32), -1, k,
                       borderType=cv2.BORDER_REFLECT)
    avg = dsum / np.maximum(cnt, 1e-6)
    out = depth.copy()
    out[newly] = avg[newly]
    return out


def fill_segment_cracks(warped_image, warped_depth, segment_mask,
                        params: Dict):
    """Per-depth-band outlier removal + fill (utils_warp.py:563-624)."""
    if segment_mask.sum() == 0:
        return warped_image.copy(), segment_mask.copy(), warped_depth.copy()
    if params.get("skip_outlier_detection", False):
        ci, cm, cd = warped_image, segment_mask, warped_depth
    elif params.get("use_fast_outlier_detection", True):
        # fast path: kernel does NOT zero the center (reference :603-607)
        kn = _neighbor_kernel(params.get("neighbor_radius", 1),
                              zero_center=False)
        counts = cv2.filter2D(segment_mask.astype(np.float32), -1, kn)
        out = (segment_mask > 0) & (counts < params.get("min_neighbors", 4))
        cm = segment_mask.copy()
        cm[out] = 0
        ci, cd = warped_image, warped_depth
    else:
        ci, cm, cd = remove_outliers(
            warped_image, segment_mask, warped_depth,
            params.get("min_neighbors", 4), params.get("neighbor_radius", 1))

    holes = (cm == 0) & (segment_mask > 0)
    if not holes.any():
        return ci, cm, cd
    fi, fm = fill_small_cracks(
        ci, cm, cd, depth_threshold=params.get("depth_threshold", 0.1),
        max_crack_size=params.get("max_crack_size", 5),
        min_valid_neighbors=params.get("min_valid_neighbors", 3))
    newly = (fm > 0) & (cm == 0)
    fd = _estimate_filled_depth(cd, newly) if newly.any() else cd
    return fi, fm, fd


def merge_depth_segments(filled_results: List, image_shape):
    """Far-to-near overwrite merge (utils_warp.py:627-661). Returns None
    only for an EMPTY results list (the reference's :629-630 guard, dead
    in practice); when segments exist but none has valid pixels the
    reference returns the all-zero image/mask — so must we, or the caller
    takes a fill_small_cracks fallback the reference never takes."""
    if not filled_results:
        return None, None, None
    H, W, C = image_shape
    mi = np.zeros((H, W, C), np.float32)
    mm = np.zeros((H, W), np.uint8)
    md = np.full((H, W), np.nan, np.float32)
    pri = []
    for i, (fi, fm, fd) in enumerate(filled_results):
        if fi is not None and (fm > 0).any():
            vd = fd[~np.isnan(fd) & (fm > 0)]
            pri.append((vd.mean() if vd.size else np.inf, i, fi, fm, fd))
    pri.sort(key=lambda x: x[0], reverse=True)
    for _, _, fi, fm, fd in pri:
        ok = (fm > 0) & (~np.isnan(fd))
        if ok.any():
            mi[ok] = fi[ok]
            mm[ok] = fm[ok]
            md[ok] = fd[ok]
    return mi, mm, md


def depth_aware_crack_filling(warped_image, warped_mask, warped_depth,
                              params: Optional[Dict] = None,
                              num_segments: int = 5):
    """Layered (depth-banded) crack filling (utils_warp.py:664-704)."""
    params = {**DEFAULT_CRACK_PARAMS, **(params or {})}
    segs, _ = segment_depth_map(warped_depth, warped_mask, num_segments)
    if not segs:
        fi, fm = fill_small_cracks(
            warped_image, warped_mask, warped_depth,
            depth_threshold=params["depth_threshold"],
            max_crack_size=params["max_crack_size"],
            min_valid_neighbors=params["min_valid_neighbors"])
        return fi, fm, warped_depth
    results = []
    for sm in segs:
        if sm.sum() == 0:
            results.append((None, None, None))
            continue
        results.append(fill_segment_cracks(warped_image, warped_depth, sm,
                                           params))
    mi, mm, md = merge_depth_segments(results, warped_image.shape)
    if mi is None:
        fi, fm = fill_small_cracks(
            warped_image, warped_mask, warped_depth,
            depth_threshold=params["depth_threshold"],
            max_crack_size=params["max_crack_size"],
            min_valid_neighbors=params["min_valid_neighbors"])
        return fi, fm, warped_depth
    return mi, mm, md
