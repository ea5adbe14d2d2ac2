"""Depth evaluation metrics and least-squares disparity alignment.

Counterpart of ``worldforge_tpu/utils/depth_metrics.py``, a plain numpy
copy. Behavioural reference: DepthCrafter's ``benchmark/eval/metric.py``
and ``eval.py`` (per-sequence least-squares alignment in disparity space
before AbsRel, the delta thresholds, RMSE, ...).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def align_disparity_lstsq(pred: np.ndarray, gt: np.ndarray,
                          mask: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, float, float]:
    """Fit pred_aligned = a * pred + b to gt by least squares over valid
    pixels (both in disparity space). Returns (aligned pred, a, b)."""
    if mask is None:
        mask = np.isfinite(gt) & np.isfinite(pred) & (gt > 0)
    x = pred[mask].reshape(-1)
    y = gt[mask].reshape(-1)
    A = np.stack([x, np.ones_like(x)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    return a * pred + b, float(a), float(b)


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  mask: Optional[np.ndarray] = None,
                  align: bool = True) -> Dict[str, float]:
    """AbsRel, delta1/2/3, RMSE, RMSE(log), log10, SILog over valid pixels
    (metric.py:1-128 definitions)."""
    if mask is None:
        mask = np.isfinite(gt) & (gt > 0) & np.isfinite(pred)
    if align:
        pred, _, _ = align_disparity_lstsq(pred, gt, mask)
    p = np.clip(pred[mask], 1e-6, None)
    g = np.clip(gt[mask], 1e-6, None)

    thresh = np.maximum(g / p, p / g)
    abs_rel = float(np.mean(np.abs(p - g) / g))
    sq_rel = float(np.mean(((p - g) ** 2) / g))
    rmse = float(np.sqrt(np.mean((p - g) ** 2)))
    rmse_log = float(np.sqrt(np.mean((np.log(p) - np.log(g)) ** 2)))
    log10 = float(np.mean(np.abs(np.log10(p) - np.log10(g))))
    err = np.log(p) - np.log(g)
    silog = float(np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100)
    return {
        "abs_rel": abs_rel,
        "sq_rel": sq_rel,
        "rmse": rmse,
        "rmse_log": rmse_log,
        "log10": log10,
        "silog": silog,
        "delta1": float(np.mean(thresh < 1.25)),
        "delta2": float(np.mean(thresh < 1.25 ** 2)),
        "delta3": float(np.mean(thresh < 1.25 ** 3)),
    }
