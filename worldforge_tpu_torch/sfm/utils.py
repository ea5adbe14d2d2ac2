"""VGGSfM support utilities: query-frame ranking and index plumbing.

Counterpart of ``worldforge_tpu/sfm/utils.py``, host numpy as in JAX:
farthest point sampling over a frame distance matrix, ranking frames by
feature similarity (the most central frame first), and the index order
that swaps a query frame with frame 0.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def farthest_point_sampling(distance_matrix: np.ndarray, num_samples: int,
                            most_common_frame_index: int = 0) -> List[int]:
    """Greedy FPS over a pairwise distance matrix."""
    dm = np.maximum(np.asarray(distance_matrix, np.float64), 0.0)
    n = dm.shape[0]
    selected = [most_common_frame_index]
    check = dm[most_common_frame_index].copy()
    check[selected] = 0
    while len(selected) < num_samples and len(selected) < n:
        far = int(np.argmax(check))
        selected.append(far)
        check = dm[far].copy()
        check[selected] = 0
    return selected


def rank_frames_by_similarity(features: np.ndarray, query_frame_num: int,
                              spatial: bool = False) -> List[int]:
    """features [S, D] (class tokens) or [S, P, D] (patch tokens, with
    ``spatial``): cosine similarity, the most central frame first, FPS for
    the rest."""
    f = np.asarray(features, np.float64)
    f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    if spatial:
        sim = np.einsum("spd,qpd->sq", f, f) / f.shape[1]
    else:
        sim = f @ f.T
    dist = 100.0 - sim
    np.fill_diagonal(sim, -100.0)
    most_common = int(np.argmax(sim.sum(axis=1)))
    return farthest_point_sampling(dist, query_frame_num, most_common)


def calculate_index_mappings(query_index: int, s: int) -> np.ndarray:
    """The frame order that swaps ``query_index`` and 0."""
    order = np.arange(s)
    order[0] = query_index
    order[query_index] = 0
    return order


def switch_tensor_order(tensors: Sequence, order: np.ndarray, dim: int = 1):
    """Reorder each array (or None) along ``dim``."""
    return [None if t is None else np.take(np.asarray(t), order, axis=dim)
            for t in tensors]
