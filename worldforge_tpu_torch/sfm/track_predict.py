"""Track prediction for SfM: several query frames, tracks over all frames.

Counterpart of ``worldforge_tpu/sfm/track_predict.py``: query frames
ranked by feature similarity and FPS (frame 0 first), the coarse feature
maps computed once for the sequence, per query frame its keypoints
(colours, and confidence / 3D points gating: conf > 1.2, kept when more
than 512 survive), the frames reordered so the query is frame 0, tracking
in chunks of queries, and the order restored; then, while a frame has
fewer than ``min_vis`` tracks visible above ``non_vis_thresh``, that frame
is queried again, and on the second failure of the same frame one last
trial queries every failing frame with a fresh extractor set.

The host keeps the orchestration (numpy); the tracker runs on the device,
where the images and feature maps stay for the whole call, and each query
chunk reads its tracks and visibilities back in one copy.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.sfm.tracker import (compute_tracker_fmaps,
                                              sfm_tracker_forward)
from worldforge_tpu_torch.sfm.utils import (calculate_index_mappings,
                                            rank_frames_by_similarity,
                                            switch_tensor_order)


def _forward_on_query(query_index: int, images: np.ndarray,
                      images_dev: torch.Tensor, fmaps: torch.Tensor,
                      tracker_params, extract_fn, conf, points_3d,
                      max_points_num: int, fine_tracking: bool,
                      coarse_iters: int):
    s, hh, ww, _ = images.shape
    kpts = np.asarray(extract_fn(images[query_index]))
    kpts = kpts[(kpts[:, 0] >= 0) & (kpts[:, 1] >= 0)]
    if kpts.shape[0] == 0:
        kpts = np.asarray([[ww / 2.0, hh / 2.0]], np.float32)

    kl = np.clip(np.round(kpts).astype(np.int64), 0, [ww - 1, hh - 1])
    colors = (images[query_index][kl[:, 1], kl[:, 0]] * 255).astype(np.uint8)

    pred_conf = pred_p3d = None
    if conf is not None and points_3d is not None:
        scale = conf.shape[-1] / ww
        ks = np.clip(np.round(kpts * scale).astype(np.int64), 0,
                     conf.shape[-1] - 1)
        pred_conf = conf[query_index][ks[:, 1], ks[:, 0]]
        pred_p3d = points_3d[query_index][ks[:, 1], ks[:, 0]]
        valid = pred_conf > 1.2
        if valid.sum() > 512:
            kpts, colors = kpts[valid], colors[valid]
            pred_conf, pred_p3d = pred_conf[valid], pred_p3d[valid]

    order = calculate_index_mappings(query_index, s)
    order_dev = torch.as_tensor(order, device=images_dev.device)
    imgs_feed = images_dev.index_select(0, order_dev)[None]
    fmaps_feed = fmaps.index_select(1, order_dev)

    n = kpts.shape[0]
    chunks = max(1, -(-s * n // max_points_num))
    out = []
    for qc in np.array_split(kpts, chunks):
        qp = torch.as_tensor(qc, dtype=torch.float32,
                             device=images_dev.device)[None]
        fine, _, v = sfm_tracker_forward(
            tracker_params, imgs_feed, qp, coarse_iters=coarse_iters,
            fine_tracking=fine_tracking, fmaps=fmaps_feed)
        # one copy back per chunk: (x, y, vis)
        out.append(torch.cat([fine[0], v[0][..., None]], dim=-1).cpu()
                   .numpy())
    res = np.concatenate(out, axis=1)
    track, visv = switch_tensor_order([res[..., :2], res[..., 2]], order,
                                      dim=0)
    return track, visv, pred_conf, pred_p3d, colors


@torch.inference_mode()
def predict_tracks(
    tracker_params,
    images: np.ndarray,               # [S, H, W, 3] in [0, 1]
    extract_fn: Callable[[np.ndarray], np.ndarray],
    rank_features: Optional[np.ndarray] = None,   # [S, D] for FPS ranking
    conf: Optional[np.ndarray] = None,
    points_3d: Optional[np.ndarray] = None,
    query_frame_num: int = 5,
    max_points_num: int = 163840,
    fine_tracking: bool = True,
    complete_non_vis: bool = True,
    min_vis: int = 500,
    non_vis_thresh: float = 0.1,
    coarse_iters: int = 6,
    final_trial_extract_fn: Optional[Callable] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
           Optional[np.ndarray], np.ndarray]:
    """-> (tracks [S, P, 2], vis [S, P], confs, points3d, colors [P, 3]
    uint8). The tracker runs on ``device`` (the card unless the CPU is
    asked for), where ``tracker_params`` must live.
    ``final_trial_extract_fn`` is the augmentation loop's last "all-in"
    extractor set (the reference builds a fresh 2,048-keypoint
    sp + sift + aliked set); without it the last trial reuses
    ``extract_fn``, which adds no new tracks, and says so."""
    dev = resolve_device(device)
    s = images.shape[0]
    if rank_features is not None:
        query_frames = rank_frames_by_similarity(
            rank_features, min(query_frame_num, s))
    else:
        query_frames = list(range(min(query_frame_num, s)))
    if 0 in query_frames:
        query_frames.remove(0)
    query_frames = [0, *query_frames][:query_frame_num]

    images_dev = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                                 device=dev)
    fmaps = compute_tracker_fmaps(tracker_params, images_dev[None])

    tracks, viss, confs, p3ds, colors = [], [], [], [], []

    def run(qi, efn):
        t, v, c, p, col = _forward_on_query(
            qi, images, images_dev, fmaps, tracker_params, efn, conf,
            points_3d, max_points_num, fine_tracking, coarse_iters)
        tracks.append(t)
        viss.append(v)
        if c is not None:
            confs.append(c)
            p3ds.append(p)
        colors.append(col)

    for qi in query_frames:
        run(qi, extract_fn)

    if complete_non_vis:
        last_query, final_trial = -1, False
        while True:
            vis_all = np.concatenate(viss, axis=1)
            enough = (vis_all > non_vis_thresh).sum(axis=-1)
            non_vis = np.where(enough < min_vis)[0].tolist()
            if not non_vis or final_trial:
                break
            cur_fn = extract_fn
            if non_vis[0] == last_query:
                final_trial = True           # the last try: all of them
                todo = non_vis
                if final_trial_extract_fn is not None:
                    cur_fn = final_trial_extract_fn
                else:
                    print("predict_tracks: no final_trial_extract_fn — "
                          "the all-in retry reuses the same extractor "
                          "(deterministic, adds no new tracks)")
            else:
                todo = [non_vis[0]]
            last_query = non_vis[0]
            for qi in todo:
                run(qi, cur_fn)

    return (np.concatenate(tracks, axis=1),
            np.concatenate(viss, axis=1),
            np.concatenate(confs, axis=0) if confs else None,
            np.concatenate(p3ds, axis=0) if p3ds else None,
            np.concatenate(colors, axis=0))
