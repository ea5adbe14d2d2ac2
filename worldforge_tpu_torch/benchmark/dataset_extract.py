"""DepthCrafter benchmark dataset extraction (Sintel, KITTI, Bonn,
ScanNet, NYUv2) into ``{seq}_rgb_left.mp4`` + ``{seq}_disparity.npz`` and a
CSV of both, the contract ``cli/depth_benchmark.py`` reads.

Counterpart of ``worldforge_tpu/benchmark/dataset_extract.py`` (host code,
on the port's ``io/frames.export_video``). Behavioural reference:
DepthCrafter's five ``benchmark/dataset_extract/dataset_extract_*.py``
scripts, which differ only in the depth decoding, the directory walk and a
fixed crop; one writer serves all five here. The mp4s are written with
cv2; the npz and CSV payloads are the reference's.

Per dataset (the reference script):
  sintel   .dpt files (TAG_FLOAT header, fp32)           sintel.py
  kitti    16-bit png / 256, zeros -> -1, even crop      kitti.py
  bonn     16-bit png / 5000 (TUM convention)            bonn.py
  scannet  16-bit png / 1000, crop [8:-8, 11:-11]        scannet.py
  nyu      16-bit png / 1000, crop [45:471, 41:601],
           pair list file (rgb, _, filled-depth)         nyu.py
"""

from __future__ import annotations

import csv
import os
import os.path as osp
from typing import List, Optional

import numpy as np

TAG_FLOAT = 202021.25  # Sintel .dpt magic


# ------------------------------------------------------------- readers


def sintel_depth_read(filename: str) -> np.ndarray:
    """MPI-Sintel .dpt (flownet float layout, sintel.py:24-42)."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, \
            f"sintel depth_read: wrong tag {check} (big-endian file?)"
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        assert 0 < width and 0 < height and width * height < 100000000
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(
            (height, width))


def kitti_depth_read(filename: str) -> np.ndarray:
    """16-bit png / 256; invalid (0) -> -1 (kitti.py:10-20)."""
    from PIL import Image

    depth_png = np.array(Image.open(filename), dtype=int)
    assert np.max(depth_png) > 255, "expected 16-bit KITTI depth png"
    depth = depth_png.astype(np.float64) / 256.0
    depth[depth_png == 0] = -1.0
    return depth


def png_depth_read(filename: str, factor: float,
                   zero_invalid: bool = False) -> np.ndarray:
    """16-bit png / factor (bonn: 5000, scannet/nyu: 1000).
    zero_invalid: map raw-0 (no measurement) to -1.0 — the TUM/bonn
    convention (dataset_extract_bonn.py:14-20); scannet/nyu keep 0."""
    from PIL import Image

    depth_png = np.asarray(Image.open(filename))
    depth = depth_png.astype(np.float64) / factor
    if zero_invalid:
        depth[depth_png == 0] = -1.0
    return depth


def _img_read(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


# ------------------------------------------------------ shared writer


def _numeric_sort(names: List[str]) -> List[str]:
    names = sorted(names)
    return sorted(names, key=lambda x: int(x.split(".")[0][-4:]))


def _write_sample(seq_key: str, imgs: List[np.ndarray],
                  depths: List[np.ndarray], dataset: str,
                  saved_rgb_dir: str, saved_disp_dir: str,
                  crop=None, even_crop: bool = False) -> dict:
    """mp4 + npz + sample-row contract shared by all five scripts."""
    from worldforge_tpu_torch.io.frames import export_video

    disp_video = np.array(depths)[:, None]           # [T, 1, H, W]
    img_video = np.array(imgs)[..., 0:3]             # [T, H, W, 3]
    if crop is not None:
        (y0, y1), (x0, x1) = crop
        disp_video = disp_video[:, :, y0:y1, x0:x1]
        img_video = img_video[:, y0:y1, x0:x1]
    if even_crop:  # kitti.py:81-93
        hh = disp_video.shape[-2] // 2 * 2
        ww = disp_video.shape[-1] // 2 * 2
        disp_video = disp_video[:, :, :hh, :ww]
        img_video = img_video[:, :hh, :ww]

    rgb_dir = saved_rgb_dir + dataset
    disp_dir = saved_disp_dir + dataset
    rgb_path = os.path.join(rgb_dir, f"{seq_key}_rgb_left.mp4")
    disp_path = os.path.join(disp_dir, f"{seq_key}_disparity.npz")
    os.makedirs(os.path.dirname(rgb_path), exist_ok=True)
    os.makedirs(os.path.dirname(disp_path), exist_ok=True)

    export_video(list(img_video), rgb_path, fps=15)
    np.savez(disp_path, disparity=disp_video)
    return {"filepath_left": f"{dataset}/{seq_key}_rgb_left.mp4",
            "filepath_disparity": f"{dataset}/{seq_key}_disparity.npz"}


def _write_csv(csv_save_path: str, samples: List[dict]) -> None:
    os.makedirs(os.path.dirname(csv_save_path) or ".", exist_ok=True)
    with open(csv_save_path, "w") as f:
        w = csv.DictWriter(f, fieldnames=["filepath_left",
                                          "filepath_disparity"])
        w.writeheader()
        w.writerows(samples)
    print(f"{csv_save_path} has been saved.")


def _windows(seq_len: int, sample_len: int):
    step = sample_len if sample_len > 0 else seq_len
    for ref_idx in range(0, seq_len, step):
        if ref_idx + step <= seq_len:
            yield ref_idx, ref_idx + step


# ------------------------------------------------------------ datasets


def extract_sintel(root, depth_root, sample_len=-1, csv_save_path="",
                   dataset_name="sintel", saved_rgb_dir="",
                   saved_disp_dir=""):
    samples = []
    for seq_name in sorted(os.listdir(root)):
        names = _numeric_sort([x for x in os.listdir(osp.join(root, seq_name))
                               if x.endswith(".png")])
        for a, b in _windows(len(names), sample_len):
            imgs = [_img_read(osp.join(root, seq_name, names[i]))
                    for i in range(a, b)]
            deps = [sintel_depth_read(
                osp.join(depth_root, seq_name, names[i][:-3] + "dpt"))
                for i in range(a, b)]
            samples.append(_write_sample(seq_name, imgs, deps, dataset_name,
                                         saved_rgb_dir, saved_disp_dir))
    _write_csv(csv_save_path, samples)
    return samples


def extract_kitti(root, depth_root, sample_len=-1, csv_save_path="",
                  dataset_name="KITTI", saved_rgb_dir="", saved_disp_dir="",
                  start_frame=0, end_frame=110):
    samples = []
    for seq_name in sorted(os.listdir(depth_root)):
        ddir = osp.join(depth_root, seq_name, "proj_depth/groundtruth/image_02")
        names = _numeric_sort([x for x in os.listdir(ddir)
                               if x.endswith(".png")])[start_frame:end_frame]
        for a, b in _windows(len(names), sample_len):
            imgs = [_img_read(osp.join(root, seq_name[0:10], seq_name,
                                       "image_02/data", names[i]))
                    for i in range(a, b)]
            deps = [kitti_depth_read(osp.join(ddir, names[i]))
                    for i in range(a, b)]
            samples.append(_write_sample(seq_name, imgs, deps, dataset_name,
                                         saved_rgb_dir, saved_disp_dir,
                                         even_crop=True))
    _write_csv(csv_save_path, samples)
    return samples


def extract_bonn(root, depth_root, sample_len=-1, csv_save_path="",
                 dataset_name="bonn", saved_rgb_dir="", saved_disp_dir="",
                 start_frame=30, end_frame=140):
    """Frame window 30..140 and even-crop per the reference's bonn
    protocol (dataset_extract_bonn.py:90-103,153-154)."""
    samples = []
    for seq_name in sorted(os.listdir(depth_root)):
        rgbs = _numeric_sort([x for x in os.listdir(
            osp.join(depth_root, seq_name, "rgb")) if x.endswith(".png")])
        deps_n = _numeric_sort([x for x in os.listdir(
            osp.join(depth_root, seq_name, "depth")) if x.endswith(".png")])
        rgbs = rgbs[start_frame:end_frame]
        deps_n = deps_n[start_frame:end_frame]
        for a, b in _windows(len(rgbs), sample_len):
            imgs = [_img_read(osp.join(root, seq_name, "rgb", rgbs[i]))
                    for i in range(a, b)]
            deps = [png_depth_read(
                osp.join(depth_root, seq_name, "depth", deps_n[i]), 5000.0,
                zero_invalid=True)
                for i in range(a, b)]
            samples.append(_write_sample(seq_name, imgs, deps, dataset_name,
                                         saved_rgb_dir, saved_disp_dir,
                                         even_crop=True))
    _write_csv(csv_save_path, samples)
    return samples


def extract_scannet(root, sample_len=-1, csv_save_path="",
                    dataset_name="scannet", scene_number=16,
                    scene_frames_len=120, stride=1, saved_rgb_dir="",
                    saved_disp_dir=""):
    samples = []
    for seq_name in sorted(os.listdir(root))[:scene_number]:
        names = sorted([x for x in os.listdir(osp.join(root, seq_name,
                                                       "color"))
                        if x.endswith(".jpg")],
                       key=lambda x: int(x.split(".")[0]))
        names = names[:scene_frames_len:stride]
        for a, b in _windows(len(names), sample_len):
            imgs = [_img_read(osp.join(root, seq_name, "color", names[i]))
                    for i in range(a, b)]
            deps = [png_depth_read(
                osp.join(root, seq_name, "depth", names[i][:-3] + "png"),
                1000.0) for i in range(a, b)]
            samples.append(_write_sample(
                seq_name, imgs, deps, dataset_name, saved_rgb_dir,
                saved_disp_dir, crop=((8, -8), (11, -11))))
    _write_csv(csv_save_path, samples)
    return samples


def extract_nyu(root, depth_root, csv_save_path="", dataset_name="NYUv2",
                filename_ls_path="", saved_rgb_dir="", saved_disp_dir=""):
    with open(filename_ls_path) as f:
        filenames = [s.split() for s in f.readlines()]
    samples = []
    for pair in filenames:
        img_name, filled_depth_name = pair[0], pair[2]
        imgs = [_img_read(osp.join(root, img_name))]
        deps = [png_depth_read(osp.join(depth_root, filled_depth_name),
                               1000.0)]
        samples.append(_write_sample(
            img_name[:-4], imgs, deps, dataset_name, saved_rgb_dir,
            saved_disp_dir, crop=((45, 471), (41, 601))))
    _write_csv(csv_save_path, samples)
    return samples


EXTRACTORS = {"sintel": extract_sintel, "kitti": extract_kitti,
              "bonn": extract_bonn, "scannet": extract_scannet,
              "nyu": extract_nyu}
