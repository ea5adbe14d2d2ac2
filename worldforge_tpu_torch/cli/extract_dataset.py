"""Benchmark dataset extraction CLI: one front end for the five dataset
readers of ``benchmark/dataset_extract.py`` (DepthCrafter's
``dataset_extract_*.py`` scripts). Host code: no device work.

Counterpart of ``worldforge_tpu/cli/extract_dataset.py``.

    python -m worldforge_tpu_torch.cli.extract_dataset --dataset sintel \
        --root .../training_image/clean --depth-root .../training/depth \
        --out ./benchmark/datasets/
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from worldforge_tpu_torch.benchmark.dataset_extract import EXTRACTORS

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=sorted(EXTRACTORS), required=True)
    ap.add_argument("--root", required=True, help="image root")
    ap.add_argument("--depth-root", default=None,
                    help="depth root (defaults to --root)")
    ap.add_argument("--out", default="./benchmark/datasets/",
                    help="output dir for mp4/npz/CSV")
    ap.add_argument("--csv", default=None,
                    help="CSV path (default <out>/<dataset>.csv)")
    ap.add_argument("--sample-len", type=int, default=-1)
    ap.add_argument("--start-frame", type=int, default=None,
                    help="default: kitti 0, bonn 30 (reference protocols)")
    ap.add_argument("--end-frame", type=int, default=None,
                    help="default: kitti 110, bonn 140")
    ap.add_argument("--filename-list", default=None,
                    help="NYU pair-list file (rgb, _, filled depth)")
    ap.add_argument("--scene-number", type=int, default=16)
    ap.add_argument("--scene-frames-len", type=int, default=120)
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args(argv)

    out = args.out if args.out.endswith("/") else args.out + "/"
    csv_path = args.csv or f"{out}{args.dataset}.csv"
    depth_root = args.depth_root or args.root
    common = dict(csv_save_path=csv_path, saved_rgb_dir=out,
                  saved_disp_dir=out)

    if args.dataset == "sintel":
        EXTRACTORS["sintel"](args.root, depth_root,
                             sample_len=args.sample_len, **common)
    elif args.dataset == "kitti":
        s = 0 if args.start_frame is None else args.start_frame
        e = 110 if args.end_frame is None else args.end_frame
        EXTRACTORS["kitti"](args.root, depth_root,
                            sample_len=args.sample_len,
                            start_frame=s, end_frame=e, **common)
    elif args.dataset == "bonn":
        s = 30 if args.start_frame is None else args.start_frame
        e = 140 if args.end_frame is None else args.end_frame
        EXTRACTORS["bonn"](args.root, depth_root,
                           sample_len=args.sample_len,
                           start_frame=s, end_frame=e, **common)
    elif args.dataset == "scannet":
        EXTRACTORS["scannet"](args.root, sample_len=args.sample_len,
                              scene_number=args.scene_number,
                              scene_frames_len=args.scene_frames_len,
                              stride=args.stride, **common)
    else:
        if not args.filename_list:
            ap.error("--filename-list is required for nyu")
        EXTRACTORS["nyu"](args.root, depth_root,
                          filename_ls_path=args.filename_list, **common)


if __name__ == "__main__":
    main()
