"""Single-image 3D warp CLI (the VGGT stage), PyTorch port.

The flag surface of ``worldforge_tpu/cli/run_warp.py``, plus ``--device``.
Depth and camera come from VGGT when a checkpoint is given (loading one
waits for the checkpoint converters); ``--depth_npz`` runs the warp from
precomputed depth, conf, extrinsic and intrinsic::

    python -m worldforge_tpu_torch.cli.run_warp --image_path img.png \
        --depth_npz depth.npz --output_path out --device cpu

Outputs, the warp-stage contract: ``warped_images/warp_*.png`` +
``mask_*.png``, ``warp_preview.mp4`` and ``camera_info.txt``. ``--device``
defaults to the card (the splat runs there) and fails when there is none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from worldforge_tpu_torch.io.frames import (export_video, load_image,
                                         save_warp_outputs)
from worldforge_tpu_torch.warp.vggt_warp import warp_single_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VGGT single-image 3D warp")
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--output_path", type=str, default="output_warp")
    p.add_argument("--camera", type=int, default=0,
                   help="index of the conditioning camera/image")
    p.add_argument("--direction", type=str, default="right",
                   choices=["up", "down", "left", "right", "forward",
                            "backward", "up_pan", "down_pan", "left_pan",
                            "right_pan"])
    p.add_argument("--degree", type=float, default=15.0)
    p.add_argument("--frame_single", type=int, default=24)
    p.add_argument("--look_at_depth", type=float, default=1.0)
    p.add_argument("--conf_single", type=float, default=1.0)
    p.add_argument("--crack_depth_threshold", type=float, default=0.1)
    p.add_argument("--crack_max_size", type=int, default=6)
    p.add_argument("--crack_min_neighbors", type=int, default=2)
    p.add_argument("--depth_segments", type=int, default=8)
    p.add_argument("--outlier_min_neighbors", type=int, default=10)
    p.add_argument("--outlier_neighbor_radius", type=int, default=3)
    p.add_argument("--disable_depth_aware_fill", action="store_true")
    p.add_argument("--vggt_checkpoint", type=str, default=None,
                   help="path to converted VGGT weights (npz/safetensors)")
    p.add_argument("--depth_npz", type=str, default=None,
                   help="precomputed npz with depth/extrinsic/intrinsic "
                        "(skips the VGGT model)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    path = args.image_path
    if os.path.isdir(path):
        # directory + --camera index (reference run_warp.py feeds the scene
        # dir to VGGT and warps the camera-indexed view)
        names = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        path = os.path.join(path, names[args.camera])
    image = load_image(path).astype(np.float32) / 255.0
    H, W, _ = image.shape

    if args.depth_npz is not None:
        data = np.load(args.depth_npz)
        depth = data["depth"]
        extrinsic = data.get("extrinsic", np.eye(4))
        intrinsic = data.get("intrinsic")
        conf = data.get("conf")
        if intrinsic is None:
            f = 0.7 * max(H, W)
            intrinsic = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    else:
        from worldforge_tpu_torch.models.vggt.inference import vggt_estimate
        depth, conf, extrinsic, intrinsic = vggt_estimate(
            args.image_path, checkpoint=args.vggt_checkpoint,
            device=args.device)

    crack_params = {
        "depth_threshold": args.crack_depth_threshold,
        "max_crack_size": args.crack_max_size,
        "min_valid_neighbors": args.crack_min_neighbors,
        "min_neighbors": args.outlier_min_neighbors,
        "neighbor_radius": args.outlier_neighbor_radius,
    }
    images, masks, infos = warp_single_image(
        np.asarray(extrinsic), np.asarray(intrinsic), image,
        np.asarray(depth), conf, direction=args.direction,
        degree=args.degree, conf_threshold=args.conf_single,
        frame_num=args.frame_single, look_at_depth=args.look_at_depth,
        crack_params=crack_params, depth_segments=args.depth_segments,
        disable_depth_aware_fill=args.disable_depth_aware_fill,
        device=args.device)

    out = os.path.join(args.output_path, "warped_images")
    save_warp_outputs(out, images, masks, image_prefix="warp_")
    export_video(images, os.path.join(args.output_path, "warp_preview.mp4"),
                 fps=8)
    with open(os.path.join(args.output_path, "camera_info.txt"), "w") as f:
        for info in infos:
            f.write(f"{info['camera_name']}: direction={info['direction']} "
                    f"angle={info['angle']:.2f}\n")
    print(f"Warp complete: {len(images)} frames -> {out}")


if __name__ == "__main__":
    main()
