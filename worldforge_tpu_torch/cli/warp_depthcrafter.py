"""Video 4D warp CLI (the DepthCrafter stage), PyTorch port.

The flag surface of ``worldforge_tpu/cli/warp_depthcrafter.py``, plus
``--device``. Two stages: (1) depth estimation -> ``depth.npz`` in the
output directory (skipped when that cache or ``--depth_npz`` exists; the
depth model loads the DepthCrafter checkpoint directory
``--checkpoint_dir``, ``io/convert_depthcrafter.py``); (2) per-frame point
clouds splatted along the trajectory::

    python -m worldforge_tpu_torch.cli.warp_depthcrafter \
        --video_path frames_dir --depth_npz depth.npz --output_path out \
        --device cpu

Outputs: ``imgs/rendered_image_%02d.png`` + ``mask_%02d.png``,
``video.mp4`` and ``mask.mp4``. Frames are resized to the depth's size.
``--device`` defaults to the card (the splat runs there) and fails when
there is none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from worldforge_tpu_torch.io.frames import (export_video, load_frames,
                                            save_warp_outputs)
from worldforge_tpu_torch.warp.dc_warp import warp_video


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DepthCrafter video 4D warp")
    p.add_argument("--video_path", type=str, default=None,
                   help="input video file or directory of frames")
    p.add_argument("--output_path", type=str, default="output_warp_dc")
    p.add_argument("--direction", type=str, default="left",
                   choices=["up", "down", "left", "right"])
    p.add_argument("--degree", type=float, default=15.0)
    p.add_argument("--look_at_depth", type=float, default=1.0)
    p.add_argument("--stable", action="store_true",
                   help="finish motion in the first N frames, then hold")
    p.add_argument("--stable_frame", type=int, default=17)
    p.add_argument("--zoom", type=str, default="none",
                   choices=["none", "zoom_in", "zoom_out"])
    p.add_argument("--rate", type=float, default=0.8)
    p.add_argument("--circle_radius", type=float, default=None)
    p.add_argument("--enable_edge_filter", action="store_true")
    p.add_argument("--edge_threshold", type=float, default=0.1)
    p.add_argument("--edge_dilation", type=int, default=3)
    p.add_argument("--depth_jump_threshold", type=float, default=0.3)
    p.add_argument("--neighbor_check_radius", type=int, default=2)
    p.add_argument("--max_res", type=int, default=1024)
    p.add_argument("--num_inference_steps", type=int, default=5)
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--depth_npz", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="converted DepthCrafter weights for stage 1")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    os.makedirs(os.path.join(args.output_path, "imgs"), exist_ok=True)

    depth_cache = args.depth_npz or os.path.join(args.output_path, "depth.npz")
    if os.path.exists(depth_cache):
        print(f"Loading cached depth: {depth_cache}")
        data = np.load(depth_cache)
        depth = data["depth"]
        frames = data["frames"] if "frames" in data else load_frames(
            args.video_path)
    else:
        frames = load_frames(args.video_path)
        from worldforge_tpu_torch.models.depthcrafter.inference import \
            estimate_depth
        depth = estimate_depth(frames,
                               num_inference_steps=args.num_inference_steps,
                               guidance_scale=args.guidance_scale,
                               max_res=args.max_res,
                               checkpoint=args.checkpoint_dir,
                               device=args.device)
        np.savez(depth_cache, depth=depth)
        print(f"Depth cached -> {depth_cache}")

    if frames.shape[1:3] != depth.shape[1:3]:
        from PIL import Image
        h, w = depth.shape[1], depth.shape[2]
        frames = np.stack([np.asarray(Image.fromarray(
            (f * 255).astype(np.uint8)).resize((w, h))) for f in frames]
        ).astype(np.float32) / 255.0

    rendered, masks = warp_video(
        frames, depth, direction=args.direction, degree=args.degree,
        look_at_depth=args.look_at_depth, stable=args.stable,
        stable_frame=args.stable_frame, zoom=args.zoom, rate=args.rate,
        circle_radius=args.circle_radius,
        enable_edge_filter=args.enable_edge_filter,
        edge_threshold=args.edge_threshold, edge_dilation=args.edge_dilation,
        depth_jump_threshold=args.depth_jump_threshold,
        neighbor_check_radius=args.neighbor_check_radius,
        device=args.device)

    save_warp_outputs(os.path.join(args.output_path, "imgs"), rendered, masks)
    export_video(rendered, os.path.join(args.output_path, "video.mp4"), fps=6)
    export_video([m.astype(np.float32) for m in masks],
                 os.path.join(args.output_path, "mask.mp4"), fps=6)
    print(f"Warping completed! Results saved to: {args.output_path}")


if __name__ == "__main__":
    main()
