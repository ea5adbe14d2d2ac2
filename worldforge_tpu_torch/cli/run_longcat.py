"""LongCat-Video guided repaint CLI (PyTorch port).

The flag surface of ``worldforge_tpu/cli/run_longcat.py``, plus
``--device``. Reads a warp-output directory (``mask_`` prefix contract),
softens the masks, runs ``LongCatPipeline.generate_i2v`` with IRR / FLF /
DSG guidance (``--guided``; FLF with ``--use-pca-channel-selection``), and
exports an mp4 (and optional PNGs)::

    python -m worldforge_tpu_torch.cli.run_longcat --video-ref warp_dir \\
        --random-init --guided --use_distill --output out.mp4

``--device`` defaults to the card and fails when there is none; pass
``--device cpu`` to run the plain PyTorch path on the CPU.
``--checkpoint_dir`` loads the converted checkpoints there (``dit/``,
``vae/``, ``text_encoder/``, ``tokenizer/``; ``io/convert_longcat.py``), and
with ``--use_distill`` merges the distill LoRA
``lora/cfg_step_lora.safetensors``; ``--random-init`` runs random weights at
a reduced size. ``--use_distill`` also selects the 16-step distill schedule
without CFG. ``--enable-upscale`` chains the
result into ``generate_refine`` at twice the size. ``--context_parallel_size``
> 1 needs the parallel layer, a later slice of the port, and raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from worldforge_tpu_torch.cli.infer_worldforge import _resize_frames
from worldforge_tpu_torch.io.frames import (export_video, load_image,
                                            read_frames_from_directory,
                                            resize_to_mod)
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
from worldforge_tpu_torch.utils.prompts import (get_negative_prompt,
                                                get_prompt)
from worldforge_tpu_torch.warp.masks import soften_mask


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LongCat-Video WorldForge (PyTorch/CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--context_parallel_size", type=int, default=1)
    p.add_argument("--use_distill", action="store_true")
    p.add_argument("--video-ref", type=str, required=True)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--scene", type=str, default=None)
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--resolution", type=str, default="480p",
                   choices=["480p", "720p"])
    p.add_argument("--num-frames", type=int, default=93)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--guided", action="store_true")
    p.add_argument("--resample-steps", type=int, default=3)
    p.add_argument("--guide-steps", type=int, default=20)
    p.add_argument("--resample-round", type=int, default=20)
    p.add_argument("--omega", type=float, default=1.8)
    p.add_argument("--omega_resample", type=float, default=1.0)
    p.add_argument("--soften-mask", action="store_true")
    p.add_argument("--transition-distance", type=int, default=15)
    p.add_argument("--decay-type", type=str, default="sine",
                   choices=["linear", "exponential", "sine", "cosine"])
    p.add_argument("--use-pca-channel-selection", action="store_true")
    p.add_argument("--static", type=str, choices=["True", "False"],
                   default="False")
    p.add_argument("--max-replace", type=int, default=None)
    p.add_argument("--output", type=str, default="output_i2v.mp4")
    p.add_argument("--save-png", action="store_true")
    p.add_argument("--enable-upscale", action="store_true")
    p.add_argument("--t-thresh", type=float, default=0.6)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--resize", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> None:
    from PIL import Image

    args = build_parser().parse_args(argv)
    if args.context_parallel_size > 1:
        raise NotImplementedError(
            "--context_parallel_size > 1 needs the parallel layer, a later "
            "slice of the port")
    static = args.static == "True"

    frames, masks, _ = read_frames_from_directory(args.video_ref)
    if not frames:
        raise SystemExit(f"no frames found in {args.video_ref}")
    video = np.stack(frames[:args.num_frames]).astype(np.float32) / 255.0
    if args.resize is not None:
        video = _resize_frames(video, *args.resize, Image.LANCZOS)
    video = resize_to_mod(video, 16)
    T, H, W, _ = video.shape

    if masks:
        mask = np.stack(masks[:args.num_frames]).astype(np.float32)
    else:
        mask = np.zeros((T, H, W), np.float32)
    if args.soften_mask:
        mask = soften_mask(mask, args.transition_distance, args.decay_type)
    if mask.shape[1:] != (H, W):
        mask = _resize_frames(mask, H, W, Image.NEAREST)

    image = (load_image(args.image, size=(H, W)).astype(np.float32) / 255.0
             if args.image else video[0])

    prompt = args.prompt or get_prompt(args.scene or "null")
    negative = args.negative_prompt or get_negative_prompt(static)

    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    pipe, encode_text = load_longcat_pipeline(
        args.checkpoint_dir, random_init=args.random_init,
        device=args.device, use_distill=args.use_distill)

    pe, pmask = encode_text(prompt)
    ne, nmask = encode_text(negative)

    guidance = GuidanceConfig(
        guided=args.guided, guide_steps=args.guide_steps,
        resample_steps=args.resample_steps,
        resample_round=args.resample_round, omega=args.omega,
        omega_resample=args.omega_resample,
        use_flf=args.use_pca_channel_selection, flf_backend="longcat",
        distill=args.use_distill, max_replace=args.max_replace)

    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    out = pipe.generate_i2v(
        gen, image.transpose(2, 0, 1)[None] * 2.0 - 1.0,
        pe, pmask, ne, nmask,
        height=H, width=W, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        use_distill=args.use_distill,
        video_ref=video.transpose(3, 0, 1, 2)[None],
        mask=mask[None, None], guidance=guidance)

    frames_out = [out[0].transpose(1, 2, 3, 0)[i] for i in range(out.shape[2])]

    if args.enable_upscale:
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed + 1)
        up = pipe.generate_refine(
            gen, np.stack(frames_out), pe, pmask,
            height=H * 2, width=W * 2,
            num_inference_steps=args.num_inference_steps,
            t_thresh=args.t_thresh, spatial_refine_only=True)
        frames_out = [up[0].transpose(1, 2, 3, 0)[i]
                      for i in range(up.shape[2])]

    export_video(frames_out, args.output, fps=args.fps)
    print(f"Video saved to: {args.output}")

    if args.save_png:
        png_dir = os.path.splitext(args.output)[0] + "_frames"
        os.makedirs(png_dir, exist_ok=True)
        for i, fr in enumerate(frames_out):
            Image.fromarray((np.clip(fr, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(png_dir, f"frame_{i:04d}.png"))
        print(f"PNG frames saved to: {png_dir}/")


if __name__ == "__main__":
    main()
