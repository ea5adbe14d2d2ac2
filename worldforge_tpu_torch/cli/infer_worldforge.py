"""Wan2.1 guided repaint CLI (PyTorch port).

The flag surface of ``worldforge_tpu/cli/infer_worldforge.py``, plus
``--device``. Reads a warp-output directory (``mask_`` prefix contract),
softens masks, runs the CFG/IRR/DSG-guided WanI2V pipeline and exports an
mp4 (and optional PNGs)::

    python -m worldforge_tpu_torch.cli.infer_worldforge \\
        --video-ref warp_dir --random-init --guided --output out.mp4

``--device`` defaults to the card and fails when there is none; pass
``--device cpu`` to run the plain PyTorch path on the CPU. ``--models-dir``
loads the converted checkpoints there (``transformer/``, ``vae/``,
``text_encoder/``, ``tokenizer/``, ``image_encoder/``;
``io/convert_wan.py``); ``--random-init`` runs the full pipeline with random
weights at a reduced size. ``--use-pca-channel-selection`` turns on
FLF channel selection; ``--streaming-vae`` runs the streaming VAE;
``--fused`` runs the whole-loop runner (FLF selected on the device; on the
card every step a replay of a captured CUDA graph).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from worldforge_tpu_torch.io.frames import (export_video, load_image,
                                            read_frames_from_directory,
                                            resize_to_mod)
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
from worldforge_tpu_torch.utils.prompts import (get_negative_prompt,
                                                get_prompt)
from worldforge_tpu_torch.warp.masks import soften_mask


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Wan2.1 guided repaint (WorldForge, PyTorch/CUDA)")
    p.add_argument("--model", type=str, choices=["480p", "720p"],
                   default="720p")
    p.add_argument("--models-dir", type=str, default=None)
    p.add_argument("--output", type=str, default="output.mp4")
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--video-ref", type=str, required=True)
    p.add_argument("--guided", action="store_true")
    p.add_argument("--resample-steps", type=int, default=3)
    p.add_argument("--guide-steps", type=int, default=20)
    p.add_argument("--omega", type=float, default=1.8)
    p.add_argument("--omega_resample", type=float, default=1.0)
    p.add_argument("--num-frames", type=int, default=25)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=5.0)
    p.add_argument("--resample-round", type=int, default=20)
    p.add_argument("--static", type=str, choices=["True", "False"],
                   default="False")
    p.add_argument("--scene", type=str, default="horn")
    p.add_argument("--use-pca-channel-selection", action="store_true")
    p.add_argument("--soften-mask", action="store_true")
    p.add_argument("--transition-distance", type=int, default=15)
    p.add_argument("--decay-type", type=str,
                   choices=["linear", "exponential", "sine", "cosine"],
                   default="sine")
    p.add_argument("--save-png", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--random-init", action="store_true",
                   help="debug: random-weight reduced-size pipeline")
    p.add_argument("--resize", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="downscale inputs to HxW before the pipeline "
                        "(smoke tests; the reference runs native 480p/720p)")
    p.add_argument("--fused", action="store_true",
                   help="the whole-loop runner: FLF on the device, CUDA "
                        "graph replays on the card")
    p.add_argument("--streaming-vae", action="store_true",
                   help="streaming VAE (bounded memory at 480p+)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def _resize_frames(frames: np.ndarray, h: int, w: int, resample) -> np.ndarray:
    from PIL import Image
    return np.stack([np.asarray(Image.fromarray(
        (f * 255).astype(np.uint8)).resize((w, h), resample))
        for f in frames]).astype(np.float32) / 255.0


def main(argv=None) -> None:
    from PIL import Image

    args = build_parser().parse_args(argv)
    static = args.static == "True"

    frames, masks, _ = read_frames_from_directory(args.video_ref)
    if not frames:
        raise SystemExit(f"no frames found in {args.video_ref}")
    video = np.stack(frames[:args.num_frames]).astype(np.float32) / 255.0
    if args.resize is not None:
        h, w = args.resize
    else:
        # target dims from max_area at the input aspect ratio, floored to
        # mod 16 = vae_stride(8) * patch(2)
        max_area = 720 * 1280 if args.model == "720p" else 480 * 832
        ih, iw = video.shape[1:3]
        aspect = ih / iw
        h = int(round(np.sqrt(max_area * aspect))) // 16 * 16
        w = int(round(np.sqrt(max_area / aspect))) // 16 * 16
    if (h, w) != video.shape[1:3]:
        video = _resize_frames(video, h, w, Image.LANCZOS)
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

    prompt = get_prompt(args.scene)
    negative = get_negative_prompt(static)

    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    pipe, encode_text, encode_image = load_wan_pipeline(
        args.models_dir, variant=args.model, random_init=args.random_init,
        device=args.device)
    pipe.streaming_vae = args.streaming_vae

    guidance = GuidanceConfig(
        guided=args.guided, guide_steps=args.guide_steps,
        resample_steps=args.resample_steps,
        resample_round=args.resample_round, omega=args.omega,
        omega_resample=args.omega_resample,
        use_flf=args.use_pca_channel_selection, flf_backend="wan")

    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    out = pipe.generate(
        gen, image.transpose(2, 0, 1)[None] * 2.0 - 1.0,
        encode_text(prompt), encode_text(negative), encode_image(image),
        height=H, width=W, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        video_ref=video.transpose(3, 0, 1, 2)[None],
        mask=mask[None, None], guidance=guidance, fused=args.fused)

    frames_out = [out[0].transpose(1, 2, 3, 0)[i] for i in range(out.shape[2])]
    export_video(frames_out, args.output, fps=16)
    print(f"Video generation completed! Output saved to: {args.output}")

    if args.save_png:
        png_dir = os.path.splitext(args.output)[0] + "_frames"
        os.makedirs(png_dir, exist_ok=True)
        for i, fr in enumerate(frames_out):
            Image.fromarray((np.clip(fr, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(png_dir, f"frame_{i:04d}.png"))
        print(f"PNG frames saved to: {png_dir}/ ({len(frames_out)} frames)")


if __name__ == "__main__":
    main()
