"""Standalone 480p -> 720p upscale CLI (the LongCat refine), PyTorch port.

The flag surface of ``worldforge_tpu/cli/run_upscale.py``, plus
``--device``. Reads a stage-1 video file or frame directory, runs
``LongCatPipeline.generate_refine`` and exports an mp4::

    python -m worldforge_tpu_torch.cli.run_upscale --input frames_dir \\
        --random-init --spatial-refine-only --output out_720p.mp4

``--device`` defaults to the card and fails when there is none; pass
``--device cpu`` to run the plain PyTorch path on the CPU.
``--checkpoint_dir`` loads the converted LongCat checkpoints there
(``io/convert_longcat.py``); ``--random-init`` runs random weights at a
reduced size. ``--context_parallel_size`` > 1 raises: the CLI runs one
process, and the JAX CLI parses the flag and reads it nowhere (a pipeline
with a ``mesh`` runs under torchrun).
"""

from __future__ import annotations

import argparse

import torch

from worldforge_tpu_torch.io.frames import export_video, load_frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LongCat 480p->720p upscale (PyTorch/CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--input", type=str, required=True,
                   help="stage-1 video file or frame directory")
    p.add_argument("--output", type=str, default="output_720p.mp4")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--t-thresh", type=float, default=0.6)
    p.add_argument("--spatial-refine-only", action="store_true")
    p.add_argument("--no-bsa", action="store_true")
    p.add_argument("--bsa-sparsity", type=float, default=0.875)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--context_parallel_size", type=int, default=1)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--target-height", type=int, default=720)
    p.add_argument("--target-width", type=int, default=1280)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.context_parallel_size > 1:
        raise NotImplementedError(
            "--context_parallel_size > 1: this CLI runs one process (the "
            "JAX CLI parses the flag and reads it nowhere); the parallel "
            "layer runs a pipeline with a mesh under torchrun (README)")
    frames = load_frames(args.input)  # [T, H, W, 3] in [0,1]

    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    pipe, encode_text = load_longcat_pipeline(
        args.checkpoint_dir, random_init=args.random_init, device=args.device)
    pe, pmask = encode_text(args.prompt)

    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    out = pipe.generate_refine(
        gen, frames, pe, pmask, height=args.target_height,
        width=args.target_width,
        num_inference_steps=args.num_inference_steps,
        t_thresh=args.t_thresh,
        spatial_refine_only=args.spatial_refine_only,
        use_bsa=not args.no_bsa, bsa_sparsity=args.bsa_sparsity)

    frames_out = [out[0].transpose(1, 2, 3, 0)[i]
                  for i in range(out.shape[2])]
    export_video(frames_out, args.output, fps=args.fps)
    print(f"Upscaled video saved to: {args.output}")


if __name__ == "__main__":
    main()
