"""Avatar (audio-driven talking-head) generation CLI (PyTorch port).

The flag surface of ``worldforge_tpu/cli/run_avatar.py``, plus
``--device``: reference image + waveform -> wav2vec2 features -> per-frame
windows -> ``AvatarPipeline.generate_i2v_audio`` -> mp4::

    python -m worldforge_tpu_torch.cli.run_avatar --image face.png \\
        --audio speech.wav --random-init --output out.mp4

Audio: a mono 16 kHz ``.npy`` waveform, or a PCM ``.wav`` (8, 16, 24 or 32
bit; downmixed and linearly resampled to 16 kHz). ``--device`` defaults to
the card and fails when there is none; pass ``--device cpu`` to run the
plain PyTorch path on the CPU. ``--checkpoint_dir`` loads the converted
checkpoints there (``dit/``, ``vae/``, ``wav2vec2/``, ``text_encoder/``,
``tokenizer/``); ``--random-init`` runs random weights at a reduced size.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LongCat avatar i2v-audio (PyTorch/CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="converted avatar DiT + VAE + wav2vec2 dir")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--audio", type=str, required=True,
                   help=".npy mono waveform @ 16 kHz, or a PCM .wav")
    p.add_argument("--prompt", type=str, default="a person talking")
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--num-frames", type=int, default=93)
    p.add_argument("--num-inference-steps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=4.0)
    p.add_argument("--use_distill", action="store_true")
    p.add_argument("--resize", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--output", type=str, default="output_avatar.mp4")
    p.add_argument("--random-init", action="store_true",
                   help="small random-weight run (no checkpoints)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (fails without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p


def _load_waveform(path: str, target_sr: int = 16000) -> np.ndarray:
    """A mono float32 waveform [1, T] at 16 kHz from a .wav (8/16/24/32-bit
    PCM, downmixed, linearly resampled) or a .npy (taken as 16 kHz)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(1, -1)
    import wave
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        ch = f.getnchannels()
        raw = f.readframes(n)
    if width == 3:  # 24-bit PCM: widen each 3-byte sample to int32
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = ((x << 8) >> 8).astype(np.float32) / float(2 ** 23 - 1)
    elif width in (1, 2, 4):
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            x = (x - 128.0) / 128.0
        else:
            x = x / float(np.iinfo(dtype).max)
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        t_new = np.linspace(0.0, 1.0, int(round(len(x) * target_sr / sr)),
                            endpoint=False)
        t_old = np.linspace(0.0, 1.0, len(x), endpoint=False)
        x = np.interp(t_new, t_old, x).astype(np.float32)
    return x.reshape(1, -1)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from worldforge_tpu_torch.io.checkpoints import load_avatar_pipeline
    from worldforge_tpu_torch.io.frames import export_video, load_image
    from worldforge_tpu_torch.utils.prompts import get_negative_prompt

    pipe, encode_text, encode_audio = load_avatar_pipeline(
        args.checkpoint_dir, random_init=args.random_init,
        use_distill=args.use_distill, device=args.device)

    img = load_image(args.image).astype(np.float32) / 255.0  # [H,W,3] [0,1]
    if args.resize is not None:
        import cv2
        img = cv2.resize(img, (args.resize[1], args.resize[0]),
                         interpolation=cv2.INTER_AREA)
    h, w = img.shape[:2]
    image = img.transpose(2, 0, 1)[None] * 2.0 - 1.0

    audio_windows = encode_audio(_load_waveform(args.audio), args.num_frames)

    pe, pm = encode_text(args.prompt)
    neg = args.negative_prompt or get_negative_prompt(static=False)
    ne, nm = encode_text(neg)

    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    video = pipe.generate_i2v_audio(
        gen, image, audio_windows, pe, pm, ne, nm,
        height=h, width=w, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        use_distill=args.use_distill)
    frames = video[0].transpose(1, 2, 3, 0)                # [T, H, W, 3]
    export_video(list(frames), args.output, fps=args.fps)
    print(f"wrote {args.output}: {frames.shape}")


if __name__ == "__main__":
    main()
