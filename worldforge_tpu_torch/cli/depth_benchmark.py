"""Depth benchmark: DepthCrafter over a list of sequences, then the
depth metrics.

Counterpart of ``worldforge_tpu/cli/depth_benchmark.py``. Behavioural
reference: DepthCrafter's ``benchmark/`` (``infer_batch.py`` over a CSV of
sequences, ``eval.py``'s AbsRel / delta1 / RMSE after a per-sequence
least-squares alignment in disparity space). One process, one loop over
the CSV: each sequence goes through ``models/depthcrafter/inference.py::
estimate_depth`` on ``--device`` (the card unless ``--device cpu``), or its
prediction is read from ``--pred-dir``.

CSV: one sequence directory a line, each with a ``frames/`` image
directory and ``depth.npy`` (or ``depth.npz['depth']``) ground truth.

    python -m worldforge_tpu_torch.cli.depth_benchmark --csv seqs.csv \\
        --checkpoint_dir DepthCrafter/ --output depth_eval.json
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DepthCrafter benchmark")
    p.add_argument("--csv", type=str, required=True,
                   help="list of sequence dirs (one per line)")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--output", type=str, default="depth_eval.json")
    p.add_argument("--num-inference-steps", type=int, default=5)
    p.add_argument("--max_res", type=int, default=1024)
    p.add_argument("--max-sequences", type=int, default=None)
    p.add_argument("--pred-dir", type=str, default=None,
                   help="evaluate precomputed predictions (skip inference)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the depth model; default the CUDA "
                        "card (fails without one)")
    return p


def _load_gt(seq_dir: str) -> np.ndarray:
    for name in ("depth.npy", "depth.npz"):
        path = os.path.join(seq_dir, name)
        if os.path.exists(path):
            d = np.load(path)
            return d["depth"] if hasattr(d, "files") else d
    raise FileNotFoundError(f"no depth ground truth in {seq_dir}")


def main(argv=None) -> None:
    from worldforge_tpu_torch.utils.depth_metrics import depth_metrics

    args = build_parser().parse_args(argv)
    with open(args.csv) as f:
        seqs = [row[0] for row in csv.reader(f) if row]
    if args.max_sequences:
        seqs = seqs[:args.max_sequences]

    per_seq = {}
    for seq in seqs:
        gt = _load_gt(seq)
        if args.pred_dir is not None:
            pred = np.load(os.path.join(
                args.pred_dir, os.path.basename(seq) + ".npy"))
        else:
            from worldforge_tpu_torch.io.frames import load_frames
            from worldforge_tpu_torch.models.depthcrafter.inference import \
                estimate_depth
            frames = load_frames(os.path.join(seq, "frames"))
            pred = estimate_depth(
                frames, num_inference_steps=args.num_inference_steps,
                max_res=args.max_res, checkpoint=args.checkpoint_dir,
                device=args.device)
        if pred.shape != gt.shape:
            from PIL import Image
            pred = np.stack([np.asarray(Image.fromarray(p).resize(
                (gt.shape[2], gt.shape[1]), Image.BILINEAR))
                for p in pred.astype(np.float32)])
        per_seq[seq] = depth_metrics(pred, gt, align=True)
        print(f"{seq}: AbsRel={per_seq[seq]['abs_rel']:.4f} "
              f"d1={per_seq[seq]['delta1']:.4f}")

    keys = next(iter(per_seq.values())).keys() if per_seq else []
    summary = {k: float(np.mean([m[k] for m in per_seq.values()]))
               for k in keys}
    with open(args.output, "w") as f:
        json.dump({"summary": summary, "per_sequence": per_seq}, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
