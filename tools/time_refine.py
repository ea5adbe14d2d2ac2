"""Time the LongCat 480p -> 720p refine of one checkout, phase by phase.

The refine of ``chip_smoke.py``'s refine phase (LongCat-13.6B at full width
and depth, random weights from a seed, the streaming Wan2.1 VAE, BSA at
0.875, ``REFINE_STEPS`` steps, 49 x 480 x 832 -> 49 x 704 x 1280), run
``--runs`` times in one process after the kernels are built: the VAE encode
(``prepare_refine_latents``), each denoise step, the decode and the total,
in seconds on the host's clock after a device synchronisation (the decode's
includes the host's copy of the video), with kernel 1's fp32 d 384 launches,
the caching allocator's device allocations, frees and retries in the encode
and the decode, and the peak memory of each run. With ``--profile`` the last
run also runs under ``torch.profiler``: its device time by the checkout's
kernel groups (``chip_smoke.KERNEL_GROUPS``), which does not move with the
host.

It times the checkout in the current directory (its package and its
``chip_smoke.py``), so one copy of this script compares two checkouts in
turns on one card:

    for c in parent change change parent; do
        (cd $c && python /path/to/tools/time_refine.py --label $c --profile)
    done

Each run prints one JSON object a line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_refine: no CUDA device")
    import chip_smoke as cs
    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
    from worldforge_tpu_torch.ops import _build
    from worldforge_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.time()
    _build.build(_build.CUDA_SOURCES + _build.HOST_SOURCES)
    build_s = time.time() - t0
    pipe, encode_text = load_longcat_pipeline(
        random_init=True, device="cuda",
        dit_cfg=LongCatDiTConfig.longcat_13b(),
        vae_cfg=WanVAEConfig.wan_2_1())
    pipe = dataclasses.replace(pipe, streaming_vae=True)
    stage1 = cs._stage1_video(cs.REFINE_FRAMES, cs.STAGE1_H, cs.STAGE1_W)
    pe, pmask = encode_text(cs.REFINE_PROMPT)
    prepare = pipe.prepare_refine_latents
    counts = ("num_device_alloc", "num_device_free", "num_alloc_retries",
              "num_sync_all_streams")

    def alloc_stats():
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in counts}

    def delta(a, b):
        return {k: b[k] - a[k] for k in counts}

    for run in range(args.runs):
        marks, encode, stats = [], {}, {}

        def on_step(i, lat):
            torch.cuda.synchronize()
            marks.append(time.time())
            stats["last_step"] = alloc_stats()

        def timed_prepare(*a, **kw):
            t1 = time.time()
            before = alloc_stats()
            lat = prepare(*a, **kw)
            torch.cuda.synchronize()
            encode["s"] = time.time() - t1
            encode["allocator"] = delta(before, alloc_stats())
            return lat

        pipe.prepare_refine_latents = timed_prepare
        flash_attention.launches_by_instantiation = {}
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(42)
        prof = None
        if args.profile and run == args.runs - 1:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.time()
        out = pipe.generate_refine(
            gen, stage1, pe, pmask, height=cs.REFINE_H, width=cs.REFINE_W,
            num_inference_steps=cs.REFINE_STEPS, t_thresh=0.5,
            spatial_refine_only=True, use_bsa=True,
            bsa_sparsity=cs.BSA_SPARSITY, callback=on_step)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        extra = {}
        if prof is not None:
            prof.__exit__(None, None, None)
            groups = {}
            for e in prof.key_averages():
                ms = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0)) / 1e3
                if ms > 0:
                    g = cs._kernel_group(e.key)
                    groups[g] = groups.get(g, 0.0) + ms / 1e3
            extra = {"device_s_by_group": groups,
                     "device_busy_s": sum(groups.values())}
        step_s = [b - a for a, b in zip([t0 + encode["s"]] + marks[:-1],
                                        marks)]
        print(json.dumps({
            "label": args.label, "run": run, "build_s": build_s,
            "encode_s": encode["s"], "step_s": step_s,
            "decode_s": total_s - (marks[-1] - t0), "total_s": total_s,
            "encode_allocator": encode["allocator"],
            "decode_allocator": delta(stats["last_step"], alloc_stats()),
            **extra,
            "fp32_d384_calls": flash_attention.launches_by_instantiation.get(
                "fp32 d384", 0),
            "out_shape": list(out.shape),
            "max_memory_allocated_gb":
            torch.cuda.max_memory_allocated() / 2 ** 30,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
