"""Drive the PyTorch port on one NVIDIA card and check every kernel.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device  -- the card's name and power limit (``nvidia-smi``).
2. build   -- compiles the CUDA C++ kernels from ``worldforge_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together).
3. kernels -- each of the five kernels (and kernel 4's one-tap
   instantiation) against its plain PyTorch version at the main paths'
   shapes (the Wan repaint's, the LongCat refine's, the LongCat guided
   i2v's, the warp's and the encoders') and at small ragged shapes:
   error, kernel time, plain time, the time of one PyTorch library call for
   the same function where there is one (a yardstick only, never used by
   the port), and the card's bound for the same work.
4. flf     -- FLF channel selection (Farneback flows, channel scores, the
   Wan and LongCat schedules) on the card against the CPU at the 480p
   49-frame latent shape [1, 16, 13, 60, 104]: scores within 1e-4 and the
   selected sets equal, with the card's time per call.
5. vae     -- the vae_profile lines: one single-pass Wan2.1 VAE decode +
   encode at the generate shape and one streaming decode at the refine
   shape under ``torch.profiler`` (device time of kernel 4, the other
   convs, the elementwise work, and idle); the vae_conv2d_workspace line:
   the decoder's 384->192 resample conv through the VAE's route (kernel 4
   with one tap) beside the fp32 cuDNN route it replaced.
6. dit     -- one Wan2.1-I2V-14B DiT forward at full width and depth on
   480x832x49 frames (20,280 tokens), then one more under ``torch.profiler``
   (the dit_profile line: device time by kernel group).
7. warp    -- VGGT-1B at full width and depth on a 518x294 image
   (``load_and_preprocess_images`` -> ``vggt_forward`` -> cameras), its
   depth and cameras saved as an npz, and ``cli/run_warp`` writing 17
   frames and masks from it, on the card and on the CPU: the masks must be
   equal. Before it, the tiny VGGT on the card against the CPU.
8. encoders -- UMT5-XXL on 512 token ids and CLIP-H on the warp's first
   frame at 480x832, at full width and depth. Before it, both at their
   tiny configs on the card against the CPU.
9. generate -- the guided repaint (CFG + IRR + VAE fuse + FLF + DSG + final
   decode) through ``load_wan_pipeline`` and ``WanI2VPipeline.generate`` at
   full width with the cuts listed on its line, fed by the warp's frames
   and masks and the encoders' contexts; every kernel of that path must
   launch during this phase. Before it, a reduced random-init generate
   with FLF over 8 guided steps runs on the card and on the CPU from one set
   of weights and one noise stream, and the two must agree.
10. refine  -- the LongCat-Video 480p -> 720p refine (SDEdit upscale) through
   ``load_longcat_pipeline`` and ``LongCatPipeline.generate_refine``: the
   13.6B DiT at full width and depth, the streaming Wan2.1 VAE, a 49-frame
   480x832 stage-1 video refined to 704x1280 (56,320 tokens, block-sparse
   attention at sparsity 0.875), with the step cut listed on its line; the
   kernels of that path must launch during this phase. Before it, the
   reduced random-init refine at 128x256 runs on the card and on the CPU
   from one set of weights and one noise stream, and the two must agree.
11. longcat_guided -- the LongCat guided i2v (IRR + FLF + DSG, the distill
   table, no CFG) through the refine phase's pipeline and
   ``LongCatPipeline.generate_i2v`` at 480x832 x 49 frames (20,280 tokens),
   with the step cut listed on its line; kernels 1, 2 and 4 must launch
   and steps 2 and 3 must hand a channel back. Before it, the reduced
   random-init LongCat runs ``generate_i2v`` (distill, and standard with
   CFG) and ``generate_vc`` on the card and on the CPU, which must agree.
12. depthcrafter -- the DepthCrafter video warp stage (after the warp phase
   in the order of a run): a widened tiny SVD UNet + VAE (and a tiny CLIP)
   on the card against the CPU computing the card's conv arithmetic, from
   one set of weights and one noise stream: the encode, one UNet forward
   and the decode, and ``DepthCrafterPipeline`` (7 frames, window 4,
   overlap 2, 2 steps); ``warp_video`` with the edge filter on both (masks
   equal); then the SVD UNet (1.52B) and VAE at full width, fp32, with
   CLIP-H, on a 40-frame 512x832 video (window 24, overlap 8, 5 steps) ->
   ``normalize_depth`` -> depth npz -> ``cli/warp_depthcrafter``, with the
   cuts listed on its line; one UNet forward at the published 110-frame
   window (the dc_window110 line), one on 8 frames of 1024x1024 (81,920
   rows of temporal attention in one launch: dc_square1024) and one
   24-frame forward under ``torch.profiler`` (dc_profile).
13. wan_facades -- after the generate, reusing the encoders phase's
   UMT5-XXL contexts and CLIP-H (on the warp's first and last frames): the
   Wan2.1 T2V-14B, FLF2V-14B and VACE-14B (layers 0, 5, ..., 35) at full
   width and depth, random bf16 weights with every zero-initialised leaf
   randomised (the head, FLF2V's ``emb_pos``, VACE's ``before_proj`` /
   ``after_proj``), one at a time and each freed before the next, through
   ``WanT2VPipeline.generate`` / ``WanVacePipeline.generate`` at 480x832
   with the cuts on their lines (VACE repaints the warp's holes: its source
   is the warp's frames through ``prepare_source`` and
   ``VaceVideoProcessor.load_video_pair``, its mask 1 - validity), and one
   T2V forward at the published 81 frames (32,760 tokens); kernels 1-4
   must launch on each. Before it, reduced T2V / FLF2V / VACE pipelines on
   the card against the CPU (3 UniPC steps with CFG, one set of weights and
   one noise stream), ``prepare_vace_context`` with reference images, the
   processor's resize and one ``dpm_update`` of each order.
14. avatar -- after the LongCat guided i2v: the LongCat-Video-Avatar (the
   13.6B base with its audio blocks, wav2vec2-base, the Wan2.1 VAE; random
   weights, the DiT's zero leaves randomised) through
   ``load_avatar_pipeline``, its ``encode_audio`` on a synthetic waveform
   and ``generate_i2v_audio`` on the warp's first frame with CFG, with the
   frame and step cuts on its line, the peak by span (wav2vec2, encode, DiT
   forward, decode); kernels 1, 2 and 4 must launch. Before it, a widened
   tiny avatar on the card against the CPU (``generate_i2v_audio`` with CFG
   and with distill, a multitalk forward, the k/v cache against the joint
   forward) and ``run_avatar --random-init`` with ``--device cuda`` against
   ``--device cpu`` on a synthetic 16-bit WAV.

15. checkpoints -- three parts, each one JSON line with "phase":
   "checkpoints". After the generate: the flagship Wan set through files
   (the generate and encoders phases' full-width trees, Wan2.1-I2V-14B
   bf16, the Wan2.1 VAE, UMT5-XXL and CLIP-H, exported by this script's
   torch-only inverse writers to the upstream layout: safetensors shards
   with an index, written one tensor at a time from the card and dropped
   from the page cache, and the VAE as a ``.pth``), after a check of the
   free disk; ``load_wan_pipeline(models_dir)`` reads them back onto the
   card, every leaf must equal its source (rebuilt from its seed) bit for
   bit, and the guided repaint runs on the loaded pipeline (UMT5 contexts
   from the loaded weights on fixed ids, the CLIP context from the
   loader's ``encode_image``); write and load seconds and GB/s, the host
   peak resident set and the device peak. In the depthcrafter phase: the
   SVD UNet and VAE exported and converted back bit for bit, the tiny
   configs' exports equal to the frozen manifests
   ``tests/fixtures/svd_*_manifest.json``. After the LongCat guided i2v: a
   synthetic rank-128 distill LoRA in the upstream naming on every target
   of the 48 blocks, ``convert_longcat_lora`` + ``merge_lora_stacked``
   into the 13.6B DiT on the card (timed), one block held against an fp32
   CPU recompute to 1 bf16 ulp.
16. quant -- right after the generate: ``dense_q8`` / ``dense_q8_pre`` /
   ``dense_q4`` / ``dense_q6`` on the card against the CPU (activation
   codes, int32 sums and requantized weights equal; rows 1 to 300, the Wan
   fc1's K and N), a small W4A8 guided generate with FLF on the card
   against the CPU, the int8 GEMM (``torch._int_mm``) at the Wan fc1 / q /
   text-k shapes beside bf16 ``matmul`` with the unfused quantization,
   rescale and int4 / int6 requantization timed; then the W8A8, FFN-int4
   and int6-FFN + int4 Wan2.1-I2V-14B builds, one at a time, each from the
   generate's seed through the generate's guided repaint (drift from its
   output, FLF sets, peak; kernels 1-4 must launch) and a forward at
   20,280 tokens, the W8A8 build's layer 0 bit for bit against
   ``quantize_tree`` of the bf16 layer and a rank-16 LoRA over it; UMT5-XXL
   int8 on the encoders' ids; one all-int4 LongCat-13.6B forward.

17. train -- right after the quant phase (the kernels phase holds the
   backward kernels of kernels 1-3 against autograd of their plain versions
   at the DiTs' shapes, kernel 1's at small ragged shapes with ``kv_lens``
   and d 64 too, and shows that a gradient through kernel 1 with no
   backward instantiation raises): a widened tiny Wan2.1 i2v takes one
   ``make_lora_train_step`` step on the card and on the CPU, which must
   agree; then the Wan2.1-I2V-14B with rank-16 adapters on every
   LORA_TARGETS leaf of its 40 blocks (3 steps at 20,280 tokens with ``y``
   and CLIP tokens), the Wan2.1-T2V-1.3B fully fine-tuned (fp32 weights,
   bf16 compute, 3 steps at 32,760 tokens) and the LongCat-13.6B with
   rank-16 adapters through ``longcat_forward`` (2 steps at 20,280
   tokens), all at full width and depth with remat and AdamW, each freed
   before the next: losses finite, seconds per step, peaks, adapters moved,
   the base bit-unchanged, and launches per step of kernels 1-3 forward and
   backward (1-2 on LongCat), every one of which must launch.

18. parallel -- the parallel layer (``core/mesh.py``, ``parallel/*``) on
   one card, in three parts (``"phase": "parallel"`` lines). (a) Right
   after the kernels phase, what each of 4 ranks computes between its
   collectives, one rank after another at full width, held against the
   unsharded kernel on the same inputs, with each rank's kernel time: ring
   attention (kernel 1 with return_lse over four 5,070-key shards of the
   Wan-14B [1, 20280, 40, 128], merged by ``ring._merge``), Ulysses (each
   rank's 10 heads over 20,280 tokens), the 2-D split at 2 x 2 of the
   13 x 30 x 52 grid (RoPE rows by h_offset / w_offset, kernel 2 on the
   block: both bit-equal to the global ones), and BSA ring CP on the
   refine's [32, 56320, 128] at sparsity 0.875 (440 chunks, 4 x 110; kernel
   5 with return_lse per visiting shard, ``bsa_cp._merge_flat``), once on
   random inputs and once with inputs that make 22 query chunks of rank 0
   select only rank 2's chunks (count 0 on the other three ranks); kernels
   1, 2 and 5 must launch. (b) The NCCL path at world size 1:
   ``make_mesh(1, 1, 1, device="cuda")`` on a real NCCL group, its
   exchanges (all-to-all, all-gather, the FSDP gather and its
   reduce-scatter) checked, then the Wan-14B forward at 20,280 tokens (in
   the dit phase, beside the token_chunk=4 forward and both peaks) and the
   LongCat-13.6B refine forward at 56,320 tokens with BSA (in the refine
   phase), each bit for bit equal to the mesh-free forward. (c) With two
   or more cards, ``run_dryrun(min(4, cards), "cuda")``; with one, the
   line says ``"multi_card": "not run: 1 card"``.

19. fused -- the whole-loop runners (``runtime/step_graph.py``): every
   step a replay of its segment kind's captured CUDA graph, FLF selected
   on the card. Right after the generate, on its pipeline: first the
   reduced random-init Wan through ``generate(fused=True)`` over 8 guided
   steps, the graph replays bit-equal to the same body run eagerly on the
   card (a numpy noise stream and a registered card generator),
   ``exec_chunk`` 1-3 bit-equal to one program, FLF's card sets equal to
   the host loop's, and the reduced LongCat's ``generate_i2v(fused=True)``
   likewise; then the generate's guided repaint (its cuts, 7 steps, every
   one guided, so FLF hands channels back from step 6) fused beside the
   host loop from one generator seed: s per step, peaks, FLF's sets, the
   latents' error; 3 steps (2 guided, 1 plain) as graphs, eagerly, with
   ``exec_chunk=2`` and as the host loop, the graph and loop runs under
   ``torch.profiler`` for the device's idle share per step. After the
   LongCat guided i2v, the same run through ``generate_i2v(fused=True)``.
   The kernel table's launches count the replays.
20. runtime -- ``runtime/streaming.py``: in the dit phase, the Wan-14B's 40
   blocks moved to pinned host memory and streamed through
   ``StreamingExecutor`` for one forward at 20,280 tokens, bit-equal to the
   resident forward (s, copy rate, peaks); after the fused phase,
   ``decode_in_subprocess`` of its final latents on the card, bit-equal to
   the in-process decode; at the end, ``parallel/dryrun.py``'s phases (the
   fused and chunked Wan generates among them) at world size 1 on NCCL.

21. sfm -- right after the warp phase (``"phase": "sfm"`` lines, each with
   the card's name and power limit): VGGT tracking and SfM on 8 square
   frames of 518x518 (a synthetic scene under a camera pan). VGGT-1B fp32
   with the world-point and track heads (kernel 1's global attention over
   10,992 tokens), its track head on the first 1,024 of ALIKED-N16's
   keypoints on frame 0; ``predict_tracks`` with the VGGSfM tracker
   (published coarse and fine configs) and ALIKED-N16 + SuperPoint at
   4,096 keypoints (the final trial adds SIFT at 2,048), 5 query frames,
   6 coarse refinements, the fine refinement and the non-visible-frame
   loop, fed VGGT's world points and confidence; the COLMAP export
   (``build_reconstruction(masks=vis > 0.2)``, ``write_text``). Seconds of
   each part, peaks, counts and kernel 1's launches. Before it, the small
   runs on the card against the CPU: a widened tiny VGGT with the point
   head and a tiny track head, tiny ALIKED (keypoints as score-sorted
   sets) and the published tracker through ``predict_tracks`` on 3 frames
   of 128x128 with its coordinate heads damped (random full-scale heads
   make tracks chaotic; see ``_damped_tracker``).

22. vae_strips -- right after the vae phase: the streaming Wan2.1 VAE's
   H-strip tiling (``spatial_chunks``) on the full-width VAE (random fp32
   weights from a seed). Before it, a widened tiny VAE's tiled decode and
   encode on the card against the CPU. Then the streaming decode and
   encode at 17x480x832 with 1, 2 and 4 strips (seconds through
   ``utils/profiling.phase``, peaks, kernel 4's launches; the tiled outputs
   against the untiled: bit-equal or within STRIP_GATE of the largest
   magnitude, with more launches), the refine's decode to 61x704x1280 at 1
   and 4 strips (peaks), ``decode_in_subprocess(spatial_chunks=2)`` against
   the in-process decode (bit-equal), and one tiled decode under
   ``utils/profiling.trace``, whose trace must name kernel 4's CUDA kernel.
23. depth_tools -- right after the depthcrafter phase: ``cli/depth_app``
   with ``--random-init --device cuda`` at full width serving one ``POST
   /run`` of a synthetic 8-frame clip over a localhost port, then
   ``cli/visualize_pcd`` on the npz and input video it wrote (PLY frames),
   then ``cli/depth_benchmark --device cuda`` on two synthetic sequences
   through a checkpoint directory the phase writes (and deletes) from a
   widened tiny DepthCrafter; its metrics must equal ``depth_metrics`` of
   ``estimate_depth`` called directly.

The line before the last holds the kernel table; the last line is the device
summary.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import worldforge_tpu_torch  # noqa: E402,F401  (fails outside the checkout)

# H100 SXM data sheet: dense bf16 and TF32 tensor-core rates, fp32 rate
# outside the tensor cores, and device memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Main-path shapes: 480x832 pixels, 49 frames -> 13 x 60 x 104 latents,
# 13 x 30 x 52 = 20,280 DiT tokens; the generate phase runs 17 frames.
DIT_FRAMES, HEIGHT, WIDTH = 49, 480, 832
GEN_FRAMES = 17
GEN_STEPS = 3
GEN_LAYERS = 40          # DiT depth of the generate phase (of 40)

# LongCat refine: a 49 x 480 x 832 stage-1 video refined spatially to
# 704 x 1280; 64 frames after the BSA padding, 61 encoded -> 16 x 88 x 160
# latents -> 16 x 44 x 80 = 56,320 DiT tokens = 440 (4,4,8) chunks.
REFINE_FRAMES, REFINE_H, REFINE_W = 49, 704, 1280
STAGE1_H, STAGE1_W = 480, 832
REFINE_GRID = (16, 44, 80)
REFINE_TOKENS = 16 * 44 * 80
REFINE_STEPS = 4         # num_inference_steps: t_thresh 0.5 keeps 3 steps
LC_HEADS = 32
BSA_SPARSITY = 0.875
REFINE_PROMPT = ("a slow camera pan along a rainy city street at dusk, neon "
                 "signs reflected in puddles, pedestrians with umbrellas "
                 "crossing, cinematic lighting, high detail, 720p")
TEXT_LEN = 512
REFINE_KV_LEN = min(max(len(REFINE_PROMPT) // 4, 1), TEXT_LEN)  # hash mask

# LongCat guided i2v: 480x832 x 49 frames -> 13 x 60 x 104 latents, 20,280
# tokens of which the cond frame's 1,560; the distill table at 4 of its
# 16 steps, every step guided (IRR 2, FLF with max_replace 2).
LC_GUIDED_STEPS = 4
LC_COND_TOKENS = (HEIGHT // 16) * (WIDTH // 16)                   # 1,560
LC_TOKENS = (DIT_FRAMES // 4 + 1) * LC_COND_TOKENS                # 20,280
LC_PROMPT = ("a camera glides through a sunlit forest path, leaves moving "
             "in the wind, dappled light, smooth motion, high detail")
LC_KV_LEN = min(max(len(LC_PROMPT) // 4, 1), TEXT_LEN)            # hash mask
FLF_SHAPE = (1, 16, DIT_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8)

# The warp: a 518 x 294 image (VGGT's preprocessed size: 518 wide, the
# height rounded to 14) -> 21 x 37 patches + 5 special tokens per frame;
# 17 warped frames, the generate phase's count.
WARP_H, WARP_W = 294, 518
VGGT_TOKENS = (WARP_H // 14) * (WARP_W // 14) + 5                 # 782
WARP_DIRECTION, WARP_DEGREE = "right", 15.0
# the sfm phase: 8 square frames of 518 x 518 (37 x 37 patches + 5 special
# tokens a frame; the global attention runs over all 8 frames' tokens)
SFM_FRAMES, SFM_SIZE = 8, 518
SFM_TOKENS = (SFM_SIZE // 14) ** 2 + 5                              # 1,374
SFM_TRACK_QUERIES = 1024
# UMT5: 512 token ids (no tokenizer here), the prompt's 28 and the
# negative prompt's 64 of them unmasked
PROMPT_TOKENS, NEGATIVE_TOKENS = 28, 64

# DepthCrafter: 512 x 832 frames -> 64 x 104 latents (6,656 tokens at the
# UNet's first level, 5 heads of 64); 40 of the published 110-frame window
# and overlap 8 of 25, so two windows run (the re-init and the blend), at
# the CLI's 5 steps; the VAE decodes 8 frames a chunk (its mid attention:
# [8, 6656, 1, 512])
DC_H, DC_W = 512, 832
DC_TOKENS = (DC_H // 8) * (DC_W // 8)                             # 6,656
DC_FRAMES, DC_WINDOW, DC_OVERLAP, DC_STEPS = 40, 24, 8, 5
DC_DECODE_CHUNK = 8
DC_PUBLISHED_WINDOW, DC_PUBLISHED_OVERLAP = 110, 25
DC_HEADS = 5
DC_SQUARE_FRAMES = 8     # frames of the 1024 x 1024 forward
# kernel 1 on more than 65,535 B*H rows (the grid's y limit)
GRID_ROWS = 70000

# The Wan facades: T2V-14B / FLF2V-14B / VACE-14B at 480x832, 17 of the
# published 81 frames (5 x 30 x 52 = 7,800 tokens), 3 of 50 steps, CFG 5.0;
# one T2V forward at the published 81 frames (21 x 30 x 52 = 32,760
# tokens). FLF2V's image context is CLIP-H on the first and the last
# frame: 2 x 257 tokens. VACE-14B's layers are the published
# Wan2.1-VACE-14B config.json's (the JAX default, every second layer, is
# the 1.3B layout).
FACADE_FRAMES, FACADE_STEPS = GEN_FRAMES, 3
FACADE_TOKENS = (FACADE_FRAMES // 4 + 1) * (HEIGHT // 16) * (WIDTH // 16)
T2V_PUBLISHED_FRAMES = 81
FLF2V_IMAGE_TOKENS = 2 * 257
VACE_14B_LAYERS = (0, 5, 10, 15, 20, 25, 30, 35)
# The LongCat avatar: the CLI's default 93 frames -> 24 latent frames of
# 30 x 52 = 37,440 tokens, the reference image's frame as the cond frame,
# so the per-frame audio cross-attention folds 23 noise frames into the
# batch: [23, 1,560 -> 32, 32 heads of 128]; a synthetic 3.72 s waveform
# at 16 kHz. The generate is cut to 49 frames, 2 of 50 steps, CFG 4.0: the
# single-pass decode of 93 frames does not fit beside the resident DiT
# (the phase measures it alone); one DiT forward runs at 93 frames.
AVATAR_CLI_FRAMES, AVATAR_FRAMES, AVATAR_STEPS = 93, 49, 2
AVATAR_NOISE_FRAMES = (AVATAR_CLI_FRAMES - 1) // 4
AVATAR_AUDIO_TOKENS = 32
AVATAR_SECONDS, AUDIO_RATE = 3.72, 16000

_T0 = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's records carry ``script_s``, the seconds
    since the script started, so a run's time can be read phase by
    phase."""
    if "phase" in obj:
        obj = {**obj, "script_s": round(time.time() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(calls: dict, iters: int) -> dict:
    """``cuda_ms`` of each of ``calls`` ({name: fn}) in turns on the same
    inputs, in order and then back (A, B, B, A): {name: [ms, ms]}, so that
    clocks and cache state that drift through a run fall on all alike."""
    ms = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        ms[name].append(cuda_ms(calls[name], iters))
    return ms


def pass_ms(fn) -> dict:
    """Device ms of each pass of kernel 1's two-pass fp32 route in one call
    of ``fn``, by kernel name (``torch.profiler``), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("fa_f32_scores_kernel", "fa_f32_pv_kernel"):
            if name in e.key:
                out[name] = out.get(name, 0.0) + getattr(
                    e, "device_time_total",
                    getattr(e, "cuda_time_total", 0)) / 1e3
    return out


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| in bf16 units in the last place of the larger of
    the two magnitudes. Magnitudes below 2^-10 of the tensor's largest are
    judged at that floor: near a zero crossing the fp32 rounding of the two
    versions (FMA contraction, reduction order) is a few 1e-7 of the
    operands, which is no bf16 ulp of the tiny result."""
    o, r = out.float(), ref.float()
    mag = torch.maximum(o.abs(), r.abs())
    mag = torch.clamp(mag, min=float(r.abs().max()) * 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((o - r).abs() / ulp).max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def timed_calls(module, name, sink, keep=None, peaks=None):
    """Replace ``module.<name>`` for the block with a wrapper that times
    each call on the host clock between two synchronizes and appends
    ``{"s": seconds, **keep(args, out)}`` to ``sink``. With a ``peaks``
    list, the device's peak allocation is read into it and reset before
    each call, and the call's own peak goes into its record as
    ``peak_gb`` (the caller's peak is then the largest of ``peaks``, the
    records' and the reading at its end)."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0}
        if peaks is not None:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if keep is not None:
            rec.update(keep(args, out))
        sink.append(rec)
        return out

    setattr(module, name, wrapped)
    try:
        yield sink
    finally:
        setattr(module, name, orig)


def flf_record(args, out):
    """What ``timed_calls`` keeps of an ``flf_select`` call."""
    return {"step": int(args[2]), "channels": [int(c) for c in out]}


# ------------------------------------------------------------------ phases


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from worldforge_tpu_torch.ops import _build
    t0 = time.time()
    sources = _build.CUDA_SOURCES + _build.HOST_SOURCES
    logs = _build.build(sources)
    for name in sources:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "sources": list(sources),
          "seconds": round(time.time() - t0, 3), "ptxas": ptxas})
    emit({"phase": "build", "part": "fa_f32_wgmma_ptxas",
          "instantiations": _ptxas_functions(logs.get("flash_attention", ""),
                                             "fa_f32_wgmma_kernel")})
    emit({"phase": "build", "part": "fa_f32_wide_ptxas",
          "instantiations": [
              f for needle in ("fa_f32_scores_kernel", "fa_f32_pv_kernel")
              for f in _ptxas_registers(logs.get("flash_attention", ""),
                                        needle)]})
    emit({"phase": "build", "part": "short_and_conv_ptxas",
          "instantiations": [
              f for source, needle in (
                  ("flash_attention", "attn_short_kernel"),
                  ("conv3d", "conv3d_kernel"))
              for f in _ptxas_registers(logs.get(source, ""), needle)]})


def _ptxas_registers(log, needle):
    """``nvcc -Xptxas -v``'s registers and spills of each entry function
    whose mangled name holds ``needle``, with ptxas's C75xx notes on it
    (a serialised ``wgmma`` or an injected wait). Empty when the library
    was built before (no log)."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)", ln)
        if m:
            cur = m.group(1) if needle in m.group(1) else None
            if cur is not None:
                out.setdefault(cur, {"function": cur, "notes": []})
        for name, rec in out.items():
            if "C75" in ln and name in ln:
                rec["notes"].append(ln.strip()[:200])
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores_bytes", r"(\d+) bytes spill stores"),
                         ("spill_loads_bytes", r"(\d+) bytes spill loads")):
            m = re.search(pat, ln)
            if m:
                out[cur][key] = int(m.group(1))
    return list(out.values())


def _ptxas_functions(log, needle):
    """``nvcc -Xptxas -v``'s registers, spills and static shared memory for
    each entry function whose mangled name holds ``needle``, with the
    dynamic shared memory of kernel 1's fp32 plan for its head dim and
    variant (the template arguments, ``ILi64ELi0E``). Empty when the
    library was built before (no log)."""
    import re
    from worldforge_tpu_torch.ops.flash_attention import _fwd_plan
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            cur = None
            if needle in name:
                cur = next((f for f in out if f["function"] == name), None)
                if cur is None:
                    t = re.search(r"ILi(\d+)ELi(\d+)E", name)
                    cur = {"function": name}
                    if t:
                        d, variant = int(t.group(1)), int(t.group(2))
                        cur.update(head_dim=d, variant=variant,
                                   dynamic_smem_bytes=_fwd_plan(
                                       1, 1, 1, 1, d, variant).smem_bytes)
                    out.append(cur)
            continue
        if cur is None:
            continue
        for key, pat in (("spill_stores_bytes", r"(\d+) bytes spill stores"),
                         ("spill_loads_bytes", r"(\d+) bytes spill loads"),
                         ("stack_frame_bytes", r"(\d+) bytes stack frame"),
                         ("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    return out


def _flash_plan(b, sq, sk, h, d, dtype):
    """The plan the wrapper hands kernel 1 for this call, as a record:
    bf16 route, key tiles, resident K / V, buffers, walk and grid; fp32
    variant, rows, key tile and blocks."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _bf16_plan, _fwd_plan, _num_sms)
    if dtype == torch.float32:
        return {"dtype": "fp32", **_fwd_plan(b, sq, sk, h, d)._asdict()}
    plan = _bf16_plan(b, sq, sk, h, d, num_sms=_num_sms(torch.device("cuda")))
    return {"dtype": "bf16", "route": ("short (csrc/attention_short_sm90.cuh)"
                                       if plan.route else
                                       "long (csrc/attention_sm90.cuh)"),
            **plan._asdict(), "key_tiles": list(plan.key_tiles)}


def _check_flash(gen, records, b, sq, sk, h, d, dtype, tol_rel, tol_l2,
                 label, iters, kv_len=None):
    """Kernel 1 against its plain version. The gates scale with the output:
    the largest error over the largest |ref| (a bf16 output is rounded to
    within 2^-8 of itself on both sides) and the relative L2 error (leaving
    out one 64-key tile of 20,280 moves the self-attention output by about
    8 / sqrt(20280) = 6% in L2). ``kv_len``: every batch row's key length
    (``kv_lens``); the bound and the SDPA yardstick count those keys. The
    kernel and SDPA are timed in turns (``in_turns``); ``ms`` and
    ``library_ms`` are the means of their two turns."""
    from worldforge_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    kl = None if kv_len is None else torch.full(
        (b,), kv_len, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = flash_attention(q, k, v, kv_lens=kl)
    torch.cuda.synchronize()
    # what one call holds beyond its inputs: the output and, on the
    # two-pass route (fp32 d 384 / 512), the scratch its plan names
    call_peak = torch.cuda.max_memory_allocated() - base
    ref = flash_attention_plain(q, k, v, kv_lens=kl)
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel = err / max(float(ref.float().abs().max()), 1e-12)
    rel_l2 = float(diff.norm() / ref.float().norm().clamp_min(1e-12))
    ok = (bool(torch.isfinite(out).all()) and rel <= tol_rel
          and rel_l2 <= tol_l2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None if kv_len is None else (
        torch.arange(sk, device="cuda") < kv_len)[None, None, None, :]
    turns = in_turns({
        "kernel": lambda: flash_attention(q, k, v, kv_lens=kl),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)}, iters)
    ms, lib_ms = (sum(turns[n]) / 2 for n in ("kernel", "sdpa"))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, kv_lens=kl), 1)
    keys = sk if kv_len is None else kv_len
    flops = 4.0 * b * h * sq * keys * d
    io_bytes = 2 * nbytes(q) + 2 * nbytes(k) * keys / sk
    extra = {}
    if dtype == torch.bfloat16:
        bms, by = bound(flops, io_bytes, PEAK_BF16_FLOPS)
    else:
        # fp32 runs on the tensor cores as 3 TF32 products (3xTF32); the
        # bound of the same work on the fp32 FMA units stands beside it
        bms, by = bound(3 * flops, io_bytes, PEAK_TF32_FLOPS)
        extra = {"bound_basis": "3 TF32 products at 495 TFLOP/s",
                 "fma_bound_ms": bound(flops, io_bytes, PEAK_FP32_FLOPS)[0]}
    plan = _flash_plan(b, sq, sk, h, d, dtype)
    if plan.get("passes", 1) > 1:
        extra["pass_device_ms"] = pass_ms(
            lambda: flash_attention(q, k, v, kv_lens=kl))
    rec = {"check": label, "shape": [b, sq, sk, h, d], "dtype": str(dtype),
           "kv_len": kv_len, "plan": plan, "call_peak_bytes": call_peak,
           "output_bytes": nbytes(out),
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol_rel,
           "rel_l2_err": rel_l2, "tol_rel_l2": tol_l2,
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, **extra, "library_ms": lib_ms,
           "turns_ms": turns}
    records.append(rec)
    return rec


def _check_flash_masked(gen, records, d, dtype, b=3, sq=200, sk=300, h=2,
                        kv_lens=(0, 77, 300), variant=None, chunk_tiles=None):
    """Kernel 1's kv_lens masking and return_lse outputs at a small shape:
    by default batch rows with kv_len 0, a ragged length (not a multiple of
    any kv tile) and the full length; with B = 2 and Sq = Sk = 333, a ragged
    last query and key tile in every batch row, which TMA must zero-fill
    without reading the next batch row. o, m and l are held against the
    plain version; a kv_len = 0 row must be exactly zero with m = -1e30,
    l = 0. ``variant``: the fp32 wgmma kernel's variant to launch (0 long
    rows, 1 short; default the wrapper's choice). ``chunk_tiles``: at fp32
    d 384 / 512, the 128-row query tiles a chunk of the two-pass route
    takes (default the plan's: one chunk at these sizes)."""
    from worldforge_tpu_torch.ops.flash_attention import (
        NEG_INF, _fwd_plan, _launch, flash_attention, flash_attention_plain)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    kv_lens = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    plan = None
    if variant is not None or chunk_tiles is not None:
        plan = _fwd_plan(b, sq, sk, h, d, variant, chunk_tiles=chunk_tiles)
    if plan is None:
        o, m, l = flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True)
    else:
        o, m, l = _launch(q, k, v, kv_lens, 1.0 / math.sqrt(d), True,
                          plan=plan)
    ro, rm, rl = flash_attention_plain(q, k, v, kv_lens=kv_lens,
                                       return_lse=True)
    torch.cuda.synchronize()
    empty = kv_lens == 0
    zero_row = (bool((o[empty] == 0).all()) and
                bool((m[empty] == NEG_INF).all()) and
                bool((l[empty] == 0).all()))
    live = ~empty
    of, rof = o[live].float(), ro[live].float()
    o_rel = float((of - rof).abs().max() / rof.abs().max())
    m_err = float(((m[live] - rm[live]).abs() / (1.0 + rm[live].abs())).max())
    l_rel = float(((l[live] - rl[live]).abs() / rl[live]).max())
    tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tol_ml = 1e-4
    ok = (zero_row and bool(torch.isfinite(o).all()) and o_rel <= tol_o
          and m_err <= tol_ml and l_rel <= tol_ml)
    label = f"flash_attention kv_lens+lse {dtype} d{d}"
    if variant is not None:
        label += f" variant {variant}"
    if chunk_tiles is not None:
        label += f" in {plan.chunks} chunks of {plan.chunk_tiles} tiles"
    rec = {"check": label,
           "shape": [b, sq, sk, h, d], "kv_lens": kv_lens.tolist(),
           "plan": (_flash_plan(b, sq, sk, h, d, dtype) if plan is None
                    else plan._asdict()),
           "zero_row_exact": zero_row, "o_max_rel_err": o_rel,
           "tol_o_rel": tol_o, "m_err": m_err, "l_rel_err": l_rel,
           "tol_m_l": tol_ml, "ok": ok}
    records.append(rec)
    return rec


def _attention_fp64(q, k, v):
    """softmax(q k^T / sqrt(d)) v in float64 for q [B, Sq, H, D] and k / v
    [B, Sk, H, D]: the function kernel 1 and its plain version compute, as
    the exact yardstick of both."""
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    s = (qd @ kd.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)


def _check_flash_f32_precision(gen, records, b, s, d, h=1, variant=None):
    """Kernel 1's fp32 path on inputs scaled x8 (scores 64x larger), where
    one TF32 pass misses the 1e-4 gate: the kernel's error beside those of
    the plain version in full fp32 and run with TF32 matmuls (one pass) on
    the same inputs, each against the same function in float64. The gate
    is on the kernel's error against float64: at these scores the plain
    version's own fp32 error reaches 1e-4 (logits of ~256 keep ~1e-5 of
    fp32 rounding), so a kernel as exact as float64 would still differ
    from it by that much; ``max_rel_err_vs_plain_fp32`` records that
    difference. ``variant``: as in ``_check_flash_masked``."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _fwd_plan, _launch, flash_attention, flash_attention_plain)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda") * 8.0
               for _ in range(3))
    if variant is None:
        out = flash_attention(q, k, v)
    else:
        out = _launch(q, k, v, None, 1.0 / math.sqrt(d), False,
                      plan=_fwd_plan(b, s, s, h, d, variant))
    ref = flash_attention_plain(q, k, v)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = flash_attention_plain(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    exact = _attention_fp64(q, k, v)
    torch.cuda.synchronize()
    top = max(float(exact.abs().max()), 1e-12)

    def err(x):
        return float((x.double() - exact).abs().max()) / top

    rel = err(out)
    label = f"flash_attention fp32 d{d} inputs x8 (3xTF32)"
    rec = {"check": label if variant is None else f"{label} variant {variant}",
           "shape": [b, s, s, h, d], "max_rel_err": rel, "tol_rel": 1e-4,
           "yardstick": "the same function in float64",
           "plain_fp32_max_rel_err": err(ref),
           "one_pass_tf32_matmul_max_rel_err": err(one_pass),
           "max_rel_err_vs_plain_fp32": float((out - ref).abs().max()) / max(
               float(ref.abs().max()), 1e-12),
           "ok": bool(torch.isfinite(out).all()) and rel <= 1e-4}
    records.append(rec)
    return rec


def _check_flash_variants(gen, records, b, sq, sk, h, d, label, iters):
    """Both variants of kernel 1's fp32 wgmma kernel at head dim 64 (0:
    long rows, 1: short) timed one after the other on the same inputs, each
    held against the plain version at the 1e-4 gate, beside the variant
    ``_fwd_plan`` chooses."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _fwd_plan, _launch, flash_attention_plain)
    q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in
               ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    ref = flash_attention_plain(q, k, v)
    top = max(float(ref.abs().max()), 1e-12)
    scale = 1.0 / math.sqrt(d)
    calls = {vr: (lambda plan=_fwd_plan(b, sq, sk, h, d, vr):
                  _launch(q, k, v, None, scale, False, plan=plan))
             for vr in (0, 1)}
    errs = {vr: float((fn() - ref).abs().max()) / top
            for vr, fn in calls.items()}
    rec = {"check": f"flash_attention fp32 variants {label}",
           "shape": [b, sq, sk, h, d],
           "variant_ms": {str(vr): cuda_ms(fn, iters)
                          for vr, fn in calls.items()},
           "chosen": _fwd_plan(b, sq, sk, h, d).variant,
           "max_rel_err": errs, "tol_rel": 1e-4,
           "ok": max(errs.values()) <= 1e-4}
    records.append(rec)
    return rec


def _check_flash_plan_refusals(records):
    """The fp32 entry point refuses, before it launches anything, a variant
    it does not have (1 at head dims 80 and 512), a two-pass chunk whose
    scratch is 16 bytes short, a two-pass chunk of no tiles, and a chunk at
    a one-pass head dim; no launch is counted."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _fwd_plan, _launch, flash_attention)
    q80 = torch.zeros((1, 64, 1, 80), device="cuda")
    q64 = torch.zeros((1, 64, 1, 64), device="cuda")
    q512 = torch.zeros((1, 300, 1, 512), device="cuda")
    plan = _fwd_plan(1, 64, 64, 1, 64)
    wide = _fwd_plan(1, 300, 300, 1, 512)
    cases = {"variant 1 at d 80": (q80, _fwd_plan(1, 64, 64, 1, 80)._replace(
                 variant=1), "invalid argument"),
             "variant 1 at d 512": (q512, wide._replace(variant=1),
                                    "invalid argument"),
             "d 512 scratch - 16": (q512, wide._replace(
                 scratch_bytes=wide.scratch_bytes - 16), "invalid argument"),
             "d 512 chunk of 0 tiles": (q512, wide._replace(chunk_tiles=0),
                                        "invalid argument"),
             "chunk at d 64": (q64, plan._replace(chunk_tiles=1),
                               "invalid configuration")}
    before = flash_attention.launches
    errors = {}
    for name, (x, bad, _) in cases.items():
        try:
            _launch(x, x, x, None, 0.125, False, plan=bad)
            errors[name] = None
        except RuntimeError as e:
            errors[name] = str(e)
    torch.cuda.synchronize()
    rec = {"check": "flash_attention fp32 plan refusals", "errors": errors,
           "ok": flash_attention.launches == before and all(
               errors[name] is not None and want in errors[name]
               for name, (_, _, want) in cases.items())}
    records.append(rec)
    return rec


def _check_flash_bf16_routes(gen, records, b, sq, sk, h, label, iters,
                             kv_len=None):
    """Kernel 1 bf16 at head dim 128 on its long-row loop (route 0) and on
    the short-key kernel walking its items head by head (walk 0) and heads
    fastest (walk 1), timed in turns on the same inputs (route 0, walk 0,
    walk 1, then back), each held against the plain version at the bf16
    gates of ``_check_flash``, beside the plan ``_bf16_plan`` chooses."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _bf16_plan, _launch, _num_sms, flash_attention_plain)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16() for s
               in ((b, sq, h, 128), (b, sk, h, 128), (b, sk, h, 128)))
    kl = None if kv_len is None else torch.full(
        (b,), kv_len, dtype=torch.int32, device="cuda")
    ref = flash_attention_plain(q, k, v, kv_lens=kl).float()
    sms = _num_sms(torch.device("cuda"))
    plans = {"long": _bf16_plan(b, sq, sk, h, 128, 0, sms),
             "short walk 0": _bf16_plan(b, sq, sk, h, 128, 1, sms, 0),
             "short walk 1": _bf16_plan(b, sq, sk, h, 128, 1, sms, 1)}
    calls = {name: (lambda plan=plan: _launch(q, k, v, kl,
                                              1.0 / math.sqrt(128), False,
                                              plan=plan))
             for name, plan in plans.items()}
    errs = {}
    for name, fn in calls.items():
        diff = fn().float() - ref
        errs[name] = (float(diff.abs().max() / ref.abs().max()),
                      float(diff.norm() / ref.norm()))
    ms = in_turns(calls, iters)
    chosen = _bf16_plan(b, sq, sk, h, 128, num_sms=sms)
    rec = {"check": f"flash_attention bf16 routes {label}",
           "shape": [b, sq, sk, h, 128], "kv_len": kv_len, "variant_ms": ms,
           "chosen": {"route": chosen.route, "walk": chosen.walk},
           "max_rel_err": {n: e[0] for n, e in errs.items()},
           "rel_l2_err": {n: e[1] for n, e in errs.items()},
           "tol_rel": 2e-2, "tol_rel_l2": 1e-2,
           "ok": all(e[0] <= 2e-2 and e[1] <= 1e-2 for e in errs.values())}
    records.append(rec)
    return rec


def _check_flash_bf16_plan_refusals(records):
    """The bf16 entry point refuses, before it launches anything, a plan it
    does not compile: a third walk, one block more than there are items,
    the short route at head dim 64, and on the long route walk 1 or one
    block fewer than its tiles and heads; no launch is counted."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _bf16_plan, _launch, flash_attention)
    q = torch.zeros((1, 300, 2, 128), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 257, 2, 128), device="cuda", dtype=torch.bfloat16)
    q64 = torch.zeros((1, 300, 2, 64), device="cuda", dtype=torch.bfloat16)
    k64 = torch.zeros((1, 257, 2, 64), device="cuda", dtype=torch.bfloat16)
    plan = _bf16_plan(1, 300, 257, 2, 128)
    long = _bf16_plan(1, 300, 257, 2, 128, route=0)
    cases = {"walk 2": (q, k, plan._replace(walk=2), "invalid configuration"),
             "grid items + 1": (q, k, plan._replace(grid=plan.items + 1),
                                "invalid configuration"),
             "route 1 at d 64": (q64, k64, plan, "invalid argument"),
             "route 0 walk 1": (q, k, long._replace(walk=1),
                                "invalid configuration"),
             "route 0 grid items - 1": (q, k, long._replace(
                 grid=long.items - 1), "invalid configuration")}
    before = flash_attention.launches
    errors = {}
    for name, (x, y, bad, _) in cases.items():
        try:
            _launch(x, y, y, None, 0.1, False, plan=bad)
            errors[name] = None
        except RuntimeError as e:
            errors[name] = str(e)
    torch.cuda.synchronize()
    rec = {"check": "flash_attention bf16 plan refusals", "errors": errors,
           "ok": flash_attention.launches == before and all(
               errors[name] is not None and want in errors[name]
               for name, (_, _, _, want) in cases.items())}
    records.append(rec)
    return rec


def _bsa_inputs(gen, bh, s, d, scale=1.0):
    return [(torch.randn((bh, s, d), generator=gen, device="cuda")
             * scale).bfloat16() for _ in range(3)]


def _flex_bsa(q, k, v, indices, counts):
    """Kernel 5's function as one PyTorch library call, a yardstick only that
    the port never calls: compiled ``flex_attention`` over a ``BlockMask``
    built from the same per-(head, 128-query chunk) index rows and counts,
    each selected chunk listed as a full block (no mask inside it). The rows
    are padded to every key chunk; slots at or past the count are not read."""
    from torch.nn.attention.flex_attention import BlockMask, flex_attention
    from worldforge_tpu_torch.ops.bsa import CHUNK_K
    bh, nq, kmax = indices.shape
    pad = torch.zeros((bh, nq, k.shape[1] // CHUNK_K - kmax),
                      dtype=torch.int32, device=indices.device)
    rows = torch.cat([indices.int(), pad], dim=-1)[None]
    cnt = counts.int()[None]
    # the empty partial-block list gets its own tensor: one tensor passed in
    # both places fails to compile (inductor's flex template)
    mask = BlockMask.from_kv_blocks(torch.zeros_like(cnt), rows.clone(),
                                    cnt, rows, BLOCK_SIZE=CHUNK_K)
    flex = torch.compile(flex_attention)
    q4, k4, v4 = (x[None] for x in (q, k, v))
    return lambda: flex(q4, k4, v4, block_mask=mask)[0]


def _check_bsa(gen, records, iters):
    """Kernel 5 at the refine shape: 32 heads of 128, 56,320 tokens (440
    chunks), top-k 0.875 from random q/k (55 chunks each), against
    ``bsa_plain``. Gates as for kernel 1. ``library_ms`` is compiled
    ``flex_attention`` with the same block table (held to the same gates
    against ``bsa_plain``); ``dense_ms`` is kernel 1 dense on the same q, k
    and v."""
    from worldforge_tpu_torch.ops.bsa import (CHUNK_Q, bsa_bhsd, bsa_plain,
                                              select_blocks)
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    bh, s, d = LC_HEADS, REFINE_TOKENS, 128
    q, k, v = _bsa_inputs(gen, bh, s, d)
    idx, cnt = select_blocks(q, k, sparsity=BSA_SPARSITY)
    out = bsa_bhsd(q, k, v, idx, cnt)
    ref = bsa_plain(q, k, v, idx, cnt)
    library = _flex_bsa(q, k, v, idx, cnt)
    lib_out = library()
    torch.cuda.synchronize()

    def errors(x):
        diff = x.float() - ref.float()
        err = float(diff.abs().max())
        return (err, err / max(float(ref.float().abs().max()), 1e-12),
                float(diff.norm() / ref.float().norm().clamp_min(1e-12)))

    err, rel, rel_l2 = errors(out)
    _, lib_rel, lib_rel_l2 = errors(lib_out)
    ok = (bool(torch.isfinite(out).all()) and rel <= 2e-2 and rel_l2 <= 1e-2
          and lib_rel <= 2e-2 and lib_rel_l2 <= 1e-2)
    del lib_out
    ms = cuda_ms(lambda: bsa_bhsd(q, k, v, idx, cnt), iters)
    plain_ms = cuda_ms(lambda: bsa_plain(q, k, v, idx, cnt), 1)
    lib_ms = cuda_ms(library, iters)
    qd, kd, vd = (x.reshape(1, bh, s, d).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    dense_ms = cuda_ms(lambda: flash_attention(qd, kd, vd), 2)
    # the work this selection needs: every query row against count * 128
    # keys, 2 products of d multiply-adds each
    flops = 4.0 * CHUNK_Q * CHUNK_Q * d * float(cnt.sum())
    bms, by = bound(flops, nbytes(q, k, v, idx, cnt) + nbytes(q),
                    PEAK_BF16_FLOPS)
    rec = {"check": "bsa refine", "shape": [bh, s, d],
           "kmax": idx.shape[-1], "count_mean": float(cnt.float().mean()),
           "dtype": str(q.dtype), "max_abs_err": err, "max_rel_err": rel,
           "tol_rel": 2e-2, "rel_l2_err": rel_l2, "tol_rel_l2": 1e-2,
           "library_max_rel_err": lib_rel, "library_rel_l2_err": lib_rel_l2,
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "dense_ms": dense_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library": "torch.compile(flex_attention), BlockMask.from_kv_blocks"}
    records.append(rec)
    return rec


def _check_bsa_small(gen, records, d):
    """Kernel 5's counts, zero rows and m/l at a small shape: CDF selection
    (variable counts) with one count forced to 0, held against
    ``bsa_plain`` with ``return_lse``; then sparsity 0 (every chunk
    selected) against kernel 1 dense on the same q, k and v."""
    from worldforge_tpu_torch.ops.bsa import (NEG_INF, bsa_bhsd, bsa_plain,
                                              select_blocks)
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    bh, sq, sk = 3, 512, 768
    q = _bsa_inputs(gen, bh, sq, d, 3.0)[0]
    k, v = _bsa_inputs(gen, bh, sk, d, 3.0)[:2]
    idx, cnt = select_blocks(q, k, sparsity=None, cdf_threshold=0.5)
    cnt[1, 2] = 0
    o, m, l = bsa_bhsd(q, k, v, idx, cnt, return_lse=True)
    ro, rm, rl = bsa_plain(q, k, v, idx, cnt, return_lse=True)
    torch.cuda.synchronize()
    z = slice(2 * 128, 3 * 128)
    zero_row = (bool((o[1, z] == 0).all()) and bool((m[1, z] == NEG_INF).all())
                and bool((l[1, z] == 0).all()))
    live = l > 0
    o_rel = float((o.float() - ro.float()).abs().max() / ro.float().abs().max())
    m_err = float(((m - rm).abs() / (1.0 + rm.abs()))[live].max())
    l_rel = float(((l - rl).abs() / rl.clamp_min(1e-30))[live].max())
    ok = (zero_row and bool(torch.isfinite(o).all()) and o_rel <= 2e-2
          and m_err <= 1e-4 and l_rel <= 1e-4)
    records.append({
        "check": f"bsa counts+lse d{d}", "shape": [bh, sq, sk, d],
        "counts": cnt.tolist(), "zero_row_exact": zero_row,
        "o_max_rel_err": o_rel, "tol_o_rel": 2e-2, "m_err": m_err,
        "l_rel_err": l_rel, "tol_m_l": 1e-4, "ok": ok})
    idx, cnt = select_blocks(q, k, sparsity=0.0)
    o = bsa_bhsd(q, k, v, idx, cnt)
    dense = flash_attention(*(x[None].transpose(1, 2) for x in (q, k, v)))
    dense = dense.transpose(1, 2)[0]
    torch.cuda.synchronize()
    diff = o.float() - dense.float()
    rel = float(diff.abs().max() / dense.float().abs().max())
    rel_l2 = float(diff.norm() / dense.float().norm())
    records.append({
        "check": f"bsa sparsity 0 vs flash dense d{d}",
        "shape": [bh, sq, sk, d], "max_rel_err": rel, "tol_rel": 2e-2,
        "rel_l2_err": rel_l2, "tol_rel_l2": 1e-2,
        "ok": bool(torch.isfinite(o).all()) and rel <= 2e-2 and
        rel_l2 <= 1e-2})


def _check_rope(gen, records, grid, h, d, iters, in_dtype=torch.bfloat16,
                label="rope_qk", b=1):
    """Kernel 2 on q, k [b, f*h*w, heads, d] of ``in_dtype``, bf16 out (the
    Wan DiT rotates bf16 q/k, the LongCat DiT fp32 q/k after its RMSNorm).
    ``iters`` 0: the check alone, untimed."""
    from worldforge_tpu_torch.ops.rope import (apply_rope_qk,
                                               apply_rope_qk_plain,
                                               rope_cos_sin)
    s = math.prod(grid)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(in_dtype)
    k = torch.randn((b, s, h, d), generator=gen, device="cuda").to(in_dtype)
    cos, sin = rope_cos_sin(*grid, d, device="cuda")
    out_dtype = torch.bfloat16
    qo, ko = apply_rope_qk(q, k, cos, sin, out_dtype=out_dtype)
    qr, kr = apply_rope_qk_plain(q, k, cos, sin, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ulps = max(bf16_ulps(qo, qr), bf16_ulps(ko, kr))
    err = max(float((qo.float() - qr.float()).abs().max()),
              float((ko.float() - kr.float()).abs().max()))
    rec = {"check": label, "shape": list(q.shape), "dtype_in": str(in_dtype),
           "max_abs_err": err, "max_ulps_bf16": ulps, "tol_ulps": 1,
           "ok": ulps <= 1}
    if iters:
        ms = cuda_ms(lambda: apply_rope_qk(q, k, cos, sin,
                                           out_dtype=out_dtype), iters)
        plain_ms = cuda_ms(lambda: apply_rope_qk_plain(
            q, k, cos, sin, out_dtype=out_dtype), 3)
        flops = 6.0 * q.numel()    # 4 multiplies + 2 adds per pair, q and k
        bms, by = bound(flops, nbytes(q, k) + nbytes(qo, ko) +
                        nbytes(cos, sin), PEAK_FP32_FLOPS)
        rec.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": None, "library":
                    "none: no PyTorch call rotates interleaved pairs"})
    records.append(rec)
    return rec


def _check_mod_ln(gen, records, s, d, iters):
    from worldforge_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, modulated_layer_norm_ref)
    x = torch.randn((1, s, d), generator=gen, device="cuda") * 3.0 + 0.5
    sc = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
    sh = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
    out = modulated_layer_norm(x, sc, sh)
    ref = modulated_layer_norm_ref(x, sc, sh)
    torch.cuda.synchronize()
    ulps = bf16_ulps(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    ms = cuda_ms(lambda: modulated_layer_norm(x, sc, sh), iters)
    plain_ms = cuda_ms(lambda: modulated_layer_norm_ref(x, sc, sh), 3)
    bms, by = bound(8.0 * x.numel(), nbytes(x, sc, sh) + nbytes(out),
                    PEAK_FP32_FLOPS)
    # at B = 1 one LayerNorm with weight 1 + scale and bias shift, then a
    # cast, computes the same function
    w, bias = 1.0 + sc[0, 0], sh[0, 0]
    lib_ms = cuda_ms(lambda: torch.nn.functional.layer_norm(
        x, (d,), weight=w, bias=bias).to(torch.bfloat16), iters)
    rec = {"check": "modulated_layer_norm", "shape": list(x.shape),
           "max_abs_err": err, "max_ulps_bf16": ulps, "tol_ulps": 1,
           "ok": ulps <= 1, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "library_ms": lib_ms,
           "library": "F.layer_norm(weight=1+scale, bias=shift) + bf16 cast"}
    records.append(rec)
    return rec


def _conv_plan_rec(taps, b, t, hh, ww, cin, cout, x_dtype):
    """Kernel 4's route, output box, slice width and channel chunk for a
    call (``ops/conv3d.py::conv_plan``)."""
    from worldforge_tpu_torch.ops.conv3d import conv_plan
    p = conv_plan(cin, cout, x_dtype, taps=taps, batch=b, frames=t,
                  height=hh, width=ww,
                  sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return {"route": p.route_name, "box": [p.box_f, p.box_r, p.box_w],
            "n": p.n, "ck": p.ck, "walk": p.walk, "blocks": p.blocks}


def _conv_errors(out, ref32):
    """The kernel's error against the plain version's fp32 result, over the
    largest |ref|. A bf16 output is first allowed its own rounding (one
    bf16 ulp of each value, 2^-8 of it): both sides round their fp32 sums,
    summed in another order, to bf16."""
    diff = (out.float() - ref32).abs()
    if out.dtype == torch.bfloat16:
        diff = (diff - 2.0 ** -8 * ref32.abs()).clamp_min(0.0)
    err = float(diff.max())
    return err, err / max(float(ref32.abs().max()), 1e-12)


def _check_conv(gen, records, t, hh, ww, cin, cout, iters, label, b=1,
                x_dtype=torch.float32, out_dtype=None):
    """Kernel 4 against ``conv3d_causal_plain`` (gate: 1e-3 of the largest
    |ref|). ``iters`` > 0 also times it as the VAE calls it (fp32 x in, the
    output type out) beside its plain version, its bound and two library
    yardsticks: ``library_ms``, bf16 ``F.conv3d`` (cuDNN) on the same x
    with x's cast to bf16 and the output's cast back to x's type inside the
    timed call (the same function on the same footing), and
    ``library_precast_ms``, the same conv on x cast to bf16 and laid out as
    NCDHW beforehand (the yardstick PR 3 reported)."""
    from worldforge_tpu_torch.ops.conv3d import (conv3d_causal,
                                                 conv3d_causal_plain)
    x = torch.randn((b, t + 2, hh, ww, cin), generator=gen,
                    device="cuda").to(x_dtype)
    w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                    device="cuda") / math.sqrt(27 * cin)
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    out_dtype = out_dtype or x_dtype
    out = conv3d_causal(x, w, bias, out_dtype=out_dtype)
    ref = conv3d_causal_plain(x, w, bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err, rel = _conv_errors(out, ref)
    tol = 1e-3
    rec = {"check": label, "shape": [b, t, hh, ww, cin, cout],
           "dtype_in": str(x_dtype), "dtype_out": str(out_dtype),
           "plan": _conv_plan_rec(3, b, t, hh, ww, cin, cout, x_dtype),
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "ok": bool(torch.isfinite(out).all()) and rel <= tol}
    if iters:
        ms = cuda_ms(lambda: conv3d_causal(x, w, bias, out_dtype=out_dtype),
                     iters)
        plain_ms = cuda_ms(lambda: conv3d_causal_plain(
            x, w, bias, out_dtype=out_dtype), 1)
        flops = 2.0 * 27 * cin * cout * b * t * hh * ww
        bms, by = bound(flops, nbytes(x, w, bias) + nbytes(out),
                        PEAK_BF16_FLOPS)
        conv = torch.nn.functional.conv3d
        wl = w.bfloat16().permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        bl = bias.bfloat16()
        xv = x.permute(0, 4, 1, 2, 3)         # NCDHW view of NDHWC
        lib_ms = cuda_ms(lambda: conv(xv.to(torch.bfloat16), wl, bl,
                                      padding=(0, 1, 1)).to(out_dtype), iters)
        xl = x.bfloat16().permute(0, 4, 1, 2, 3).contiguous()
        wc = w.bfloat16().permute(4, 3, 0, 1, 2).contiguous()
        pre_ms = cuda_ms(lambda: conv(xl, wc, bl, padding=(0, 1, 1)), iters)
        rec.update({
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library": "bf16 F.conv3d (cuDNN) with "
            "the casts of x and y inside the timed call",
            "library_precast_ms": pre_ms, "library_precast":
            "bf16 F.conv3d on x cast and laid out NCDHW beforehand"})
    records.append(rec)
    return rec


def _check_conv2d(gen, records, n, hh, ww, cin, cout, iters, label,
                  x_dtype=torch.float32, out_dtype=None):
    """Kernel 4 with one temporal tap (``conv2d_3x3``) against
    ``conv2d_3x3_plain``, on ``_check_conv``'s gate; with ``iters`` it is
    timed as the VAE calls it (fp32 in and out) beside its bound and the
    library yardstick, bf16 ``F.conv2d`` (cuDNN) with the casts inside the
    timed call."""
    from worldforge_tpu_torch.ops.conv3d import conv2d_3x3, conv2d_3x3_plain
    x = torch.randn((n, hh, ww, cin), generator=gen, device="cuda").to(
        x_dtype)
    w = torch.randn((3, 3, cin, cout), generator=gen,
                    device="cuda") / math.sqrt(9 * cin)
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    out_dtype = out_dtype or x_dtype
    out = conv2d_3x3(x, w, bias, out_dtype=out_dtype)
    ref = conv2d_3x3_plain(x, w, bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err, rel = _conv_errors(out, ref)
    tol = 1e-3
    rec = {"check": label, "shape": [n, hh, ww, cin, cout],
           "dtype_in": str(x_dtype), "dtype_out": str(out_dtype),
           "plan": _conv_plan_rec(1, 1, n, hh, ww, cin, cout, x_dtype),
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "ok": bool(torch.isfinite(out).all()) and rel <= tol}
    if iters:
        flops = 2.0 * 9 * cin * cout * n * hh * ww
        bms, by = bound(flops, nbytes(x, w, bias) + nbytes(out),
                        PEAK_BF16_FLOPS)
        wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = bias.bfloat16()
        xv = x.permute(0, 3, 1, 2)            # NCHW view of NHWC
        rec.update({
            "ms": cuda_ms(lambda: conv2d_3x3(x, w, bias,
                                             out_dtype=out_dtype), iters),
            "plain_ms": cuda_ms(lambda: conv2d_3x3_plain(
                x, w, bias, out_dtype=out_dtype), 1),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
                xv.to(torch.bfloat16), wl, bl, padding=1).to(out_dtype),
                iters),
            "library": "bf16 F.conv2d (cuDNN) with the casts of x and y "
                       "inside the timed call"})
    records.append(rec)
    return rec


# Small ragged cases of kernel 4, held to the same gate: (B, T, H, W, Cin,
# Cout, x dtype, out dtype). They cover Tp = 3 to 6, a ragged H (5, 8, 13)
# and W (5, 7, 13, 26, 40, 103), each route: the tile route's 8 x 32 box and
# other boxes (W 13: two frames a box), Cin 3 / 4 / 8 on the fold, Cout 3 /
# 4 / 8 on the walk (x by TMA into the bf16 slab or through the fp32
# staging, CK 16 and 32, and by the producer's threads at Cin 10), Cin 16 /
# 96 / 192 / 384 on the tile route (the N slices 16, 32, 96 (x2) and 128
# (x3)), B = 2, and every pairing of fp32 and bf16 in and out.
_F32, _BF16 = torch.float32, torch.bfloat16
CONV_RAGGED = (
    (1, 1, 13, 103, 3, 32, _F32, _F32),
    (2, 2, 13, 103, 16, 3, _BF16, _BF16),
    (1, 1, 13, 103, 96, 96, _BF16, _F32),
    (1, 2, 13, 103, 384, 384, _F32, _BF16),
    (2, 1, 9, 40, 192, 192, _F32, _F32),
    (1, 3, 13, 103, 16, 384, _F32, _F32),
    (1, 1, 13, 103, 96, 3, _F32, _F32),
    (1, 2, 5, 7, 3, 96, _BF16, _BF16),
    (1, 1, 13, 103, 384, 32, _F32, _F32),
    (2, 1, 5, 7, 4, 8, _BF16, _F32),
    (1, 4, 13, 26, 8, 3, _F32, _BF16),
    (1, 3, 13, 7, 3, 96, _F32, _BF16),
    (2, 3, 8, 13, 96, 4, _BF16, _F32),
    (1, 2, 13, 5, 32, 8, _F32, _F32),
    (1, 4, 5, 26, 48, 3, _F32, _BF16),
    (2, 4, 13, 13, 10, 3, _F32, _F32),
    (1, 1, 5, 26, 96, 3, _BF16, _BF16),
    (2, 2, 8, 13, 64, 96, _F32, _F32),
    (1, 4, 5, 13, 32, 160, _BF16, _BF16),
)
# (N, H, W, Cin, Cout, x dtype, out dtype) for the one-tap instantiation;
# Cout 320 on N 160 in bf16 and fp32, 1280 on N 128 where the wave model
# takes it (24 frames of 8 x 13, two frames a box), Cin 3 on the fold (one
# slice of Cout 3 / 16), Cin 4 / 8 and Cout 3 / 4 on the tile route, 1, 2,
# 24 and 25 frames
CONV2D_RAGGED = (
    (1, 13, 103, 16, 32, _F32, _F32),
    (3, 13, 103, 3, 3, _F32, _F32),
    (2, 17, 33, 32, 16, _BF16, _BF16),
    (2, 17, 33, 384, 192, _F32, _BF16),
    (24, 17, 33, 320, 320, _BF16, _BF16),
    (1, 13, 103, 16, 320, _F32, _F32),
    (24, 7, 13, 64, 1280, _F32, _F32),
    (25, 5, 7, 4, 512, _F32, _F32),
    (24, 8, 13, 64, 1280, _BF16, _BF16),
    (1, 13, 26, 8, 320, _F32, _BF16),
    (2, 8, 5, 320, 4, _F32, _F32),
    (25, 13, 13, 128, 3, _BF16, _F32),
    (2, 5, 26, 3, 3, _BF16, _BF16),
)


def phase_kernels():
    """Every kernel against its plain version at the main path's shapes.
    The first record of each kernel is its main shape (the table row)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = (DIT_FRAMES // 4 + 1) * (HEIGHT // 16) * (WIDTH // 16)   # 20,280
    records = []
    main = {}
    main["flash_attention"] = _check_flash(
        gen, records, 1, s, s, 40, 128, torch.bfloat16, 2e-2, 1e-2,
        "flash_attention self-attn", 5)
    main[TEXT_ROW] = _check_flash(
        gen, records, 1, s, 512, 40, 128, torch.bfloat16, 2e-2, 1e-2,
        "flash_attention text cross-attn", 10)
    main[CLIP_ROW] = _check_flash(
        gen, records, 1, s, 257, 40, 128, torch.bfloat16, 2e-2, 1e-2,
        "flash_attention clip cross-attn", 10)
    main[WAN_VAE_ROW] = _check_flash(
        gen, records, GEN_FRAMES // 4 + 1, (HEIGHT // 8) * (WIDTH // 8),
        (HEIGHT // 8) * (WIDTH // 8), 1, 384, torch.float32, 1e-4, 1e-4,
        "flash_attention vae fp32 d384", 3)
    for dtype, dims in ((torch.bfloat16, (64, 128)),
                        (torch.float32, (64, 80, 128, 384, 512))):
        for d in dims:
            _check_flash_masked(gen, records, d, dtype)
    for d, dtype in ((128, torch.bfloat16), (384, torch.float32),
                     (80, torch.float32), (512, torch.float32)):
        _check_flash_masked(gen, records, d, dtype, b=2, sq=333, sk=333,
                            kv_lens=(333, 129))
    # the two-pass route over several chunks: 3 x 3 query tiles (the last
    # of each batch row ragged) in chunks of 4, 4 and 1 tiles, the first
    # two spanning batch rows, kv_lens full, ragged and 0 (its own
    # generator, so the later checks' inputs stay as they were)
    chunk_gen = torch.Generator(device="cuda").manual_seed(19)
    for d in (384, 512):
        _check_flash_masked(chunk_gen, records, d, torch.float32, b=3,
                            sq=333, sk=333, h=1, kv_lens=(333, 200, 0),
                            chunk_tiles=4)
    # the warp's and the encoders' shapes: the DINO backbone and the VGGT
    # aggregator at 294 x 518 (21 x 37 patches + 5 special tokens), the
    # camera head's trunk over S = 1 frame, CLIP-H (16 heads of 80)
    _check_flash(gen, records, 1, VGGT_TOKENS, VGGT_TOKENS, 16, 64,
                 torch.float32, 1e-4, 1e-4, "flash_attention vggt fp32 d64",
                 10)
    _check_flash(gen, records, 1, 1, 1, 16, 128, torch.float32, 1e-4, 1e-4,
                 "flash_attention vggt camera trunk fp32 d128 S=1", 10)
    main[CLIP_H_ROW] = _check_flash(
        gen, records, 1, 257, 257, 16, 80, torch.float32, 1e-4, 1e-4,
        "flash_attention clip-h fp32 d80", 10)
    # the same three with kv_lens and m / l: a second batch row with a
    # ragged key length (none at S = 1: an empty row)
    for d, s_, kl in ((64, VGGT_TOKENS, 500), (128, 1, 0), (80, 257, 200)):
        _check_flash_masked(gen, records, d, torch.float32, b=2, sq=s_,
                            sk=s_, h=16, kv_lens=(s_, kl))
    _check_flash_f32_precision(gen, records, 1, 257, 80)
    _check_flash_f32_precision(gen, records, 1, (HEIGHT // 8) * (WIDTH // 8),
                               384)
    # the fp32 wgmma kernel's variants (both at d 64, the long one at d 80)
    # at small ragged shapes with kv_lens and m / l, and on inputs x8
    for d, variants in ((64, (0, 1)), (80, (0,))):
        for variant in variants:
            _check_flash_masked(gen, records, d, torch.float32,
                                variant=variant)
            _check_flash_masked(gen, records, d, torch.float32, b=2, sq=333,
                                sk=333, kv_lens=(333, 129), variant=variant)
            _check_flash_f32_precision(gen, records, 1, 1000, d, h=4,
                                       variant=variant)
    _check_flash_plan_refusals(records)
    main["rope_qk"] = _check_rope(
        gen, records, (DIT_FRAMES // 4 + 1, HEIGHT // 16, WIDTH // 16), 40,
        128, 20)
    # ragged token and head runs: 333 tokens, 12 heads of 64, B = 2
    for dtype in (torch.bfloat16, torch.float32):
        _check_rope(gen, records, (3, 3, 37), 12, 64, 0, in_dtype=dtype,
                    label=f"rope_qk ragged {dtype}", b=2)
    main["modulated_layer_norm"] = _check_mod_ln(gen, records, s, 5120, 20)
    main["conv3d_causal"] = _check_conv(
        gen, records, GEN_FRAMES, HEIGHT, WIDTH, 96, 96, 3,
        "conv3d 96->96 full res")
    main[CONV_IN_ROW] = _check_conv(gen, records, GEN_FRAMES, HEIGHT,
                                    WIDTH, 3, 96, 3,
                                    "conv3d encoder conv_in 3->96")
    main[CONV_OUT_ROW] = _check_conv(gen, records, GEN_FRAMES, HEIGHT,
                                     WIDTH, 96, 3, 3,
                                     "conv3d decoder conv_out 96->3")
    _check_conv(gen, records, GEN_FRAMES, HEIGHT // 2, WIDTH // 2, 192, 192,
                3, "conv3d 192->192 half res")
    _check_conv(gen, records, GEN_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8,
                384, 384, 5, "conv3d 384->384 latent res")
    # kernel 4 with one tap: the decoder's first resample conv (384 -> 192
    # at 120 x 208) on the 9 frames of the single-pass decode at 17 frames
    # and the 2 of a streaming chunk, the last one (192 -> 96 at 480 x 832),
    # and ragged cases
    main["conv2d_3x3"] = _check_conv2d(
        gen, records, 9, HEIGHT // 4, WIDTH // 4, 384, 192, 5,
        "conv2d_3x3 384->192 9x120x208")
    _check_conv2d(gen, records, 2, HEIGHT // 4, WIDTH // 4, 384, 192, 5,
                  "conv2d_3x3 384->192 2x120x208")
    _check_conv2d(gen, records, 2, HEIGHT, WIDTH, 192, 96, 5,
                  "conv2d_3x3 192->96 2x480x832")
    for n, hh, ww, cin, cout, xd, od in CONV2D_RAGGED:
        _check_conv2d(gen, records, n, hh, ww, cin, cout, 0,
                      f"conv2d_3x3 ragged {cin}->{cout} {n}x{hh}x{ww} "
                      f"{xd}->{od}", x_dtype=xd, out_dtype=od)
    for b, t, hh, ww, cin, cout, xd, od in CONV_RAGGED:
        _check_conv(gen, records, t, hh, ww, cin, cout, 0,
                    f"conv3d ragged {cin}->{cout} {hh}x{ww} T'{t + 2} B{b} "
                    f"{xd}->{od}", b=b, x_dtype=xd, out_dtype=od)
    # the LongCat refine's shapes (56,320 tokens, the VAE at 704x1280)
    main["bsa"] = _check_bsa(gen, records, 5)
    for d in (64, 128):
        _check_bsa_small(gen, records, d)
    _check_flash(gen, records, 1, REFINE_TOKENS, TEXT_LEN, LC_HEADS, 128,
                 torch.bfloat16, 2e-2, 1e-2,
                 "flash_attention refine text cross-attn kv_lens", 10,
                 kv_len=REFINE_KV_LEN)
    _check_flash(gen, records, 1, (REFINE_H // 8) * (REFINE_W // 8),
                 (REFINE_H // 8) * (REFINE_W // 8), 1, 384, torch.float32,
                 1e-4, 1e-4, "flash_attention refine vae fp32 d384", 3)
    _check_rope(gen, records, REFINE_GRID, LC_HEADS, 128, 20,
                in_dtype=torch.float32, label="rope_qk refine fp32 in")
    # the LongCat guided i2v's shapes: 20,280 tokens with the cond/noise
    # split (cond 1,560 to cond; noise 18,720 to all), text to noise only
    _check_flash(gen, records, 1, LC_TOKENS - LC_COND_TOKENS, LC_TOKENS,
                 LC_HEADS, 128, torch.bfloat16, 2e-2, 1e-2,
                 "flash_attention longcat guided noise->all", 5)
    _check_flash(gen, records, 1, LC_COND_TOKENS, LC_COND_TOKENS, LC_HEADS,
                 128, torch.bfloat16, 2e-2, 1e-2,
                 "flash_attention longcat guided cond->cond", 10)
    main[LC_TEXT_ROW] = _check_flash(
        gen, records, 1, LC_TOKENS - LC_COND_TOKENS, TEXT_LEN, LC_HEADS, 128,
        torch.bfloat16, 2e-2, 1e-2, LC_TEXT_ROW, 10, kv_len=LC_KV_LEN)
    _check_rope(gen, records, (DIT_FRAMES // 4 + 1, HEIGHT // 16,
                               WIDTH // 16), LC_HEADS, 128, 20,
                in_dtype=torch.float32, label="rope_qk longcat guided fp32 in")
    _check_conv(gen, records, 4, REFINE_H, REFINE_W, 96, 96, 3,
                "conv3d 96->96 refine 704x1280 T'6")
    # the Wan facades' and the avatar's new shapes: FLF2V's image
    # cross-attention (7,800 queries -> 2 x 257 CLIP-H tokens) and the
    # avatar's per-frame audio cross-attention (23 noise frames folded into
    # the batch, 1,560 queries each -> 32 audio tokens; 64 in multitalk),
    # and short key runs with kv_lens at small shapes (the tiny avatar's 4
    # and 8 audio tokens on its card-vs-CPU check)
    main[FLF2V_ROW] = _check_flash(
        gen, records, 1, FACADE_TOKENS, FLF2V_IMAGE_TOKENS, 40, 128,
        torch.bfloat16, 2e-2, 1e-2, FLF2V_ROW, 10)
    main[AUDIO_ROW] = _check_flash(
        gen, records, AVATAR_NOISE_FRAMES, LC_COND_TOKENS,
        AVATAR_AUDIO_TOKENS, LC_HEADS, 128, torch.bfloat16, 2e-2, 1e-2,
        AUDIO_ROW, 10)
    main[MULTITALK_ROW] = _check_flash(
        gen, records, AVATAR_NOISE_FRAMES, LC_COND_TOKENS,
        2 * AVATAR_AUDIO_TOKENS, LC_HEADS, 128, torch.bfloat16, 2e-2, 1e-2,
        MULTITALK_ROW, 10)
    _check_flash_masked(gen, records, 128, torch.bfloat16, sk=32,
                        kv_lens=(32, 17, 0))
    _check_flash_masked(gen, records, 64, torch.float32, b=2, sq=100, sk=8,
                        kv_lens=(8, 5))
    # kernel 1's short-key route (bf16 d 128): key counts at and around its
    # tile edges (the last tile 16, 32, 64 or 128 wide; K / V resident up to
    # 320 keys, streamed past it), each with a ragged and an empty row, m /
    # l, B = 3 and a ragged last query tile; then its routes and walks timed
    # at the cross-attention rows and at its reach's edge, and a wrong plan
    # refused
    for sk in (1, 16, 17, 129, 257, 272, 513, 514):
        _check_flash_masked(gen, records, 128, torch.bfloat16, sk=sk,
                            kv_lens=(sk, max(1, 2 * sk // 3), 0))
    # the same at 3 x 32 query tiles x 40 heads: 3,840 items, about 29 for
    # each persistent block, so a block crosses heads and batch rows,
    # reuses its Q buffers, keeps stores in flight behind its loads, and
    # runs the empty row's items: walk 1 with K / V resident in two buffers
    # (32 keys), walk 0 with one resident buffer (257) and streamed (514)
    for sk in (32, 257, 514):
        _check_flash_masked(gen, records, 128, torch.bfloat16, b=3, sq=4096,
                            sk=sk, h=40, kv_lens=(sk, 2 * sk // 3, 0))
    for label, shape in (("text 512", (1, s, 512, 40)),
                         ("clip 257", (1, s, 257, 40)),
                         ("audio 32", (AVATAR_NOISE_FRAMES, LC_COND_TOKENS,
                                       AVATAR_AUDIO_TOKENS, LC_HEADS)),
                         ("longcat cond 1560", (1, LC_COND_TOKENS,
                                                LC_COND_TOKENS, LC_HEADS)),
                         ("2048 keys", (1, s, 2048, 40))):
        _check_flash_bf16_routes(gen, records, *shape, label, 5)
    _check_flash_bf16_plan_refusals(records)
    # the sfm phase's new shape: VGGT-1B's global attention over 8 frames
    # of 518 x 518
    main[SFM_GLOBAL_ROW] = _check_flash(
        gen, records, 1, SFM_FRAMES * SFM_TOKENS, SFM_FRAMES * SFM_TOKENS,
        16, 64, torch.float32, 1e-4, 1e-4, SFM_GLOBAL_ROW, 5)
    main[SFM_FRAME_ROW] = _check_flash(
        gen, records, SFM_FRAMES, SFM_TOKENS, SFM_TOKENS, 16, 64,
        torch.float32, 1e-4, 1e-4, SFM_FRAME_ROW, 10)
    main.update(_dc_kernel_checks(gen, records))
    main.update(_backward_kernel_checks(gen, records))
    for rec in records:
        emit({"phase": "kernels", **rec})
    bad = [r["check"] for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain "
                         f"versions: {bad}")
    return main


# kernel 4's one-tap instantiation at the DepthCrafter stage's 3x3 convs,
# (N, H, W, Cin, Cout): every (Cin, Cout) pair the UNet and VAE give it at
# 512 x 832, each at a size where it runs. The UNet on a 24-frame window of
# 64 x 104 latents: conv_in 8 -> 320, the resnets and upsamplers at the
# four levels, the skip concatenations' Cin 640, 960, 1280, 1920 and 2560,
# conv_out to 4. The VAE on a chunk of 8 frames: the encoder's conv_in from
# 3 and conv_out to 8 moments, the decoder's conv_in from 4 and conv_out to
# 3, the 128 / 256 / 512 resnets and upsamplers. The first is the table's
# row; ``phase_depthcrafter`` fails if the path launches a pair not here.
DC_CONV2D = (
    (DC_WINDOW, DC_H // 8, DC_W // 8, 320, 320),
    (DC_WINDOW, DC_H // 8, DC_W // 8, 8, 320),
    (DC_WINDOW, DC_H // 8, DC_W // 8, 640, 320),
    (DC_WINDOW, DC_H // 8, DC_W // 8, 960, 320),
    (DC_WINDOW, DC_H // 8, DC_W // 8, 640, 640),
    (DC_WINDOW, DC_H // 8, DC_W // 8, 320, 4),
    (DC_WINDOW, DC_H // 16, DC_W // 16, 320, 640),
    (DC_WINDOW, DC_H // 16, DC_W // 16, 960, 640),
    (DC_WINDOW, DC_H // 16, DC_W // 16, 1280, 640),
    (DC_WINDOW, DC_H // 16, DC_W // 16, 1920, 640),
    (DC_WINDOW, DC_H // 16, DC_W // 16, 1280, 1280),
    (DC_WINDOW, DC_H // 32, DC_W // 32, 640, 1280),
    (DC_WINDOW, DC_H // 32, DC_W // 32, 1920, 1280),
    (DC_WINDOW, DC_H // 32, DC_W // 32, 2560, 1280),
    (DC_WINDOW, DC_H // 64, DC_W // 64, 2560, 1280),
    (DC_WINDOW, DC_H // 64, DC_W // 64, 1280, 1280),
    (DC_DECODE_CHUNK, DC_H, DC_W, 3, 128),
    (DC_DECODE_CHUNK, DC_H, DC_W, 128, 128),
    (DC_DECODE_CHUNK, DC_H, DC_W, 256, 128),
    (DC_DECODE_CHUNK, DC_H, DC_W, 256, 256),
    (DC_DECODE_CHUNK, DC_H, DC_W, 128, 3),
    (DC_DECODE_CHUNK, DC_H // 2, DC_W // 2, 128, 256),
    (DC_DECODE_CHUNK, DC_H // 2, DC_W // 2, 512, 256),
    (DC_DECODE_CHUNK, DC_H // 2, DC_W // 2, 512, 512),
    (DC_DECODE_CHUNK, DC_H // 4, DC_W // 4, 256, 512),
    (DC_DECODE_CHUNK, DC_H // 8, DC_W // 8, 512, 512),
    (DC_DECODE_CHUNK, DC_H // 8, DC_W // 8, 512, 8),
    (DC_DECODE_CHUNK, DC_H // 8, DC_W // 8, 4, 512),
)


def _dc_kernel_checks(gen, records):
    """Kernels 1 and 4 at the DepthCrafter stage's shapes. Kernel 1: the
    SVD VAE's mid attention (fp32, one head of 512, on a decode chunk of 8
    frames), the UNet's fp32 heads of 64 at the published 110-frame window
    (spatial over 110 frames of 6,656 tokens, temporal over 6,656 rows of
    110 frames, cross-attention to the one CLIP token), d 512 at small
    ragged shapes and on inputs x8; and the grid: more than 65,535 B*H rows
    in fp32 and bf16. Kernel 4: every 3x3 conv shape of ``DC_CONV2D``, fp32
    in and out as the UNet and VAE call it. Returns the table rows'
    records, keyed as ``DC_ROWS``."""
    rows = {}
    rows["flash_attention fp32 d512 (svd vae mid)"] = _check_flash(
        gen, records, DC_DECODE_CHUNK, DC_TOKENS, DC_TOKENS, 1, 512,
        torch.float32, 1e-4, 1e-4, "flash_attention svd vae fp32 d512", 3)
    _check_flash(gen, records, 2, 130, 200, 1, 512, torch.float32, 1e-4,
                 1e-4, "flash_attention fp32 d512 ragged", 3)
    _check_flash_f32_precision(gen, records, 1, DC_TOKENS, 512)
    w = DC_PUBLISHED_WINDOW
    rows["flash_attention fp32 d64 (svd unet spatial)"] = _check_flash(
        gen, records, w, DC_TOKENS, DC_TOKENS, DC_HEADS, 64, torch.float32,
        1e-4, 1e-4, "flash_attention svd unet spatial fp32 d64", 2)
    for level in (2, 3):
        tokens, heads = DC_TOKENS >> 2 * (level - 1), DC_HEADS << (level - 1)
        rows[DC_LEVEL_ROW.format(level)] = _check_flash(
            gen, records, w, tokens, tokens, heads, 64, torch.float32, 1e-4,
            1e-4, f"flash_attention svd unet spatial level {level} fp32 d64",
            3)
    rows["flash_attention fp32 d64 (svd unet temporal)"] = _check_flash(
        gen, records, DC_TOKENS, w, w, DC_HEADS, 64, torch.float32, 1e-4,
        1e-4, "flash_attention svd unet temporal fp32 d64", 3)
    rows["flash_attention fp32 d64 (svd unet cross Sk=1)"] = _check_flash(
        gen, records, w, DC_TOKENS, 1, DC_HEADS, 64, torch.float32, 1e-4,
        1e-4, "flash_attention svd unet cross-attn Sk=1 fp32 d64", 3)
    grid = [_check_flash(gen, records, GRID_ROWS, 16, 16, 1, d, dtype, tol,
                         tol_l2, f"flash_attention grid B*H 70000 {name} d{d}",
                         3)
            for d, dtype, name, tol, tol_l2 in (
                (64, torch.float32, "fp32", 1e-4, 1e-4),
                (64, torch.bfloat16, "bf16", 2e-2, 1e-2),
                (128, torch.bfloat16, "bf16", 2e-2, 1e-2))]
    # the fp32 wgmma kernel's two variants where the choice is close
    for shape, label in (((w, DC_TOKENS, 1, DC_HEADS, 64), "svd unet cross"),
                         ((DC_TOKENS, w, w, DC_HEADS, 64), "svd unet temporal"),
                         ((GRID_ROWS, 16, 16, 1, 64), "B*H 70000")):
        _check_flash_variants(gen, records, *shape, label, 3)
    rows["flash_attention fp32 d64 (B*H > 65535)"] = {
        **grid[0], "grid_checks": [
            {k: r[k] for k in ("check", "shape", "dtype", "max_abs_err",
                               "rel_l2_err", "ok", "ms", "plain_ms")}
            for r in grid]}
    conv_rows = {i: row for row, _, i in DC_CONV_ROWS}
    for i, (n, hh, ww, cin, cout) in enumerate(DC_CONV2D):
        rec = _check_conv2d(gen, records, n, hh, ww, cin, cout, 3,
                            f"conv2d_3x3 svd {cin}->{cout} {n}x{hh}x{ww}")
        if i in conv_rows:
            rows[conv_rows[i]] = rec
    return rows


# ------------------------------------------------------------ backward kernels


def _check_flash_bwd(gen, records, b, sq, sk, h, d, label, kv_lens=None,
                     iters=0, repeat=False):
    """Kernel 1's backward (``flash_attention_backward``, through autograd
    of ``flash_attention``) against autograd of ``flash_attention_plain``
    on the same bf16 inputs and output gradient: dq, dk and dv each within
    1e-2 relative L2 (both sides round P and dS to bf16 in other places,
    and the kernel sums dq in fp32 in an order that changes from run to
    run), keys past ``kv_lens`` and a ``kv_len = 0`` row exactly zero; the
    max bf16 ulps and the plan (tiles, query splits) reported. ``iters``:
    also time it beside its bound (five products of 2 Sq Sk D H, the
    design's count), the plain backward (run one head at a time, which is
    the same function on the same inputs: all 40 heads' autograd graph at
    20,280 tokens holds 98.7 GB) and SDPA's backward at the same shapes.
    ``repeat``: run the kernel twice more on the same inputs and report the
    largest difference between the runs (dq's additions come in another
    order; dk and dv must be bit-equal)."""
    from worldforge_tpu_torch.ops.flash_attention import (
        _bwd_plan, _launch, flash_attention, flash_attention_backward,
        flash_attention_plain)
    mk = lambda s: torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = mk((b, sq, h, d)), mk((b, sk, h, d)), mk((b, sk, h, d))
    do = mk((b, sq, h, d))
    kl = None if kv_lens is None else torch.tensor(
        kv_lens, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    plan = _bwd_plan(b, sq, sk, h, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    rec = {"check": label, "shape": [b, sq, sk, h, d], "kv_lens": kv_lens,
           "plan": plan._asdict(), "design_products": 5}
    if not iters:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_attention(*leaves, kv_lens=kl).backward(do)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_attention_plain(*plain, kv_lens=kl).backward(do)
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves]
        refs = [t.grad for t in plain]
        del leaves, plain
    else:
        # the plain version one head at a time, its backward timed alone
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        flash_attention(*leaves, kv_lens=kl).backward(do)
        grads = [t.grad for t in leaves]
        del leaves
        refs = [torch.empty_like(t) for t in (q, k, v)]
        plain_ms = 0.0
        for hh in range(-1, h):            # head -1: a warm-up of head 0
            sl = slice(max(hh, 0), max(hh, 0) + 1)
            part = [t[:, :, sl].detach().requires_grad_(True)
                    for t in (q, k, v)]
            o = flash_attention_plain(*part, kv_lens=kl)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            g = torch.autograd.grad(o, part, do[:, :, sl])
            t1.record()
            torch.cuda.synchronize()
            if hh >= 0:
                plain_ms += t0.elapsed_time(t1)
                for r, gg in zip(refs, g):
                    r[:, :, sl] = gg
            del o, part, g
    ok = True
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        rel = float((g.float() - r.float()).norm() /
                    r.float().norm().clamp_min(1e-30))
        rec[f"{name}_rel_l2_err"] = rel
        rec[f"{name}_max_ulps_bf16"] = bf16_ulps(g, r)
        rec[f"{name}_max_abs_err"] = float((g.float() - r.float()).abs().max())
        ok = ok and rel <= 1e-2 and bool(torch.isfinite(g).all())
    if kv_lens is not None:
        for i, n in enumerate(kv_lens):
            ok = ok and not grads[1][i, n:].any() and not grads[2][i, n:].any()
            if n == 0:
                ok = ok and not grads[0][i].any()
    rec.update({"max_abs_err": max(rec[f"{n}_max_abs_err"]
                                    for n in ("dq", "dk", "dv")),
                "tol_rel_l2": 1e-2})
    if iters or repeat:
        o, m, l = _launch(q, k, v, kl, scale, True)
    if repeat:
        runs = [flash_attention_backward(q, k, v, o, do, m, l, kl, scale)
                for _ in range(2)]
        for i, name in enumerate(("dq", "dk", "dv")):
            rec[f"{name}_run_to_run_max_abs"] = float(
                (runs[0][i].float() - runs[1][i].float()).abs().max())
        ok = ok and rec["dk_run_to_run_max_abs"] == 0.0 and \
            rec["dv_run_to_run_max_abs"] == 0.0
        del runs
    rec["ok"] = ok
    if iters:
        ms = cuda_ms(lambda: flash_attention_backward(
            q, k, v, o, do, m, l, kl, scale), iters)
        keys = sk if kv_lens is None else sum(kv_lens) / b
        flops = 5 * 2.0 * b * h * sq * keys * d
        io = nbytes(q, o, do, q, m, l) + 4 * nbytes(k) * keys / sk
        bms, by = bound(flops, io, PEAK_BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), iters)
        rec.update({"ms": ms, "plain_ms": plain_ms,
                    "plain": "autograd of flash_attention_plain, one head "
                             "at a time", "bound_ms": bms, "bound_by": by,
                    "design_bound_ms": bms, "library_ms": lib_ms,
                    "library": "backward of F.scaled_dot_product_attention"})
        del ot, qt, kt, vt
    if iters or repeat:
        del o, m, l
    records.append(rec)
    return rec


def _check_rope_bwd(gen, records, grid, h, d, iters, in_dtype, label, b=1):
    """Kernel 2's backward (the Triton kernel at -theta) against autograd of
    ``apply_rope_qk_plain``: bf16 out, the gradient bf16 in, out in the
    inputs' dtype (bf16 for the Wan DiT: within 1 bf16 ulp; fp32 for the
    LongCat DiT: within 1e-6 of the largest gradient)."""
    from worldforge_tpu_torch.ops.rope import (apply_rope_qk,
                                               apply_rope_qk_backward,
                                               apply_rope_qk_plain,
                                               rope_cos_sin)
    s = math.prod(grid)
    mk = lambda dt: torch.randn((b, s, h, d), generator=gen,
                                device="cuda").to(dt)
    q, k = mk(in_dtype), mk(in_dtype)
    gq, gk = mk(torch.bfloat16), mk(torch.bfloat16)
    cos, sin = rope_cos_sin(*grid, d, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k)]
    torch.autograd.backward(list(apply_rope_qk(
        *leaves, cos, sin, out_dtype=torch.bfloat16)), [gq, gk])
    plain = [t.clone().requires_grad_(True) for t in (q, k)]
    outs = apply_rope_qk_plain(*plain, cos, sin, out_dtype=torch.bfloat16)
    torch.autograd.backward(list(outs), [gq, gk], retain_graph=bool(iters))
    torch.cuda.synchronize()
    err = max(float((a.grad.float() - p.grad.float()).abs().max())
              for a, p in zip(leaves, plain))
    rec = {"check": label, "shape": [b, s, h, d], "dtype_in": str(in_dtype),
           "max_abs_err": err,
           "grad_dtype_ok": all(a.grad.dtype == in_dtype for a in leaves)}
    if in_dtype == torch.bfloat16:
        ulps = max(bf16_ulps(a.grad, p.grad) for a, p in zip(leaves, plain))
        rec.update({"max_ulps_bf16": ulps, "tol_ulps": 1,
                    "ok": ulps <= 1 and rec["grad_dtype_ok"]})
    else:
        rel = err / max(float(p.grad.abs().max()) for p in plain)
        rec.update({"max_rel_err": rel, "tol_rel": 1e-6,
                    "ok": rel <= 1e-6 and rec["grad_dtype_ok"]})
    if iters:
        ms = cuda_ms(lambda: apply_rope_qk_backward(gq, gk, cos, sin,
                                                    in_dtype), iters)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(
            outs, plain, (gq, gk), retain_graph=True), 3)
        bms, by = bound(6.0 * q.numel(), nbytes(gq, gk) + 2 * nbytes(q)
                        + nbytes(cos, sin), PEAK_FP32_FLOPS)
        rec.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": None, "library":
                    "none: no PyTorch call rotates interleaved pairs"})
    records.append(rec)
    return rec


def _check_mod_ln_bwd(gen, records, s, d, iters,
                      label="modulated_layer_norm backward"):
    """Kernel 3's backward (two Triton launches) against autograd of
    ``modulated_layer_norm_ref`` at x [1, s, d]: dx, dsc and dsh each
    within 1e-5 relative L2 (fp32 sums over the channels and tokens in
    another order); timed beside the autograd of ``F.layer_norm`` with
    weight 1 + scale and bias shift and the bf16 cast (the same function
    at B = 1)."""
    from worldforge_tpu_torch.ops.fused_norm import (
        _bwd_launch, modulated_layer_norm, modulated_layer_norm_backward,
        modulated_layer_norm_ref)
    x = torch.randn((1, s, d), generator=gen, device="cuda") * 3.0 + 0.5
    sc = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
    sh = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
    dy = torch.randn((1, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, sc, sh)]
    modulated_layer_norm(*leaves).backward(dy)
    plain = [t.clone().requires_grad_(True) for t in (x, sc, sh)]
    ref = modulated_layer_norm_ref(*plain)
    ref.backward(dy, retain_graph=True)
    torch.cuda.synchronize()
    rels = {n: float((a.grad - p.grad).norm() / p.grad.norm())
            for n, a, p in zip(("dx", "dsc", "dsh"), leaves, plain)}
    err = max(float((a.grad - p.grad).abs().max())
              for a, p in zip(leaves, plain))
    ms = cuda_ms(lambda: modulated_layer_norm_backward(x, sc, dy), iters)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        ref, plain, dy, retain_graph=True), 3)
    bms, by = bound(12.0 * x.numel(), 2 * nbytes(x) + nbytes(dy)
                    + 3 * nbytes(sc), PEAK_FP32_FLOPS)
    w = (1.0 + sc[0, 0]).detach().requires_grad_(True)
    bias = sh[0, 0].detach().requires_grad_(True)
    xl = x.detach().requires_grad_(True)
    y = torch.nn.functional.layer_norm(xl, (d,), weight=w,
                                       bias=bias).to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        y, (xl, w, bias), dy, retain_graph=True), iters)
    rec = {"check": label, "shape": list(x.shape),
           "launch": list(_bwd_launch(d)),
           **{f"{n}_rel_l2_err": r for n, r in rels.items()},
           "max_abs_err": err, "tol_rel_l2": 1e-5,
           "ok": max(rels.values()) <= 1e-5, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library": "backward of F.layer_norm(weight=1+scale, "
                      "bias=shift) + bf16 cast"}
    records.append(rec)
    return rec


def _check_bsa_sparse_bwd(gen, records, bh=4, s=1024, d=128):
    """``bsa_sparse`` on the card (kernel 5 forward, the backward the
    autograd of ``bsa_plain`` one head at a time) against autograd of
    ``bsa_plain`` over all heads on the same selection, bf16, sparsity 0.5
    on 8 chunks: dq, dk, dv within 1e-2 relative L2."""
    from worldforge_tpu_torch.ops.bsa import (bsa_plain, bsa_sparse,
                                              select_blocks)
    mk = lambda: torch.randn((bh, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v, g = mk(), mk(), mk(), mk()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bsa_sparse(*leaves, sparsity=0.5).backward(g)
    idx, cnt = select_blocks(q, k, sparsity=0.5)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bsa_plain(*plain, idx, cnt).backward(g)
    torch.cuda.synchronize()
    rels = {n: _rel_l2(a.grad, p.grad)
            for n, a, p in zip(("dq", "dk", "dv"), leaves, plain)}
    records.append({"check": "bsa_sparse backward (plain recompute)",
                    "shape": [bh, s, d], **{f"{n}_rel_l2_err": r
                                            for n, r in rels.items()},
                    "tol_rel_l2": 1e-2, "ok": max(rels.values()) <= 1e-2})


def _check_no_backward_fallback(records):
    """On CUDA tensors a gradient through kernel 1 with no backward
    instantiation (fp32, or bf16 with head dim 80) raises before anything
    launches; no plain version stands in."""
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    raised = []
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 80)):
        q = torch.zeros((1, 16, 2, d), dtype=dtype, device="cuda",
                        requires_grad=True)
        try:
            flash_attention(q, q, q)
        except ValueError as e:
            raised.append("no instantiation" in str(e))
        else:
            raised.append(False)
    records.append({"check": "flash_attention backward: no fallback",
                    "raised": raised, "ok": all(raised)})


def _backward_kernel_checks(gen, records):
    """The backward kernels of kernels 1-3 against autograd of their plain
    versions; returns the table rows' main records."""
    s = (DIT_FRAMES // 4 + 1) * (HEIGHT // 16) * (WIDTH // 16)   # 20,280
    main = {}
    for b, sq, sk, h, d, kv in ((1, 4096, 4096, 8, 128, None),
                                (2, 1560, 512, 4, 128, (512, 77)),
                                (2, 1560, 257, 4, 128, (257, 100)),
                                (3, 200, 300, 2, 64, (300, 0, 129)),
                                (1, 1000, 1000, 4, 64, None),
                                # 3 key tiles x 24 = 72 blocks: a query split
                                (3, 4096, 257, 8, 128, (257, 0, 100))):
        _check_flash_bwd(gen, records, b, sq, sk, h, d,
                         f"flash_attention backward bf16 d{d} "
                         f"[{b},{sq}->{sk},{h}]", kv_lens=kv)
    main["flash_attention_backward"] = _check_flash_bwd(
        gen, records, 1, s, s, 40, 128,
        "flash_attention backward self-attn", iters=3, repeat=True)
    _check_flash_bwd(gen, records, 1, s, TEXT_LEN, 40, 128,
                     "flash_attention backward text cross-attn", iters=5,
                     repeat=True)
    _check_flash_bwd(gen, records, 1, s, 257, 40, 128,
                     "flash_attention backward clip cross-attn", iters=5)
    _check_flash_bwd(gen, records, 1, 4096, 4096, 16, 64,
                     "flash_attention backward bf16 d64", iters=5)
    _check_no_backward_fallback(records)
    _check_bsa_sparse_bwd(gen, records)
    main["rope_qk_backward"] = _check_rope_bwd(
        gen, records, (DIT_FRAMES // 4 + 1, HEIGHT // 16, WIDTH // 16), 40,
        128, 20, torch.bfloat16, "rope_qk backward")
    _check_rope_bwd(gen, records, (DIT_FRAMES // 4 + 1, HEIGHT // 16,
                                   WIDTH // 16), LC_HEADS, 128, 0,
                    torch.float32, "rope_qk backward longcat fp32 in")
    _check_rope_bwd(gen, records, (3, 3, 37), 12, 64, 0, torch.bfloat16,
                    "rope_qk backward ragged", b=2)
    main["modulated_layer_norm_backward"] = _check_mod_ln_bwd(
        gen, records, s, 5120, 20)
    # Wan2.1-1.3B's rows of 1,536 at 81 frames take the launch for D < 4096
    _check_mod_ln_bwd(gen, records, 21 * (HEIGHT // 16) * (WIDTH // 16), 1536,
                      20, "modulated_layer_norm backward d1536")
    return main


# ------------------------------------------------------------------ main


KERNEL_META = {
    "flash_attention": {
        "route": "cuda", "source": "worldforge_tpu_torch/csrc/flash_attention.cu",
        "replaces": "worldforge_tpu/ops/flash_attention.py:34"},
    "rope_qk": {
        "route": "triton", "source": "worldforge_tpu_torch/ops/_triton_kernels.py",
        "replaces": "worldforge_tpu/ops/rope.py:101"},
    "modulated_layer_norm": {
        "route": "triton", "source": "worldforge_tpu_torch/ops/_triton_kernels.py",
        "replaces": "worldforge_tpu/ops/fused_norm.py:24"},
    "conv3d_causal": {
        "route": "cuda", "source": "worldforge_tpu_torch/csrc/conv3d.cu",
        "replaces": "worldforge_tpu/ops/conv3d.py:39"},
    "conv2d_3x3": {
        "route": "cuda", "source": "worldforge_tpu_torch/csrc/conv3d.cu",
        "replaces": "worldforge_tpu/ops/conv3d.py:39",
        "note": "kernel 4 with one temporal tap: the Wan VAE decoder's "
                "3x3 resample convs and the SVD UNet's and VAE's stride-1 "
                "3x3 convs, XLA convs in the JAX package"},
    "bsa": {
        "route": "cuda", "source": "worldforge_tpu_torch/csrc/bsa.cu",
        "replaces": "worldforge_tpu/ops/bsa.py:100"},
    "flash_attention_backward": {
        "route": "cuda",
        "source": "worldforge_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "worldforge_tpu/ops/flash_attention.py:34",
        "note": "the gradient of kernel 1's function, which the JAX "
                "package's training takes by autodiff of "
                "ops/attention.py::attention (:40)"},
    "rope_qk_backward": {
        "route": "triton",
        "source": "worldforge_tpu_torch/ops/_triton_kernels.py",
        "replaces": "worldforge_tpu/ops/rope.py:101",
        "note": "rope_qk_kernel launched at -theta"},
    "modulated_layer_norm_backward": {
        "route": "triton",
        "source": "worldforge_tpu_torch/ops/_triton_kernels.py",
        "replaces": "worldforge_tpu/ops/fused_norm.py:24",
        "note": "mod_ln_bwd_kernel + colsum_kernel (both column sums in "
                "one launch)"},
}


def kernel_counters():
    from worldforge_tpu_torch.ops.bsa import bsa_bhsd
    from worldforge_tpu_torch.ops.conv3d import conv2d_3x3, conv3d_causal
    from worldforge_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward)
    from worldforge_tpu_torch.ops.fused_norm import (
        modulated_layer_norm, modulated_layer_norm_backward)
    from worldforge_tpu_torch.ops.rope import (apply_rope_qk,
                                               apply_rope_qk_backward)
    return {"flash_attention": flash_attention, "rope_qk": apply_rope_qk,
            "modulated_layer_norm": modulated_layer_norm,
            "conv3d_causal": conv3d_causal, "conv2d_3x3": conv2d_3x3,
            "bsa": bsa_bhsd,
            "flash_attention_backward": flash_attention_backward,
            "rope_qk_backward": apply_rope_qk_backward,
            "modulated_layer_norm_backward": modulated_layer_norm_backward}


WAN_PATH_KERNELS = ("flash_attention", "rope_qk", "modulated_layer_norm",
                    "conv3d_causal", "conv2d_3x3")
# the small refine returns latents (no decode, so no resample conv); the
# full refine decodes
REFINE_PATH_KERNELS = ("flash_attention", "rope_qk", "conv3d_causal", "bsa")
LONGCAT_GUIDED_PATH_KERNELS = ("flash_attention", "rope_qk",
                               "conv3d_causal", "conv2d_3x3")
# VGGT (DINO and aggregator attention, d 64; the camera trunk, d 128) and
# CLIP-H (d 80) attend through kernel 1; UMT5's attention is an fp32 einsum
WARP_PATH_KERNELS = ENCODER_PATH_KERNELS = ("flash_attention",)


def _require_launches(launches, names, phase):
    idle = [k for k in names if launches.get(k, 0) == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels not launched on the {phase} "
                         f"path: {idle}")


# kernel 4's one-tap rows at the SVD UNet's Cout-320 level, its 640 / 1280
# convs and its 16 x 26 and 8 x 13 levels: (row, its (Cin, Cout), index in
# ``DC_CONV2D``), each counted at its own shape
DC_CONV_ROWS = tuple(
    (f"conv2d_3x3 (svd unet {cin}->{cout}{level})", (cin, cout), i)
    for i, (cin, cout), level in (
        (0, (320, 320), ""), (1, (8, 320), ""), (2, (640, 320), ""),
        (3, (960, 320), ""), (4, (640, 640), ""), (10, (1280, 1280), ""),
        (13, (2560, 1280), " 16x26"), (14, (2560, 1280), " 8x13"),
        (15, (1280, 1280), " 8x13")))
# the SVD UNet's spatial attention at its second and third levels (the
# tokens / 4 and / 16, the heads x 2 and x 4)
DC_LEVEL_ROW = "flash_attention fp32 d64 (svd unet spatial level {})"
# the table's rows at the DepthCrafter stage's shapes: (row, wrapper, which
# keys of the wrapper's ``launches_by_shape`` the row counts). A row counts
# the launches at its own shape, in the runs that give it that shape: the
# 40-frame pipeline (the VAE's mid attention on chunks of 8 frames, the
# UNet's 320 -> 320 convs on 24-frame windows), the forward at the
# published 110-frame window (the UNet's first-level attention) and the
# 1024 x 1024 forward (kernel 1 on more than 65,535 B*H rows).
DC_ROWS = (
    ("flash_attention fp32 d512 (svd vae mid)", "flash_attention",
     lambda k: k == ("fp32 d512", DC_DECODE_CHUNK, DC_TOKENS, DC_TOKENS)),
    ("flash_attention fp32 d64 (svd unet spatial)", "flash_attention",
     lambda k: k == ("fp32 d64", DC_PUBLISHED_WINDOW * DC_HEADS, DC_TOKENS,
                     DC_TOKENS)),
    ("flash_attention fp32 d64 (svd unet temporal)", "flash_attention",
     lambda k: k == ("fp32 d64", DC_TOKENS * DC_HEADS, DC_PUBLISHED_WINDOW,
                     DC_PUBLISHED_WINDOW)),
    *((DC_LEVEL_ROW.format(lv), "flash_attention",
       lambda k, lv=lv: k == ("fp32 d64", DC_PUBLISHED_WINDOW * DC_HEADS
                              << (lv - 1), DC_TOKENS >> 2 * (lv - 1),
                              DC_TOKENS >> 2 * (lv - 1)))
      for lv in (2, 3)),
    ("flash_attention fp32 d64 (svd unet cross Sk=1)", "flash_attention",
     lambda k: k == ("fp32 d64", DC_PUBLISHED_WINDOW * DC_HEADS, DC_TOKENS,
                     1)),
    ("flash_attention fp32 d64 (B*H > 65535)", "flash_attention",
     lambda k: k[0] == "fp32 d64" and k[1] > 65535),
    *((row, "conv2d_3x3", lambda k, i=i: k == DC_CONV2D[i])
      for row, _, i in DC_CONV_ROWS),
)

# the table's rows at the Wan facades' and the avatar's new kernel-1
# shapes, counted at their own shape on the paths that give it
FLF2V_ROW = "flash_attention bf16 d128 (flf2v image cross-attn, 514 keys)"
AUDIO_ROW = "flash_attention bf16 d128 (avatar audio cross-attn, 32 keys)"
MULTITALK_ROW = ("flash_attention bf16 d128 (avatar multitalk audio "
                 "cross-attn, 64 keys)")
LC_TEXT_ROW = ("flash_attention bf16 d128 (longcat text cross-attn, 512 "
               "keys, kv_lens)")
FACADE_ROWS = (
    (FLF2V_ROW, "flash_attention",
     lambda k: k == ("bf16 d128", 40, FACADE_TOKENS, FLF2V_IMAGE_TOKENS)),
    (AUDIO_ROW, "flash_attention",
     lambda k: k == ("bf16 d128", AVATAR_NOISE_FRAMES * LC_HEADS,
                     LC_COND_TOKENS, AVATAR_AUDIO_TOKENS)),
    (MULTITALK_ROW, "flash_attention",
     lambda k: k[0] == "bf16 d128" and k[3] == 2 * AVATAR_AUDIO_TOKENS),
    (LC_TEXT_ROW, "flash_attention",
     lambda k: k[0] == "bf16 d128" and k[1] == LC_HEADS
     and k[3] == TEXT_LEN),
)
AVATAR_PATH_KERNELS = ("flash_attention", "rope_qk", "conv3d_causal",
                       "conv2d_3x3")
# the table's rows at the Wan DiT's cross-attentions and the Wan VAE's
# narrow convs, counted at their own keys and channels on every path
TEXT_ROW = "flash_attention bf16 d128 (wan text cross-attn, 512 keys)"
CLIP_ROW = "flash_attention bf16 d128 (wan clip cross-attn, 257 keys)"
CONV_IN_ROW = "conv3d_causal 3->96 (wan vae encoder conv_in)"
CONV_OUT_ROW = "conv3d_causal 96->3 (wan vae decoder conv_out)"
WAN_ROWS = (
    (TEXT_ROW, "flash_attention",
     lambda k: k[0] == "bf16 d128" and k[1] == 40 and k[3] == TEXT_LEN),
    (CLIP_ROW, "flash_attention",
     lambda k: k[0] == "bf16 d128" and k[1] == 40 and k[3] == 257),
    (CONV_IN_ROW, "conv3d_causal", lambda k: k[4:] == (3, 96)),
    (CONV_OUT_ROW, "conv3d_causal", lambda k: k[4:] == (96, 3)),
)


# the table's row at the sfm phase's global attention (kernel 1, fp32 d 64,
# 8 x 1,374 = 10,992 tokens), counted at its own shape
SFM_GLOBAL_ROW = (f"flash_attention fp32 d64 (vggt global attn, "
                  f"{SFM_FRAMES} x {SFM_TOKENS} tokens)")
SFM_FRAME_ROW = (f"flash_attention fp32 d64 (vggt frame attn, "
                 f"{SFM_FRAMES} frames of {SFM_TOKENS} tokens)")
SFM_ROWS = (
    (SFM_GLOBAL_ROW, "flash_attention",
     lambda k: k == ("fp32 d64", 16, SFM_FRAMES * SFM_TOKENS,
                     SFM_FRAMES * SFM_TOKENS)),
    (SFM_FRAME_ROW, "flash_attention",
     lambda k: k == ("fp32 d64", SFM_FRAMES * 16, SFM_TOKENS, SFM_TOKENS)),
)
# the fp32 rows of the Wan2.1 VAE's mid attention (the generate's decode,
# 5 latent frames at 480 x 832) and CLIP-H (16 heads of 80), counted at
# their own shapes on every path
WAN_VAE_ROW = "flash_attention fp32 d384 (wan vae mid, 5 x 6240)"
CLIP_H_ROW = "flash_attention fp32 d80 (clip-h, 257 tokens)"
F32_ROWS = (
    (WAN_VAE_ROW, "flash_attention",
     lambda k: k == ("fp32 d384", GEN_FRAMES // 4 + 1,
                     (HEIGHT // 8) * (WIDTH // 8),
                     (HEIGHT // 8) * (WIDTH // 8))),
    (CLIP_H_ROW, "flash_attention",
     lambda k: k == ("fp32 d80", 16, 257, 257)),
)
# kernel 1's instantiations: the kernel each runs
KERNEL1_INSTANTIATIONS = {
    "bf16 d64": "sm90::attn_sm90_kernel<64, DenseTiles> (wgmma, TMA; "
                "csrc/attention_sm90.cuh)",
    "bf16 d128": "up to 2,048 keys sm90short::attn_short_kernel<resident> "
                 "(persistent, wgmma, TMA; csrc/attention_short_sm90.cuh), "
                 "past it sm90::attn_sm90_kernel<128, DenseTiles> (wgmma, "
                 "TMA; csrc/attention_sm90.cuh)",
    "fp32 d64": "sm90f32::fa_f32_wgmma_kernel<64, V> (3xTF32 wgmma, TMA "
                "ring; V 0 long rows, 1 short; csrc/attention_f32_sm90.cuh)",
    **{f"fp32 d{d}": f"sm90f32::fa_f32_wgmma_kernel<{d}, 0> (3xTF32 "
                     f"wgmma, TMA ring; csrc/attention_f32_sm90.cuh)"
       for d in (80, 128)},
    **{f"fp32 d{d}": f"sm90f32w::fa_f32_scores_kernel<{d}> then "
                     f"sm90f32w::fa_f32_pv_kernel<{d}> (two passes a chunk "
                     f"of query tiles, 3xTF32 wgmma, TMA rings, scores in a "
                     f"scratch of at most 256 MiB; "
                     f"csrc/attention_f32_wide_sm90.cuh)" for d in (384, 512)},
}
SFM_PATH_KERNELS = ("flash_attention",)


class Launches(dict):
    """One run's launches by wrapper (kernel 1's also by instantiation, as
    ``"flash_attention fp32 d512"``); ``by_shape`` holds the wrappers'
    ``launches_by_shape``, {wrapper: {shape key: launches}}; ``passes``
    kernel 1's device launches by instantiation (two a chunk at fp32 d 384
    / 512, else one a call)."""

    by_shape: dict
    passes: dict


def _reset_counters():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape = {}
    counters["flash_attention"].launches_by_instantiation = {}
    counters["flash_attention"].passes_by_instantiation = {}


def _read_counters():
    counters = kernel_counters()
    out = Launches((name, fn.launches) for name, fn in counters.items())
    for inst, n in counters["flash_attention"].launches_by_instantiation.items():
        out[f"flash_attention {inst}"] = n
    out.by_shape = {name: dict(fn.launches_by_shape)
                    for name, fn in counters.items()
                    if hasattr(fn, "launches_by_shape")}
    out.passes = dict(counters["flash_attention"].passes_by_instantiation)
    return out


def _shape_counts(launches):
    """``launches.by_shape`` with string keys, for a JSON line."""
    return {name: {" ".join(map(str, k)): n for k, n in shapes.items()}
            for name, shapes in launches.by_shape.items()}


def _flf_latents(seed=21):
    """pred / ref latents at the 480p 49-frame shape: per channel a smooth
    pattern drifting over the frames plus noise; pred mixes in a shifted
    copy of ref by a channel-dependent amount, so the channels' flows
    agree with the reference to different degrees."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b, c, t, h, w = FLF_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ref = np.empty(FLF_SHAPE, np.float32)
    for ch in range(c):
        fx, fy = rng.uniform(5.0, 15.0, 2)
        ph = rng.uniform(0.0, 6.3)
        for i in range(t):
            ref[0, ch, i] = (np.sin((xx + 1.5 * i) / fx + ph)
                             * np.cos((yy - 0.5 * i) / fy))
    ref += 0.1 * rng.standard_normal(FLF_SHAPE).astype(np.float32)
    amount = np.linspace(0.0, 1.0, c, dtype=np.float32)[None, :, None, None,
                                                         None]
    pred = (ref + amount * np.roll(ref, (1, 2), axis=(2, 4))
            + 0.2 * rng.standard_normal(FLF_SHAPE).astype(np.float32))
    return pred.astype(np.float32), ref


def _median_ms(fn, n=5):
    """Median host-clock time of ``fn`` (which ends in a synchronize or a
    host copy) over ``n`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def phase_flf():
    """FLF channel selection on the card against the CPU at the 480p
    49-frame latent shape [1, 16, 13, 60, 104]: 2 x 16 x 12 = 384 Farneback
    pairs of 60 x 104 (one pyramid level). Flows, the scores of both
    variants with optical flow on and off, and the selected sets of both
    schedules (Wan steps 2-20; LongCat distill and standard, max_replace
    None and 2) must agree: scores within 1e-4, sets equal."""
    from worldforge_tpu_torch.ops.farneback import _pyramid_plan
    from worldforge_tpu_torch.ops.flow import video_channel_flows_pair
    from worldforge_tpu_torch.sampling.channel_select import (
        channel_similarities, select_channels_longcat, select_channels_wan)
    pred, ref = _flf_latents()
    inputs = {"cpu": (torch.from_numpy(pred), torch.from_numpy(ref))}
    inputs["cuda"] = tuple(x.cuda() for x in inputs["cpu"])
    flows = {d: video_channel_flows_pair(*inputs[d]) for d in inputs}
    flow_err = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(flows["cuda"], flows["cpu"]))
    flow_max = max(float(b.abs().max()) for b in flows["cpu"])
    scores, score_err = {}, {}
    for variant in ("wan", "longcat"):
        for use_flow in (True, False):
            by_dev = {d: channel_similarities(*inputs[d], use_flow, variant)
                      for d in inputs}
            scores[(variant, use_flow)] = by_dev
            score_err[f"{variant} flow={use_flow}"] = float(
                abs(by_dev["cuda"] - by_dev["cpu"]).max())
    sets, equal = {}, True
    steps = range(2, 21)
    wan = scores[("wan", True)]
    sets["wan"] = {d: [select_channels_wan(wan[d], i) for i in steps]
                   for d in wan}
    lc = scores[("longcat", True)]
    for distill in (True, False):
        for mr in (None, 2):
            key = (f"longcat {'distill' if distill else 'standard'} "
                   f"max_replace={mr}")
            sets[key] = {d: [select_channels_longcat(lc[d], i, distill, mr)
                             for i in steps] for d in lc}
    for v in sets.values():
        equal = equal and v["cuda"] == v["cpu"]
    card = inputs["cuda"]

    def flows_synced():
        video_channel_flows_pair(*card)
        torch.cuda.synchronize()

    sim_ms = _median_ms(lambda: channel_similarities(*card))
    flows_ms = _median_ms(flows_synced)
    ok = max(score_err.values()) <= 1e-4 and equal
    emit({"phase": "flf", "shape": list(FLF_SHAPE),
          "farneback_pairs": 2 * 16 * (FLF_SHAPE[2] - 1),
          "pyramid_levels": len(_pyramid_plan(FLF_SHAPE[3], FLF_SHAPE[4],
                                              0.5, 3)),
          "max_flow_diff_px": flow_err, "max_abs_flow_px": flow_max,
          "max_score_diff": score_err, "tol_score": 1e-4,
          "scores_card_wan": [round(float(x), 6) for x in wan["cuda"]],
          "selected_steps_2_20_card": {k: v["cuda"] for k, v in sets.items()},
          "sets_equal": equal,
          "channel_similarities_ms_median": sim_ms,
          "video_channel_flows_pair_ms_median": flows_ms,
          "timing": "host clock, median of 5 after a warm-up; the scores' "
                    "host copy included", "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: FLF on the card disagrees with the CPU")


def phase_vae(card):
    """Where the VAE's time goes, under ``torch.profiler`` (the vae_profile
    lines): one single-pass Wan2.1 VAE decode + encode at the generate
    phase's shape (5 x 60 x 104 latents <-> 17 x 480 x 832), and one
    streaming decode at the refine's (16 x 88 x 160 latents -> 61 x 704 x
    1280). Random fp32 weights from a seed, as the pipelines load them;
    kernel 4's launches per run are counted beside the split. Then the
    single-pass encode's resample routes (``_encode_resample_routes``)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae,
                                                     vae_decode, vae_encode)
    from worldforge_tpu_torch.models.wan.vae_stream import \
        vae_decode_streaming
    from worldforge_tpu_torch.ops.conv3d import conv3d_causal
    cfg = WanVAEConfig.wan_2_1()
    params = init_wan_vae(P.make_generator(0, "cuda"), cfg)
    gen = torch.Generator(device="cuda").manual_seed(6)
    z = torch.randn((1, cfg.z_dim, GEN_FRAMES // 4 + 1, HEIGHT // 8,
                     WIDTH // 8), generator=gen, device="cuda")

    def single_pass():
        return vae_encode(params, cfg, vae_decode(params, cfg, z))

    zr = torch.randn((1, cfg.z_dim, REFINE_GRID[0], REFINE_H // 8,
                      REFINE_W // 8), generator=gen, device="cuda")
    runs = (
        (single_pass, None, "one single-pass Wan2.1 VAE decode + encode "
         "at 17x480x832", list(z.shape)),
        (lambda: vae_decode_streaming(params, cfg, zr),
         lambda: vae_decode_streaming(params, cfg, zr[:, :, :2]),
         "the refine's streaming Wan2.1 VAE decode at 704x1280",
         list(zr.shape)),
    )
    for forward, warmup, what, shape in runs:
        count = {}

        def counted(fn=forward, count=count):
            before = conv3d_causal.launches
            fn()
            count["launches"] = conv3d_causal.launches - before

        _profile_forward(counted, "vae_profile", what + " under "
                         "torch.profiler", {"latents": shape}, warmup=warmup)
        emit({"phase": "vae_launches", "what": what,
              "conv3d_causal_launches_per_run": count["launches"]})
    _conv2d_workspace()
    _encode_resample_routes(params, cfg, z, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _encode_resample_routes(params, cfg, z, card):
    """The single-pass encode of 17 x 480 x 832 frames (the decode of
    ``z``) with the encoder's three 3x3 stride-2 resample convs on kernel
    4's one tap (``vae._conv2d``'s route on the card:
    ``vae._conv2d_s2_one_tap``) and, beside it, on cuDNN with bf16 operands
    (``vae._xla_conv``, the route they took before): a warm-up of each,
    then each route's seconds in turns (one tap, cuDNN, cuDNN, one tap),
    its peak above what was allocated before and kernel 4's one-tap
    launches; the two encodes' relative L2 difference within
    STRIP_SMALL_TOL (the same exact products summed in other orders, grown
    by the later convs' bf16 roundings)."""
    from worldforge_tpu_torch.models.wan import vae
    from worldforge_tpu_torch.ops.conv3d import conv2d_3x3
    one_tap = vae._conv2d

    def cudnn(p, x, *, stride=1, padding=0):
        if stride == 2:
            return vae._xla_conv(p, x, stride=stride, padding=padding)
        return one_tap(p, x, stride=stride, padding=padding)

    routes = {"kernel 4 one tap": one_tap,
              "cuDNN, bf16 operands (before)": cudnn}
    rows = {name: {"route": name, "s": [], "peak_above_start_gb": []}
            for name in routes}
    video = vae.vae_decode(params, cfg, z)
    outs = {}
    try:
        for i, name in enumerate((*routes, *routes, *reversed(routes))):
            vae._conv2d = routes[name]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = conv2d_3x3.launches
            t0 = time.perf_counter()
            out = vae.vae_encode(params, cfg, video)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i < len(routes):
                outs[name] = out
                continue
            rows[name]["s"].append(dt)
            rows[name]["peak_above_start_gb"].append(
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
            rows[name]["one_tap_launches"] = conv2d_3x3.launches - before
            del out
    finally:
        vae._conv2d = one_tap
    got, ref = outs.values()
    rec = {"phase": "vae_encode_resample_route", "card": card,
           "what": "single-pass Wan2.1 VAE encode, fp32, the encoder's "
                   "stride-2 resample convs on two routes",
           "video": list(video.shape), "latents": list(got.shape),
           "rows": list(rows.values()), "rel_max": _rel_max(got, ref),
           "rel_l2": _rel_l2(got, ref), "gate_rel_l2": STRIP_SMALL_TOL}
    rec["ok"] = bool(torch.isfinite(got).all()) and (
        rec["rel_l2"] <= STRIP_SMALL_TOL)
    emit(rec)
    del video, outs, got, ref
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the encode's one-tap resample route "
                         "differs from cuDNN's")


def _conv2d_workspace():
    """The decoder's first spatial resample conv (3x3, 384 -> 192) on 2
    frames at the 480p and the refine's 704x1280 shapes, through the VAE's
    route (``vae._conv2d``: kernel 4 with one tap on the card) and, beside
    it, the fp32 cuDNN route the port took before (TF32 off): the time and
    the device memory allocated in the call beyond its output (cuDNN's
    workspace)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan import vae
    gen = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn((3, 3, 384, 192), generator=gen, device="cuda") * 0.02
    routes = (("kernel 4 one tap (vae._conv2d)",
               lambda x: vae._conv2d({"w": w}, x, padding=1)),
              ("fp32 cuDNN, TF32 off (before)",
               lambda x: P.conv({"w": w}, x, padding=1)))
    rows = []
    for h, wd in ((120, 208), (176, 320)):
        x = torch.randn((2, h, wd, 384), generator=gen, device="cuda")
        for route, fn in routes:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = fn(x)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base - nbytes(y)
            rows.append({"route": route, "x": list(x.shape),
                         "w": list(w.shape), "extra_gb": extra / 2 ** 30,
                         "ms": cuda_ms(lambda: fn(x), 3)})
            del y
        del x
    torch.cuda.empty_cache()
    emit({"phase": "vae_conv2d_workspace", "what": "the decoder's 3x3 "
          "384->192 resample conv, 2 frames: time and device memory "
          "allocated in the call beyond its output", "rows": rows})
    # the fp32 route as the pipelines met it, with the DiT's weights held
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    child = ctx.Process(target=_fp32_route_decode, args=(queue, 30))
    child.start()
    rec = queue.get(timeout=600)
    child.join(timeout=60)
    emit({"phase": "vae_fp32_route_memory_held", "what": "the fp32 cuDNN "
          "route's 49-frame 480p streaming decode in a fresh process with "
          "30 GiB held", **rec})
    now = [r for r in rows if r["route"].startswith("kernel 4")]
    if max(r["extra_gb"] for r in now) > 2.0:
        raise SystemExit("chip_smoke: the VAE's resample conv allocates "
                         "more than 2 GB beyond its output")


def _fp32_route_decode(queue, hold_gib):
    """In a fresh process (its own cuDNN plan cache): hold ``hold_gib`` of
    device memory, as the 13.6B DiT's weights are held in the LongCat
    pipeline, and stream-decode 13 x 60 x 104 latents to 49 x 480 x 832
    with the VAE's convs on the fp32 cuDNN route the port took before;
    report the time of each 384 -> 192 resample conv at 120 x 208 and the
    peak."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan import vae, vae_stream
    calls = []

    def fp32_conv(p, x, *, stride=1, padding=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = P.conv(p, x, stride=stride, padding=padding)
        torch.cuda.synchronize()
        if tuple(x.shape[1:]) == (HEIGHT // 4, WIDTH // 4, 384):
            calls.append([x.shape[0], (time.perf_counter() - t0) * 1e3])
        return y

    vae._conv2d = vae_stream._conv2d = fp32_conv
    vae._xla_conv = lambda p, x, *, stride, padding: P.conv(
        p, x, stride=stride, padding=padding)
    cfg = vae.WanVAEConfig.wan_2_1()
    params = vae.init_wan_vae(P.make_generator(0, "cuda"), cfg)
    z = torch.randn((1, 16, DIT_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    held = torch.empty(int(hold_gib * 2 ** 30), dtype=torch.uint8,
                       device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vae_stream.vae_decode_streaming(params, cfg, z)
    torch.cuda.synchronize()
    queue.put({"held_gib": hold_gib, "decode_s": time.perf_counter() - t0,
               "resample_conv_calls_frames_ms": calls,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del held


def phase_dit():
    """One full-width, full-depth Wan2.1-I2V-14B DiT forward at 20,280
    tokens (random weights from a seed; CFG's two forwards are one call
    each, so one call is half a denoise step's DiT work)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     init_wan_dit,
                                                     wan_dit_forward)
    cfg = WanDiTConfig.wan_14b_i2v()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_wan_dit(P.make_generator(0, "cuda"), cfg)
    head = params["head"]["head"]
    head["w"] = (0.02 * P.normal(P.make_generator(99, "cuda"),
                                 tuple(head["w"].shape))).to(head["w"].dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    t_lat, h_lat, w_lat = DIT_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8
    x = torch.randn((1, 16, t_lat, h_lat, w_lat), generator=gen,
                    device="cuda")
    y = torch.randn((1, 20, t_lat, h_lat, w_lat), generator=gen,
                    device="cuda")
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device="cuda")
    clip = torch.randn((1, 257, cfg.clip_dim), generator=gen, device="cuda")
    t = torch.tensor([999.0], device="cuda")
    times = []
    _reset_counters()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        out = wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip, y=y)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    counts = _read_counters()
    finite = bool(torch.isfinite(out).all())
    emit({"phase": "dit", "config": "wan_14b_i2v", "layers": cfg.num_layers,
          "dim": cfg.dim, "heads": cfg.num_heads, "tokens":
          t_lat * (h_lat // 2) * (w_lat // 2), "frames": DIT_FRAMES,
          "height": HEIGHT, "width": WIDTH, "init_s": init_s,
          "forward_s": times, "launches_per_forward":
          {k: v // 2 for k, v in counts.items()},
          "out_shape": list(out.shape), "finite": finite,
          "max_memory_allocated_gb":
          torch.cuda.max_memory_allocated() / 2 ** 30})
    if not finite or tuple(out.shape) != (1, 16, t_lat, h_lat, w_lat):
        raise SystemExit("chip_smoke: DiT forward output is wrong")
    _dit_token_chunk(params, cfg, (x, t, ctx, clip, y), out)
    del out
    launches = _parallel_nccl_forward(
        "nccl_wan_i2v_14b", "one Wan2.1-I2V-14B forward at 20,280 tokens "
        "under make_mesh(1, 1, 1, device='cuda') (NCCL) against the "
        "mesh-free forward",
        lambda mesh: wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip,
                                     y=y, mesh=mesh),
        ("flash_attention", "rope_qk", "modulated_layer_norm"))
    _profile_forward(
        lambda: wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip, y=y),
        "dit_profile", "one Wan2.1-I2V-14B DiT forward at 20,280 tokens under "
        "torch.profiler", {"tokens": t_lat * (h_lat // 2) * (w_lat // 2)})
    streaming = runtime_streaming(params, cfg, (x, t, ctx, clip, y))
    del params
    torch.cuda.empty_cache()
    return launches, streaming


def _rel_max(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _small_vggt_check():
    """``VGGTConfig.tiny()`` widened to 128 (heads of 64, the camera
    trunk's of 128: head dims kernel 1 takes in fp32), weights drawn on the
    CPU and copied to the card, on 2 frames of 28 x 56: ``vggt_forward``
    with kernel 1 on the card against its plain version on the CPU, fp32,
    to 1e-4 of the largest |output|."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.vggt.inference import (init_vggt_full,
                                                            vggt_forward)
    from worldforge_tpu_torch.models.vggt.model import VGGTConfig
    tiny = VGGTConfig.tiny()
    cfg = dataclasses.replace(tiny, embed_dim=128,
                              backbone=dataclasses.replace(tiny.backbone,
                                                           embed_dim=128))
    params = init_vggt_full(P.make_generator(5), cfg)
    images = torch.from_numpy(np.random.default_rng(5).random(
        (1, 2, 3, 28, 56)).astype(np.float32))
    _reset_counters()
    card = vggt_forward(P.tree_map(lambda t: t.cuda(), params), cfg,
                        images.cuda())
    launches = _read_counters()
    cpu = vggt_forward(params, cfg, images)
    errs = {k: _rel_max(card[k], cpu[k]) for k in cpu}
    ok = max(errs.values()) <= 1e-4 and all(
        bool(torch.isfinite(v).all()) for v in card.values())
    emit({"phase": "vggt_small_vs_cpu", "config": "VGGTConfig.tiny(), "
          "embed_dim 128 (DINO too)",
          "images": list(images.shape), "max_rel_err": errs, "tol": 1e-4,
          "launches_on_card": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small VGGT disagrees with the CPU")
    _require_launches(launches, WARP_PATH_KERNELS, "small VGGT")


def _warp_image(path):
    """A synthetic 518 x 294 photo stand-in: a lit ground plane, a sky
    gradient and a few textured boxes, as uint8 PNG."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:WARP_H, 0:WARP_W].astype(np.float32)
    img = np.empty((WARP_H, WARP_W, 3), np.float32)
    sky = yy < 0.4 * WARP_H
    img[..., 0] = np.where(sky, 0.5 + 0.3 * yy / WARP_H,
                           0.35 + 0.2 * np.sin(xx / 17.0) * np.cos(yy / 11.0))
    img[..., 1] = np.where(sky, 0.6 + 0.2 * yy / WARP_H, 0.45)
    img[..., 2] = np.where(sky, 0.9, 0.3 + 0.1 * np.sin(xx / 7.0))
    for x0, y0, bw, bh in ((60, 100, 80, 120), (250, 140, 60, 90),
                           (380, 90, 100, 160)):
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(0.1, 0.9, 3)
        img[y0:y0 + bh:6, x0:x0 + bw] *= 0.6
    img += 0.02 * rng.standard_normal(img.shape)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def _read_warp_dir(warp_dir):
    from worldforge_tpu_torch.io.frames import read_frames_from_directory
    frames, masks, _ = read_frames_from_directory(
        os.path.join(warp_dir, "warped_images"))
    return frames, masks


def phase_warp(work_dir):
    """The VGGT warp through the user's entry points: VGGT-1B at full
    width and depth (random fp32 weights from a seed) on a 518 x 294 image
    (``load_and_preprocess_images`` -> ``vggt_forward`` ->
    ``pose_encoding_to_extri_intri``, by ``depth_and_camera``), its depth,
    confidence and cameras saved as an npz, then ``cli/run_warp.main``
    with ``--depth_npz`` writing 17 frames and masks. The same npz warped
    on the CPU must give the same masks. Returns the directory of the warp
    that feeds the generate phase and the path's kernel launches."""

    import numpy as np
    from worldforge_tpu_torch.cli import run_warp
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.vggt.inference import (depth_and_camera,
                                                            init_vggt_full)
    from worldforge_tpu_torch.models.vggt.model import VGGTConfig
    from worldforge_tpu_torch.models.vggt.utils import \
        load_and_preprocess_images
    from worldforge_tpu_torch.warp import vggt_warp

    _small_vggt_check()
    os.makedirs(work_dir, exist_ok=True)
    image = os.path.join(work_dir, "image.png")
    _warp_image(image)
    cfg = VGGTConfig.vggt_1b()
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_vggt_full(P.make_generator(12, "cuda"), cfg)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    images = load_and_preprocess_images([image])
    t0 = time.time()
    depth, conf, extrinsic, intrinsic = depth_and_camera(params, cfg, images)
    vggt_s = time.time() - t0
    vggt_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vggt = {"depth": depth, "conf": conf, "extrinsic": extrinsic,
            "intrinsic": intrinsic}
    runs = []
    # the npz as VGGT gives it, and without its intrinsic: random weights
    # can give a field of view near 0 (a ReLU), a focal length in the
    # millions of pixels that moves every point out of frame, so the warp
    # also runs on the CLI's own focal (0.7 max(H, W)); that run's frames
    # feed the generate phase
    for name, keys in (("vggt cameras", ("depth", "conf", "extrinsic",
                                         "intrinsic")),
                       ("vggt depth, CLI focal", ("depth", "conf",
                                                  "extrinsic"))):
        npz = os.path.join(work_dir, f"vggt_{len(runs)}.npz")
        np.savez(npz, **{k: vggt[k] for k in keys})
        argv = ["--image_path", image, "--depth_npz", npz, "--frame_single",
                str(GEN_FRAMES), "--direction", WARP_DIRECTION, "--degree",
                str(WARP_DEGREE)]
        out = os.path.join(work_dir, f"card_{len(runs)}")
        with timed_calls(vggt_warp, "splat_trajectory", []) as splat, \
                timed_calls(run_warp, "warp_single_image", []) as whole:
            t0 = time.time()
            run_warp.main(argv + ["--output_path", out])
            cli_s = time.time() - t0
        out_cpu = os.path.join(work_dir, f"cpu_{len(runs)}")
        run_warp.main(argv + ["--output_path", out_cpu, "--device", "cpu"])
        frames, masks = _read_warp_dir(out)
        frames_cpu, masks_cpu = _read_warp_dir(out_cpu)
        runs.append({
            "npz": name, "out": out, "frames": len(frames),
            "frame_shape": list(frames[0].shape), "cli_s": cli_s,
            "warp_s": whole[0]["s"], "device_splat_s": splat[0]["s"],
            "host_crack_fill_s": whole[0]["s"] - splat[0]["s"],
            "mask_coverage": [round(float(m.mean()), 4) for m in masks],
            "card_vs_cpu_mask_px_differing": int(sum(
                (a != b).sum() for a, b in zip(masks, masks_cpu))),
            "card_vs_cpu_frame_px_differing": int(sum(
                (a != b).any(-1).sum() for a, b in zip(frames, frames_cpu)))})
    launches = _read_counters()
    _profile_forward(lambda: depth_and_camera(params, cfg, images),
                     "vggt_profile", "VGGT-1B depth_and_camera on one "
                     "518x294 image under torch.profiler (after a warm-up "
                     "call)", {"image": [WARP_H, WARP_W]})
    full_tree = _warp_full_tree(params, cfg, images)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ok = (all(r["frames"] == GEN_FRAMES and r["card_vs_cpu_mask_px_"
              "differing"] == 0 and r["frame_shape"] == [WARP_H, WARP_W, 3]
              for r in runs)
          and bool(np.isfinite(depth).all() and np.isfinite(conf).all())
          and full_tree["bit_equal"])
    emit({"phase": "warp", "config": "vggt_1b (DINOv2-L/14 + 24 dual "
          "blocks + camera and DPT heads), fp32",
          "params": n_params, "image": [WARP_H, WARP_W],
          "tokens_per_frame": VGGT_TOKENS, "vggt_init_s": init_s,
          "vggt_first_call_s": vggt_s, "vggt_peak_gb": vggt_peak,
          "depth_range": [float(depth.min()), float(depth.max())],
          "conf_range": [float(conf.min()), float(conf.max())],
          "focal_px": [float(intrinsic[0, 0]), float(intrinsic[1, 1])],
          "direction": WARP_DIRECTION, "degree": WARP_DEGREE,
          "runs": [{k: v for k, v in r.items() if k != "out"}
                   for r in runs], "full_tree": full_tree,
          "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: the warp is wrong or differs from "
                         "the CPU")
    _require_launches(launches, WARP_PATH_KERNELS, "warp")
    return runs[-1]["out"], launches


def _warp_full_tree(params, cfg, images):
    """The warp's VGGT stage on a tree that also holds the world-point and
    track heads, as a converted facebook/VGGT-1B checkpoint does:
    ``depth_and_camera`` must give the lean tree's outputs bit for bit and
    take its time, since it runs neither head. ``vggt_forward`` on the
    full tree runs the point head too: its time is what the warp would
    pay if it did. Medians of 3 calls after a warm-up each."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.vggt.inference import (depth_and_camera,
                                                            init_vggt_full,
                                                            vggt_forward)
    heads = init_vggt_full(P.make_generator(13, "cuda"), cfg,
                           enable_point=True, enable_track=True)
    full = dict(params, point_head=heads["point_head"],
                track_head=heads["track_head"])
    im = torch.as_tensor(images, device="cuda")[None]

    def median_s(fn):
        fn()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            ts.append(time.time() - t0)
        return sorted(ts)[1]

    lean_out = depth_and_camera(params, cfg, images)
    full_out = depth_and_camera(full, cfg, images)
    rec = {"bit_equal": all(bool((a == b).all())
                            for a, b in zip(lean_out, full_out)),
           "depth_and_camera_lean_s": median_s(
               lambda: depth_and_camera(params, cfg, images)),
           "depth_and_camera_full_tree_s": median_s(
               lambda: depth_and_camera(full, cfg, images)),
           "vggt_forward_full_tree_s": median_s(
               lambda: vggt_forward(full, cfg, im))}
    del full, heads
    return rec


def _sfm_video(n, size, seed=8):
    """``n`` square frames of a synthetic scene under a camera pan: a
    textured ground, a sky gradient and boxes, each frame a crop shifted
    by 24 pixels, [n, size, size, 3] float32 in [0, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wide = size + 24 * (n - 1)
    yy, xx = np.mgrid[0:size, 0:wide].astype(np.float32)
    img = np.empty((size, wide, 3), np.float32)
    sky = yy < 0.35 * size
    img[..., 0] = np.where(sky, 0.5 + 0.3 * yy / size,
                           0.35 + 0.2 * np.sin(xx / 13.0) * np.cos(yy / 9.0))
    img[..., 1] = np.where(sky, 0.6 + 0.2 * yy / size,
                           0.45 + 0.1 * np.cos(xx / 7.0 + yy / 5.0))
    img[..., 2] = np.where(sky, 0.9, 0.3 + 0.1 * np.sin(xx / 5.0))
    for _ in range(14):
        x0, y0 = rng.integers(0, wide - 90), rng.integers(0, size - 120)
        bw, bh = rng.integers(30, 90), rng.integers(40, 120)
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(0.1, 0.9, 3)
        img[y0:y0 + bh:5, x0:x0 + bw] *= 0.6
        img[y0:y0 + bh, x0:x0 + bw:7] *= 0.8
    img += 0.02 * rng.standard_normal(img.shape)
    img = np.clip(img, 0.0, 1.0)
    return np.stack([img[:, 24 * i:24 * i + size] for i in range(n)])


def _damped_tracker(params, f=0.01):
    """The tracker tree with the (dx, dy) columns of both flow heads scaled
    by ``f`` (a copy): each refinement then moves a track by a fraction of a
    pixel, as a trained tracker's late refinements do. With the random
    init's full-scale heads a rounding difference grows ~400 times per
    coarse refinement, so a card-against-CPU gate on tracks would measure
    only that growth (tests/test_torch_sfm.py shows it on the CPU)."""
    from worldforge_tpu_torch.core import params as P
    out = P.tree_map(lambda t: t.clone(), params)
    for k in ("coarse_predictor", "fine_predictor"):
        fh = out[k]["updateformer"]["flow_head"]
        fh["w"][:, :2] *= f
        fh["b"][:2] *= f
    return out


def _small_sfm_checks(card):
    """The sfm phase's part (a): weights drawn on the CPU and copied to the
    card; each run on the card against the same run on the CPU, fp32.
    ``vggt_forward`` with query points on VGGTConfig.tiny() widened to 128
    (heads of 64), with the world-point head and a TrackHeadConfig.tiny()
    track head at the trunk's width; ALIKEDConfig.tiny() on two 96 x 128 images; the
    published-width VGGSfM tracker through ``predict_tracks`` on 3 frames
    of 128 x 128 with a 4 x 4 grid extractor, the fine refinement, no
    augmentation, the coordinate heads damped (``_damped_tracker``)."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.vggt import inference
    from worldforge_tpu_torch.models.vggt.model import VGGTConfig
    from worldforge_tpu_torch.models.vggt.track import (TrackHeadConfig,
                                                        init_track_head)
    from worldforge_tpu_torch.sfm.aliked import (ALIKEDConfig, aliked_forward,
                                                 init_aliked)
    from worldforge_tpu_torch.sfm.track_predict import predict_tracks
    from worldforge_tpu_torch.sfm.tracker import init_sfm_tracker

    def to_card(tree):
        return P.tree_map(lambda t: t.cuda(), tree)

    recs = []
    tiny = VGGTConfig.tiny()
    cfg = dataclasses.replace(tiny, embed_dim=128,
                              backbone=dataclasses.replace(tiny.backbone,
                                                           embed_dim=128))
    gen = P.make_generator(31)
    params = inference.init_vggt_full(gen, cfg, enable_point=True)
    tcfg = dataclasses.replace(TrackHeadConfig.tiny(),
                               dim_in=2 * cfg.embed_dim)
    params["track_head"] = init_track_head(gen, tcfg)
    rng = np.random.default_rng(31)
    images = torch.from_numpy(rng.random((1, 2, 3, 56, 84)).astype(
        np.float32))
    qp = torch.tensor([[[10.0, 12.0], [40.5, 30.25], [70.0, 50.0]]])

    # vggt_forward, the users' entry point, with its track head config
    # set to the tiny one for this check
    published = inference.track_head_config
    inference.track_head_config = lambda c: tcfg
    try:
        with P.no_tf32_matmul():
            got = inference.vggt_forward(to_card(params), cfg,
                                         images.cuda(), qp.cuda())
        want = inference.vggt_forward(params, cfg, images, qp)
    finally:
        inference.track_head_config = published
    assert sorted(want) == sorted(
        ["pose_enc", "depth", "depth_conf", "world_points",
         "world_points_conf", "track", "vis", "track_conf"]), sorted(want)
    errs = {k: _rel_max(got[k], want[k]) for k in want}
    recs.append({"part": "vggt_point_track_small_vs_cpu",
                 "config": "VGGTConfig.tiny() embed_dim 128 + point head; "
                           "TrackHeadConfig.tiny() at dim_in 256",
                 "images": list(images.shape), "queries": qp.shape[1],
                 "max_rel_err": errs, "tol": 1e-4,
                 "ok": max(errs.values()) <= 1e-4 and all(
                     bool(torch.isfinite(v).all()) for v in got.values())})

    acfg = ALIKEDConfig.tiny()
    ap = init_aliked(P.make_generator(32), acfg)
    img = torch.from_numpy(rng.random((2, 96, 128, 3)).astype(np.float32))
    with P.no_tf32_matmul():
        got = aliked_forward(to_card(ap), acfg, img.cuda())
    want = aliked_forward(ap, acfg, img)
    rec = {"part": "aliked_small_vs_cpu", "config": "ALIKEDConfig.tiny()",
           "images": list(img.shape), "tol": 1e-4}
    counts, errs = [], {"keypoints": 0.0, "scores": 0.0, "descriptors": 0.0}
    ok = True
    for b in range(img.shape[0]):
        gs, ws = got["scores"][b].cpu(), want["scores"][b]
        gv, wv = gs > 0, ws > 0
        counts.append([int(gv.sum()), int(wv.sum())])
        if int(gv.sum()) != int(wv.sum()):
            ok = False
            continue
        go = torch.argsort(-gs[gv], stable=True)
        wo = torch.argsort(-ws[wv], stable=True)
        for key in errs:
            g = got[key][b].cpu()[gv][go]
            w = want[key][b][wv][wo]
            errs[key] = max(errs[key], _rel_max(g, w))
    rec.update(valid_keypoints_card_cpu=counts, max_rel_err=errs,
               ok=ok and max(errs.values()) <= 1e-4)
    recs.append(rec)

    tracker = _damped_tracker(init_sfm_tracker(P.make_generator(33)))
    frames = _sfm_video(3, 128, seed=33)

    def grid(im):
        n, h = 4, im.shape[0]
        c = (np.arange(n) + 0.5) * h / n + 0.3
        ys, xs = np.meshgrid(c, c - 0.5, indexing="ij")
        return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)

    kw = dict(extract_fn=grid, fine_tracking=True, complete_non_vis=False)
    with P.no_tf32_matmul():
        got = predict_tracks(to_card(tracker), frames, **kw)
    want = predict_tracks(tracker, frames, device="cpu", **kw)
    tr_err = float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max())
    vis_err = float(np.abs(got[1] - want[1]).max())
    recs.append({"part": "sfm_tracker_small_vs_cpu",
                 "config": "init_sfm_tracker (published coarse + fine "
                           "widths), coordinate heads damped 0.01",
                 "frames": list(frames.shape), "query_frames": 3,
                 "queries_per_frame": 16, "coarse_iters": 6,
                 "fine_tracking": True, "tracks_shape": list(got[0].shape),
                 "tracks_max_rel_err": tr_err, "tracks_tol": 1e-4,
                 "vis_max_abs_err": vis_err, "vis_tol": 1e-3,
                 "colors_equal": bool(np.array_equal(got[4], want[4])),
                 "ok": (got[0].shape == want[0].shape and tr_err <= 1e-4
                        and vis_err <= 1e-3
                        and bool(np.array_equal(got[4], want[4]))
                        and bool(np.isfinite(got[0]).all()))})
    for rec in recs:
        emit({"phase": "sfm", "card": card, **rec})
    bad = [r["part"] for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: sfm small runs disagree with the "
                         f"CPU: {bad}")


def phase_sfm(work_dir, card):
    """VGGT tracking and SfM through the user's entry points on 8 square
    frames of 518 x 518: VGGT-1B fp32 (random weights from a seed) with the
    world-point and track heads, its track head on the first 1,024 of
    ALIKED-N16's keypoints on frame 0; ``predict_tracks`` with the VGGSfM
    tracker (published coarse and fine configs, random weights) and
    ``combined_extract_fn(make_extractors("aliked+sp", 4096))``, the final
    trial on ``aliked+sp+sift`` at 2,048, JAX's defaults (5 query frames,
    6 coarse refinements, the fine refinement, the non-visible-frame
    loop), VGGT's world points and confidence as ``points_3d`` / ``conf``;
    then ``build_reconstruction(masks=vis > 0.2)`` and ``write_text``.
    Cut: no ``max_reproj_error`` (at random init no track reprojects).
    Before it, the small runs on the card against the CPU. Returns the
    path's launches (counted from the VGGT forward to the export)."""
    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.vggt import inference
    from worldforge_tpu_torch.models.vggt.model import VGGTConfig
    from worldforge_tpu_torch.models.vggt.utils import \
        pose_encoding_to_extri_intri
    from worldforge_tpu_torch.sfm import track_predict
    from worldforge_tpu_torch.sfm.colmap_export import build_reconstruction
    from worldforge_tpu_torch.sfm.extractors import (combined_extract_fn,
                                                     make_extractors)
    from worldforge_tpu_torch.sfm.tracker import init_sfm_tracker

    t_phase = time.time()
    _small_sfm_checks(card)
    frames = _sfm_video(SFM_FRAMES, SFM_SIZE)
    cfg = VGGTConfig.vggt_1b()
    torch.cuda.synchronize()
    t0 = time.time()
    params = inference.init_vggt_full(P.make_generator(41, "cuda"), cfg,
                                      enable_point=True, enable_track=True)
    extractors = make_extractors("aliked+sp", max_query_num=4096,
                                 device="cuda")
    final = make_extractors("aliked+sp+sift", max_query_num=2048,
                            device="cuda")
    tracker = init_sfm_tracker(P.make_generator(42, "cuda"))
    torch.cuda.synchronize()
    init_s = time.time() - t0

    ext_times = {}

    def timed(name, fn):
        def run(img):
            t = time.perf_counter()
            out = fn(img)
            ext_times.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return run

    extractors = {k: timed(k, fn) for k, fn in extractors.items()}
    final = {k: timed(f"final_{k}", fn) for k, fn in final.items()}
    aliked_first = extractors["aliked"](frames[0])      # warm-up and queries
    queries = aliked_first[:SFM_TRACK_QUERIES]
    ext_times.clear()

    images = torch.from_numpy(frames.transpose(0, 3, 1, 2).copy()).cuda()[
        None]
    qp = torch.from_numpy(np.ascontiguousarray(queries)).cuda()[None]
    rec = {"phase": "sfm", "part": "vggt_1b_sfm", "card": card,
           "config": "vggt_1b fp32 + point and track heads; VGGSfM tracker "
                     "(coarse + fine, published); ALIKED-N16 + SuperPoint "
                     "at 4,096, final trial + SIFT at 2,048",
           "frames": [SFM_FRAMES, SFM_SIZE, SFM_SIZE],
           "tokens_per_frame": SFM_TOKENS,
           "cuts": ["random weights", "no max_reproj_error (at random init "
                    "no track reprojects)"],
           "init_s": init_s}
    # a first call (cuDNN's algorithm choices, the kernels' first
    # launches), then the counted one
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    inference.vggt_forward(params, cfg, images, qp)
    torch.cuda.synchronize()
    rec["vggt_first_call_s"] = time.time() - t0
    # one forward under torch.profiler, before the counted window: kernel
    # 1's device time beside the rest and the device's idle share
    _profile_forward(lambda: inference.vggt_forward(params, cfg, images, qp),
                     "sfm_vggt_profile", "one VGGT-1B forward with the point "
                     "and track heads on 8 frames of 518 x 518 under "
                     "torch.profiler", {"card": card}, warmup=lambda: None)
    _reset_counters()
    t0 = time.time()
    with timed_calls(inference, "track_head_forward", []) as th:
        out = inference.vggt_forward(params, cfg, images, qp)
        torch.cuda.synchronize()
    rec["vggt_forward_s"] = time.time() - t0
    rec["track_head_s"] = th[0]["s"]
    rec["vggt_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    host = {k: v.float().cpu().numpy() for k, v in out.items()}
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    extr, intr = pose_encoding_to_extri_intri(host["pose_enc"],
                                              (SFM_SIZE, SFM_SIZE))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with timed_calls(track_predict, "compute_tracker_fmaps", []) as fm, \
            timed_calls(track_predict, "_forward_on_query", [],
                        keep=lambda a, o: {"query_frame": int(a[0]),
                                           "tracks": int(o[0].shape[1])}
                        ) as per_query:
        tracks, vis, confs, p3d, colors = track_predict.predict_tracks(
            tracker, frames, combined_extract_fn(extractors),
            conf=host["world_points_conf"][0],
            points_3d=host["world_points"][0],
            final_trial_extract_fn=combined_extract_fn(final))
    rec["predict_tracks_s"] = time.time() - t0
    rec["tracker_fmaps_s"] = fm[0]["s"]
    rec["per_query_frame"] = per_query
    rec["extractor_s_per_frame"] = {k: [round(x, 4) for x in v]
                                    for k, v in ext_times.items()}
    rec["predict_tracks_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    t0 = time.time()
    recon, valid = build_reconstruction(
        p3d, extr[0], intr[0], tracks, (SFM_SIZE, SFM_SIZE),
        masks=vis > 0.2, points_rgb=colors)
    out_dir = os.path.join(work_dir, "sfm_colmap")
    if recon is not None:
        recon.write_text(out_dir)
    rec["export_s"] = time.time() - t0
    launches = _read_counters()
    files = {}
    if recon is not None:
        for name in ("cameras.txt", "images.txt", "points3D.txt"):
            with open(os.path.join(out_dir, name)) as f:
                files[name] = sum(1 for ln in f if not ln.startswith("#"))
    n0 = per_query[0]["tracks"]        # query frame 0's tracks come first
    rec.update({
        "track_head_queries": int(qp.shape[1]),
        "track_head_track": list(host["track"].shape),
        "track_head_vis_range": [float(host["vis"].min()),
                                 float(host["vis"].max())],
        "world_points_conf_range": [float(host["world_points_conf"].min()),
                                    float(host["world_points_conf"].max())],
        "tracks": list(tracks.shape),
        "visible_above_0.2": int((vis > 0.2).sum()),
        "augmentation_queries": len(per_query) - min(5, SFM_FRAMES),
        "points3d": int(valid.sum()) if valid is not None else 0,
        "colmap_lines": files, "launches": dict(launches),
        "seconds": time.time() - t_phase})
    finite = all(bool(np.isfinite(v).all()) for v in host.values()) and \
        bool(np.isfinite(tracks).all())
    rec["ok"] = bool(
        finite and recon is not None
        and host["track"].shape == (1, SFM_FRAMES, int(qp.shape[1]), 2)
        and tracks.shape[0] == SFM_FRAMES and tracks.shape[1] > 0
        and (vis >= 0).all() and (vis <= 1).all()
        and files.get("cameras.txt") == SFM_FRAMES
        and files.get("images.txt") == 2 * SFM_FRAMES
        and files.get("points3D.txt") == int(valid.sum())
        # frame 0 is pinned to the queries: the track head's and, for
        # predict_tracks' first query frame, the extracted keypoints
        and np.array_equal(host["track"][0, 0], queries)
        and n0 > 0 and bool(((tracks[0, :n0] >= 0)
                             & (tracks[0, :n0] < SFM_SIZE)).all()))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the sfm path is wrong")
    _require_launches(launches, SFM_PATH_KERNELS, "sfm")
    return launches


DC_UNET_KERNELS = ("flash_attention", "conv2d_3x3",
                   "flash_attention fp32 d64")
DEPTHCRAFTER_PATH_KERNELS = DC_UNET_KERNELS + ("flash_attention fp32 d512",)


def _dc_video(t, h, w, seed=0):
    """A synthetic video [T, H, W, 3] in [0, 1]: a sky gradient over a
    textured ground plane with a few boxes, the camera panning 3 px a
    frame."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    boxes = [(rng.uniform(0, 2 * w), rng.uniform(0.35, 0.7) * h,
              rng.uniform(0.08, 0.2) * w, rng.uniform(0.15, 0.3) * h,
              rng.uniform(0.1, 0.9, 3)) for _ in range(6)]
    out = np.empty((t, h, w, 3), np.float32)
    sky = yy < 0.4 * h
    for i in range(t):
        x = xx + 3.0 * i
        img = out[i]
        img[..., 0] = np.where(sky, 0.5 + 0.3 * yy / h,
                               0.35 + 0.2 * np.sin(x / 17.0)
                               * np.cos(yy / 11.0))
        img[..., 1] = np.where(sky, 0.6 + 0.2 * yy / h, 0.45)
        img[..., 2] = np.where(sky, 0.9, 0.3 + 0.1 * np.sin(x / 7.0))
        for x0, y0, bw, bh, col in boxes:
            inside = ((x >= x0) & (x < x0 + bw) & (yy >= y0)
                      & (yy < y0 + bh))
            img[inside] = col
    out += 0.02 * rng.standard_normal(out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def _dc_depth(t, h, w):
    """Normalised depth [T, H, W] with a box in front of a slanted plane,
    moving 1 px a frame (sharp edges for the edge filter)."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = [0.2 + 0.4 * xx / w + 0.2 * yy / h
         + 0.35 * ((xx - i > 0.3 * w) & (xx - i < 0.6 * w)
                   & (yy > 0.25 * h) & (yy < 0.75 * h))
         for i in range(t)]
    d = np.stack(d).astype(np.float32)
    return (d - d.min()) / (d.max() - d.min())


def _small_depthcrafter_check():
    """``SVDUNetConfig.tiny()`` widened to (64, 64, 128, 128) with heads
    of 64 and ``SVDVAEConfig.tiny()`` widened to (32, 32, 64, 512) (its mid
    attention one head of 512), weights drawn on the CPU and copied to the
    card, against the CPU computing the card's conv arithmetic in plain
    PyTorch (``unet._bf16_convs`` replaced for the run: the card rounds
    every conv's operands to bf16, the CPU path keeps fp32 convs):

    - the VAE encode, one UNet forward and the VAE decode on the same
      inputs: relative L2 <= 2e-2 each;
    - ``DepthCrafterPipeline`` on 7 frames of 64 x 128 (window 4, overlap
      2: three windows; 2 steps), its per-frame context from
      ``clip_frame_encoder`` over ``CLIPVisionConfig.tiny()`` widened to
      160 (2 heads of 80, as CLIP-H's) with a projection to 64, from one
      noise stream. The CPU run is fed the card's UNet outputs: at each
      call it computes its own on the card's inputs, then goes on with the
      card's, so a last-bit difference cannot flip bf16 roundings that
      flip more through the forty-odd convs of the later calls. Relative
      L2 <= 2e-2 for each UNet call's output, for each call's inputs (the
      CPU's own against the card's: the CLIP context, the conditioning
      encode, the windows, the re-init and the Euler steps) and for the
      decoded frames (the CPU decodes its own latents);
    - ``warp_video`` with the edge filter on 7 frames of 400 x 448: no mask
      pixel may differ."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.depthcrafter import unet
    from worldforge_tpu_torch.models.depthcrafter.unet import (
        SVDUNetConfig, init_svd_unet, svd_unet_forward)
    from worldforge_tpu_torch.models.depthcrafter.vae import (
        SVDVAEConfig, init_svd_vae, svd_vae_decode, svd_vae_encode)
    from worldforge_tpu_torch.models.encoders import clip_vision
    from worldforge_tpu_torch.pipelines import depthcrafter as dcp
    from worldforge_tpu_torch.warp.dc_warp import warp_video
    ucfg = dataclasses.replace(SVDUNetConfig.tiny(),
                               block_out_channels=(64, 64, 128, 128),
                               num_attention_heads=(1, 1, 2, 2),
                               cross_attention_dim=64)
    vcfg = dataclasses.replace(SVDVAEConfig.tiny(),
                               block_out_channels=(32, 32, 64, 512))
    ccfg = dataclasses.replace(clip_vision.CLIPVisionConfig.tiny(),
                               width=160)
    up = init_svd_unet(P.make_generator(31), ucfg)
    vp = init_svd_vae(P.make_generator(32), vcfg)
    clip = (clip_vision.init_clip_vision(P.make_generator(36), ccfg),
            clip_vision.init_clip_projection(P.make_generator(37), ccfg, 64))
    cup, cvp, cclip = (P.tree_map(lambda t: t.cuda(), t)
                       for t in (up, vp, clip))
    rng = np.random.default_rng(33)
    video = rng.random((7, 64, 128, 3)).astype(np.float32)
    frames = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 64, 128)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 16)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 4, 1, 64)).astype(
        np.float32))
    ids = torch.tensor([[7.0, 127.0, 0.02]])
    z = torch.from_numpy(0.5 * rng.standard_normal((4, 4, 8, 16)).astype(
        np.float32))

    def rel_l2(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def run(uparams, vparams, clip_params, dev, unet_fn):
        def to(t):
            return t.to(dev)
        noise = np.random.default_rng(34)
        pipe = dcp.DepthCrafterPipeline(
            uparams, ucfg, vparams, vcfg,
            encode_frames_clip=dcp.clip_frame_encoder(*clip_params, ccfg))
        out = {
            "encode": svd_vae_encode(vparams, vcfg, to(frames), scale=False),
            "unet": svd_unet_forward(uparams, ucfg, to(x), 1.0, to(ctx),
                                     to(ids)),
            "decode": svd_vae_decode(vparams, vcfg, to(z))}
        saved = dcp.svd_unet_forward
        dcp.svd_unet_forward = unet_fn
        try:
            out["pipeline"] = torch.from_numpy(pipe(
                None, video, num_inference_steps=2, window_size=4,
                overlap=2, decode_chunk_size=4,
                noise_fn=lambda s: noise.standard_normal(s).astype(
                    np.float32)))
        finally:
            dcp.svd_unet_forward = saved
        return out

    calls = []        # the card's UNet calls: (tensor inputs on the CPU, out)

    def card_unet(params, cfg, *args, **kwargs):
        out = svd_unet_forward(params, cfg, *args, **kwargs)
        calls.append(([a.cpu() if torch.is_tensor(a) else a for a in args],
                      out.cpu()))
        return out

    forced = {"unet_out": [], "unet_in": []}

    def cpu_unet(params, cfg, *args, **kwargs):
        card_args, card_out = calls[len(forced["unet_out"])]
        forced["unet_in"].append(max(
            rel_l2(a, b) for a, b in zip(args, card_args)
            if torch.is_tensor(a)))
        own = svd_unet_forward(params, cfg, *card_args, **kwargs)
        forced["unet_out"].append(rel_l2(own, card_out))
        return card_out.clone()

    _reset_counters()
    card = run(cup, cvp, cclip, "cuda", card_unet)
    launches = _read_counters()
    saved = unet._bf16_convs
    unet._bf16_convs = lambda x: True
    try:
        cpu = run(up, vp, clip, "cpu", cpu_unet)
    finally:
        unet._bf16_convs = saved

    errs = {k: rel_l2(card[k], cpu[k]) for k in card}
    errs["pipeline unet calls, max"] = max(forced["unet_out"])
    errs["pipeline unet inputs, max"] = max(forced["unet_in"])
    tol = 2e-2
    wframes = rng.random((7, 400, 448, 3)).astype(np.float32)
    depth = _dc_depth(7, 400, 448)
    kw = dict(direction="left", degree=10.0, look_at_depth=1.0,
              enable_edge_filter=True)
    warps = {dev: warp_video(wframes, depth, device=dev, **kw)
             for dev in ("cuda", "cpu")}
    mask_diff = int(sum((a != b).sum() for a, b in zip(warps["cuda"][1],
                                                        warps["cpu"][1])))
    frame_diff = int(sum((a != b).any(-1).sum() for a, b in zip(
        warps["cuda"][0], warps["cpu"][0])))
    ok = (all(bool(torch.isfinite(v).all()) for v in card.values())
          and len(calls) == len(forced["unet_out"]) == 3 * 2
          and all(e <= tol for e in errs.values()) and mask_diff == 0
          and all(m.mean() > 0 for m in warps["cpu"][1]))
    emit({"phase": "depthcrafter_small_vs_cpu",
          "unet": "SVDUNetConfig.tiny(), block_out_channels (64, 64, 128, "
                  "128), heads of 64",
          "vae": "SVDVAEConfig.tiny(), block_out_channels (32, 32, 64, 512)",
          "video": list(video.shape), "window": 4, "overlap": 2, "steps": 2,
          "rel_l2": errs, "tol_rel_l2": tol,
          "pipeline_unet_calls": forced,
          "warp": {"frames": list(wframes.shape), "edge_filter": True,
                   "card_vs_cpu_mask_px_differing": mask_diff,
                   "card_vs_cpu_frame_px_differing": frame_diff,
                   "mask_coverage": [round(float(m.mean()), 4)
                                     for m in warps["cpu"][1]]},
          "launches_on_card": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: the small DepthCrafter stage "
                         "disagrees with the CPU")
    _require_launches(launches, DEPTHCRAFTER_PATH_KERNELS,
                      "small DepthCrafter")


def phase_depthcrafter(work_dir):
    """The DepthCrafter video warp stage through the user's entry points:
    the SVD UNet and VAE at full width (random fp32 weights from a seed),
    ``DepthCrafterPipeline`` on a 40-frame 512 x 832 synthetic video
    (window 24, overlap 8: two windows; 5 steps; decode chunks of 8), its
    per-frame context from CLIP-H (``vit_h_14``, fp32, random) and a
    projection to 1024 through ``clip_frame_encoder`` ->
    ``normalize_depth`` -> a depth npz -> ``cli/warp_depthcrafter`` with
    ``--depth_npz`` (the CLI's defaults: left 15 degrees, no edge filter;
    random weights give a depth of noise, so past frame 0, whose camera is
    the source's, the masks cover little). Then one UNet forward at the
    published 110-frame window (the smallest ``attn_chunks`` that fits),
    one on 8 frames of 1024 x 1024 (each counted in its own window) and one
    24-frame forward under ``torch.profiler``. Returns the three runs'
    launches by path."""
    import numpy as np
    from worldforge_tpu_torch.cli import warp_depthcrafter as dc_cli
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.frames import read_frames_from_directory
    from worldforge_tpu_torch.models.depthcrafter.unet import (
        SVDUNetConfig, init_svd_unet, svd_unet_forward)
    from worldforge_tpu_torch.models.depthcrafter.vae import (SVDVAEConfig,
                                                              init_svd_vae)
    from worldforge_tpu_torch.models.encoders import clip_vision
    from worldforge_tpu_torch.pipelines import depthcrafter as dcp
    from worldforge_tpu_torch.warp import dc_warp

    _small_depthcrafter_check()
    os.makedirs(work_dir, exist_ok=True)
    rec = {"phase": "depthcrafter",
           "config": "SVDUNetConfig.svd() + SVDVAEConfig.svd(), fp32",
           "video": [DC_FRAMES, DC_H, DC_W], "window": DC_WINDOW,
           "overlap": DC_OVERLAP, "steps": DC_STEPS,
           "decode_chunk_size": DC_DECODE_CHUNK,
           "cuts": {"frames": f"{DC_FRAMES} of the published "
                              f"{DC_PUBLISHED_WINDOW}-frame window",
                    "window": f"{DC_WINDOW} of {DC_PUBLISHED_WINDOW}",
                    "overlap": f"{DC_OVERLAP} of {DC_PUBLISHED_OVERLAP}",
                    "weights": "random, from a seed"}}
    ucfg, vcfg = SVDUNetConfig.svd(), SVDVAEConfig.svd()
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    up = init_svd_unet(P.make_generator(41, "cuda"), ucfg)
    vp = init_svd_vae(P.make_generator(42, "cuda"), vcfg)
    ccfg = clip_vision.CLIPVisionConfig.vit_h_14()
    cp = clip_vision.init_clip_vision(P.make_generator(45, "cuda"), ccfg)
    proj = clip_vision.init_clip_projection(P.make_generator(46, "cuda"),
                                            ccfg, ucfg.cross_attention_dim)
    torch.cuda.synchronize()
    rec["init_s"] = time.time() - t0
    rec["unet_params"] = sum(t.numel() for t in _leaves(up))
    rec["vae_params"] = sum(t.numel() for t in _leaves(vp))
    rec["clip_params"] = sum(t.numel() for t in _leaves((cp, proj)))
    rec["weights_gb"] = torch.cuda.memory_allocated() / 2 ** 30
    video = _dc_video(DC_FRAMES, DC_H, DC_W)
    clip_s = []
    encode_clip = dcp.clip_frame_encoder(cp, proj, ccfg)

    def timed_clip(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_clip(frames)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        return out

    pipe = dcp.DepthCrafterPipeline(up, ucfg, vp, vcfg,
                                    encode_frames_clip=timed_clip)
    with timed_calls(dcp, "svd_vae_encode", []) as enc, \
            timed_calls(dcp, "svd_unet_forward", []) as fwd, \
            timed_calls(dcp, "svd_vae_decode", []) as dec:
        torch.cuda.synchronize()
        t0 = time.time()
        frames_out = pipe(torch.Generator(device="cuda").manual_seed(43),
                          video, num_inference_steps=DC_STEPS,
                          window_size=DC_WINDOW, overlap=DC_OVERLAP,
                          decode_chunk_size=DC_DECODE_CHUNK)
        pipe_s = time.time() - t0
    rec["pipeline_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    depth = dcp.normalize_depth(frames_out)
    encode_s = sum(r["s"] for r in enc)
    decode_s = sum(r["s"] for r in dec)
    steps = len(fwd)
    rec.update({"pipeline_s": pipe_s, "clip_s": clip_s[0],
                "encode_s": encode_s,
                "encode_calls": len(enc), "unet_forwards": steps,
                "unet_forward_s": [r["s"] for r in fwd],
                "s_per_unet_forward": sum(r["s"] for r in fwd) / steps,
                "s_per_step": (pipe_s - clip_s[0] - encode_s - decode_s)
                / steps,
                "decode_s": decode_s, "decode_calls": len(dec)})
    npz = os.path.join(work_dir, "dc_depth.npz")
    np.savez(npz, depth=depth, frames=video)
    out_dir = os.path.join(work_dir, "dc_warp")
    with timed_calls(dc_warp, "splat_disk", []) as splat, \
            timed_calls(dc_warp, "morph_open", []) as morph, \
            timed_calls(dc_warp, "edge_point_mask", []) as edge, \
            timed_calls(dc_cli, "warp_video", []) as whole:
        t0 = time.time()
        dc_cli.main(["--depth_npz", npz, "--output_path", out_dir])
        rec["cli_s"] = time.time() - t0
    launches = _read_counters()
    rec.update({"warp_s": whole[0]["s"],
                "device_splat_s": sum(r["s"] for r in splat),
                "host_morph_open_s": sum(r["s"] for r in morph),
                "host_edge_filter_s": sum(r["s"] for r in edge)})
    rec["total_s"] = pipe_s + rec["cli_s"]
    wf, wm, _ = read_frames_from_directory(os.path.join(out_dir, "imgs"))
    rec["warp_frames"] = len(wf)
    rec["mask_coverage"] = [round(float(m.mean()), 4) for m in wm]
    rec["depth_range"] = [float(depth.min()), float(depth.max())]
    rec["launches"] = launches
    rec["launches_by_shape"] = _shape_counts(launches)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # every 3x3 conv the path gave kernel 4 was held against its plain
    # version in the kernels phase (DC_CONV2D)
    unchecked = sorted({k[3:] for k in launches.by_shape["conv2d_3x3"]}
                       - {c[3:] for c in DC_CONV2D})
    rec["conv2d_3x3_pairs_unchecked"] = unchecked
    windows = 1 + -(-(DC_FRAMES - DC_WINDOW) // (DC_WINDOW - DC_OVERLAP))
    ok = (frames_out.shape == (DC_FRAMES, DC_H, DC_W, 3)
          and bool(np.isfinite(frames_out).all())
          and depth.shape == (DC_FRAMES, DC_H, DC_W)
          and steps == windows * DC_STEPS and windows == 2
          and len(wf) == len(wm) == DC_FRAMES
          and wf[0].shape == (DC_H, DC_W, 3) and bool(wm[0].all())
          and not unchecked)
    rec["windows"] = windows
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: the DepthCrafter stage's output is "
                         "wrong")
    _require_launches(launches, DEPTHCRAFTER_PATH_KERNELS, "depthcrafter")
    del frames_out, video, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # single UNet forwards, each counted in its own window
    paths = {"depthcrafter": launches}
    gen = torch.Generator(device="cuda").manual_seed(44)
    ids = torch.tensor([[7.0, 127.0, 0.02]], device="cuda")
    t_cont = 0.25 * math.log(700.0)

    def inputs(f):
        return (torch.randn((1, f, 8, DC_H // 8, DC_W // 8), generator=gen,
                            device="cuda"),
                torch.zeros((1, f, 1, ucfg.cross_attention_dim),
                            device="cuda"))

    x, ctx = inputs(DC_PUBLISHED_WINDOW)
    tried, y = [], None
    _reset_counters()
    for chunks in (1, 2, 4, 8, 16):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            y = svd_unet_forward(up, ucfg, x, t_cont, ctx, ids,
                                 attn_chunks=chunks)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            tried.append({"attn_chunks": chunks, "fits": False})
            continue
        tried.append({"attn_chunks": chunks, "fits": True,
                      "s": time.time() - t0,
                      "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "finite": bool(torch.isfinite(y).all())})
        break
    paths["dc_window110"] = _read_counters()
    del x, ctx, y
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "dc_window110", "latents": [1, DC_PUBLISHED_WINDOW, 8,
                                                DC_H // 8, DC_W // 8],
          "tried": tried, "launches": paths["dc_window110"],
          "launches_by_shape": _shape_counts(paths["dc_window110"])})
    if not tried[-1]["fits"] or not tried[-1]["finite"]:
        raise SystemExit("chip_smoke: the 110-frame UNet forward failed")
    _require_launches(paths["dc_window110"], DC_UNET_KERNELS, "dc_window110")
    # the grid repair on the path itself: a square 1024 x 1024 video (the
    # CLI's default --max_res) gives the first level's temporal attention
    # (1024/8)^2 x 5 = 81,920 rows, more than gridDim.y's 65,535
    x = torch.randn((1, DC_SQUARE_FRAMES, 8, 128, 128), generator=gen,
                    device="cuda")
    ctx = torch.zeros((1, DC_SQUARE_FRAMES, 1, ucfg.cross_attention_dim),
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    y = svd_unet_forward(up, ucfg, x, t_cont, ctx, ids)
    torch.cuda.synchronize()
    paths["dc_square1024"] = _read_counters()
    square = {"phase": "dc_square1024", "latents": list(x.shape),
              "temporal_attention_rows": 128 * 128 * DC_HEADS,
              "s": time.time() - t0,
              "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "finite": bool(torch.isfinite(y).all()),
              "launches": paths["dc_square1024"],
              "launches_by_shape": _shape_counts(paths["dc_square1024"])}
    emit(square)
    if not square["finite"]:
        raise SystemExit("chip_smoke: the 1024x1024 UNet forward failed")
    _require_launches(paths["dc_square1024"], DC_UNET_KERNELS,
                      "dc_square1024")
    del x, ctx, y
    x, ctx = inputs(DC_WINDOW)
    _profile_forward(lambda: svd_unet_forward(up, ucfg, x, t_cont, ctx, ids),
                     "dc_profile", "one SVD UNet forward (fp32) on a "
                     "24-frame 512x832 window under torch.profiler",
                     {"latents": list(x.shape)})
    del x, ctx
    _svd_checkpoint_check(up, ucfg, vp, vcfg)
    del up, vp, cp, proj
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _frames_480p(warp_dir):
    """The warp's frames and masks at the generate shape: frames resized
    with LANCZOS (as ``io/frames.load_image``), masks nearest. Returns
    video_ref [1, 3, F, H, W] in [0, 1] and mask [1, 1, F, H, W]."""
    import numpy as np
    from PIL import Image
    frames, masks = _read_warp_dir(warp_dir)
    size = (WIDTH, HEIGHT)
    f = np.stack([np.asarray(Image.fromarray(x).resize(size, Image.LANCZOS))
                  for x in frames]).astype(np.float32) / 255.0
    m = np.stack([np.asarray(Image.fromarray(x * 255).resize(
        size, Image.NEAREST)) > 127 for x in masks]).astype(np.float32)
    return (np.ascontiguousarray(f.transpose(3, 0, 1, 2)[None]),
            m[None, None])


def _small_encoders_check():
    """UMT5 at its tiny config and CLIP at its tiny config widened to 160
    (2 heads of 80, as CLIP-H's), weights drawn on the CPU and copied to
    the card, fp32, on the card against the CPU: to 1e-4 of the largest
    |output|."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.encoders import clip_vision, umt5
    rng = np.random.default_rng(6)
    ucfg = umt5.UMT5Config.tiny()
    up = umt5.init_umt5(P.make_generator(6), ucfg, dtype=torch.float32)
    ids = torch.from_numpy(rng.integers(0, ucfg.vocab_size, (2, 24)))
    mask = torch.ones((2, 24), dtype=torch.int32)
    mask[1, 9:] = 0
    ccfg = dataclasses.replace(clip_vision.CLIPVisionConfig.tiny(),
                               width=160)
    cp = clip_vision.init_clip_vision(P.make_generator(7), ccfg)
    pix = torch.from_numpy(clip_vision.preprocess_clip(
        rng.random((40, 60, 3)).astype(np.float32), ccfg.image_size))
    card = P.tree_map(lambda t: t.cuda(), (up, cp))
    _reset_counters()
    outs = {"umt5": (umt5.umt5_encode(card[0], ucfg, ids.cuda(),
                                      mask.cuda(), torch.float32),
                     umt5.umt5_encode(up, ucfg, ids, mask, torch.float32)),
            "clip": (clip_vision.clip_vision_hidden(card[1], ccfg,
                                                    pix.cuda()),
                     clip_vision.clip_vision_hidden(cp, ccfg, pix))}
    launches = _read_counters()
    errs = {k: _rel_max(a, b) for k, (a, b) in outs.items()}
    ok = max(errs.values()) <= 1e-4
    emit({"phase": "encoders_small_vs_cpu", "max_rel_err": errs,
          "tol": 1e-4, "launches_on_card": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small encoders disagree with the CPU")
    _require_launches(launches, ENCODER_PATH_KERNELS, "small encoders")


def phase_encoders(first_frame, last_frame):
    """UMT5-XXL (random bf16 weights, built on the card layer by layer) on
    512 token ids, the prompt's 28 and the negative prompt's 64 unmasked,
    and CLIP-H (``vit_h_14``, fp32) on the first 480 x 832 frame through
    ``preprocess_clip``, at full width and depth; both freed before the
    DiT loads. CLIP-H also encodes the last frame, FLF2V's second image
    (after the path's counters are read). Returns the contexts and the
    path's launches."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.encoders import clip_vision, umt5
    import numpy as np

    _small_encoders_check()
    rec = {"phase": "encoders"}
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ucfg = umt5.UMT5Config.xxl()
    up = umt5.init_umt5(P.make_generator(13, "cuda"), ucfg)
    torch.cuda.synchronize()
    rec["umt5_init_s"] = time.time() - t0
    rec["umt5_params"] = sum(t.numel() for t in _leaves(up))
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, ucfg.vocab_size, (2, TEXT_LEN)), device="cuda")
    mask = torch.zeros((2, TEXT_LEN), dtype=torch.int32, device="cuda")
    mask[0, :PROMPT_TOKENS] = 1
    mask[1, :NEGATIVE_TOKENS] = 1
    t0 = time.time()
    text = umt5.umt5_encode(up, ucfg, ids, mask)
    torch.cuda.synchronize()
    rec["umt5_s"] = time.time() - t0
    rec["umt5_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ccfg = clip_vision.CLIPVisionConfig.vit_h_14()
    cp = clip_vision.init_clip_vision(P.make_generator(14, "cuda"), ccfg)
    torch.cuda.synchronize()
    rec["clip_init_s"] = time.time() - t0
    rec["clip_params"] = sum(t.numel() for t in _leaves(cp))
    pixels = torch.as_tensor(clip_vision.preprocess_clip(first_frame),
                             device="cuda")
    t0 = time.time()
    image = clip_vision.clip_vision_hidden(cp, ccfg, pixels)
    torch.cuda.synchronize()
    rec["clip_s"] = time.time() - t0
    rec["clip_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _read_counters()
    image_last = clip_vision.clip_vision_hidden(
        cp, ccfg, torch.as_tensor(clip_vision.preprocess_clip(last_frame),
                                  device="cuda"))
    del cp
    gc.collect()
    torch.cuda.empty_cache()
    ctx = {"pe": text[:1], "ne": text[1:], "ie": image,
           "ie_last": image_last}
    ok = (tuple(ctx["pe"].shape) == (1, TEXT_LEN, 4096)
          and tuple(ctx["ie"].shape) == (1, 257, 1280)
          and tuple(ctx["ie_last"].shape) == (1, 257, 1280)
          and all(bool(torch.isfinite(v).all()) for v in ctx.values())
          and not bool(text[0, PROMPT_TOKENS:].any()))
    rec.update({"text_tokens": TEXT_LEN, "unmasked": [PROMPT_TOKENS,
                                                      NEGATIVE_TOKENS],
                "shapes": {k: list(v.shape) for k, v in ctx.items()},
                "launches": launches, "ok": ok})
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: encoder outputs are wrong")
    _require_launches(launches, ENCODER_PATH_KERNELS, "encoders")
    return ctx, launches


def _small_generate_check(quant=None):
    """The same small random-init pipeline (the loader's reduced default
    configs, fp32 policy; weights drawn on the CPU and copied to the card)
    generated on the card with the kernels and on the CPU with their plain
    versions, from the same noise stream. With ``quant`` (``quantize_tree``
    keywords) the DiT is quantized on the CPU first, and the card runs the
    int8 products (the line's phase is generate_small_w4a8_vs_cpu)."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
    rng = np.random.default_rng(0)
    f, hw = 5, 64
    image = rng.uniform(-1, 1, (1, 3, hw, hw)).astype(np.float32)
    ref = rng.uniform(0, 1, (1, 3, f, hw, hw)).astype(np.float32)
    mask = np.zeros((1, 1, f, hw, hw), np.float32)
    mask[..., : hw // 2] = 1.0
    # FLF on (the library default) through 8 guided steps: the Wan
    # schedule hands one channel back at steps 6 and 7
    steps = 8
    guide = GuidanceConfig(guided=True, guide_steps=steps, resample_steps=2,
                           resample_round=steps, omega=1.8)
    pipe, enc_t, enc_i = load_wan_pipeline(random_init=True, device="cpu",
                                           policy=FP32_POLICY)
    if quant is not None:
        from worldforge_tpu_torch.ops.quant import quantize_tree
        pipe = dataclasses.replace(
            pipe, dit_params=quantize_tree(pipe.dit_params, **quant))
    on_card = dataclasses.replace(
        pipe, dit_params=P.tree_map(lambda t: t.cuda(), pipe.dit_params),
        vae_params=P.tree_map(lambda t: t.cuda(), pipe.vae_params))
    outs, picked = {}, {}
    for dev, pipe in (("cuda", on_card), ("cpu", pipe)):
        noise = np.random.default_rng(7)
        with timed_calls(guidance, "flf_select", [], flf_record) as sel:
            outs[dev] = pipe.generate(
                None, image, enc_t("a prompt"), enc_t("a negative prompt"),
                enc_i(image), height=hw, width=hw, num_frames=f,
                num_inference_steps=steps, guidance_scale=5.0,
                video_ref=ref, mask=mask, guidance=guide,
                output_type="latent",
                noise_fn=lambda s: noise.standard_normal(s).astype(
                    np.float32)).float().cpu()
        picked[dev] = {r["step"]: r["channels"] for r in sel}
    a, b = outs["cuda"], outs["cpu"]
    rel_l2 = float((a - b).norm() / b.norm())
    rel_max = float((a - b).abs().max() / b.abs().max())
    handed = [i for i, c in picked["cuda"].items() if c]
    # bf16 rounding of the conv inputs flips on last-bit fp32 differences
    # (see tests/test_torch_pipeline.py): bf16 noise level
    tol = 2e-2
    ok = bool(torch.isfinite(a).all()) and rel_l2 < tol and len(handed) >= 1
    emit({"phase": "generate_small_vs_cpu" if quant is None else
          "generate_small_w4a8_vs_cpu", "quant": quant,
          "shape": list(a.shape),
          "steps": steps, "use_flf": guide.use_flf,
          "flf_channels_by_step_card": picked["cuda"],
          "flf_sets_equal_cpu": picked["cuda"] == picked["cpu"],
          "steps_handing_channels_back": len(handed),
          "rel_l2": rel_l2, "rel_max": rel_max, "tol_rel_l2": tol,
          "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small generate disagrees with the "
                         "CPU run of the plain versions")


def _guided_generate(pipe, warp_dir, ctx):
    """The generate phase's guided repaint (GEN_FRAMES at 480 x 832,
    GEN_STEPS steps, CFG 5.0, IRR, FLF) on ``pipe``, fed by the warp's
    frames and masks and the contexts ``ctx`` (pe, ne, ie); the kernels'
    counters are set to 0 just before it and read just after."""
    import numpy as np
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    f, h, w = GEN_FRAMES, HEIGHT, WIDTH
    frames, mask = _frames_480p(warp_dir)     # [1,3,F,H,W], [1,1,F,H,W]
    image = (frames[:, :, 0] * 2.0 - 1.0).astype(np.float32)
    guide = GuidanceConfig(guided=True, guide_steps=GEN_STEPS,
                           resample_steps=2, resample_round=GEN_STEPS,
                           omega=1.8, omega_resample=1.0)
    pe, ne, ie = ctx["pe"], ctx["ne"], ctx["ie"]
    gen = torch.Generator(device="cuda").manual_seed(42)

    marks = []

    def on_step(i, lat):
        torch.cuda.synchronize()
        marks.append(time.time())

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with timed_calls(guidance, "flf_select", [], flf_record) as flf:
        out = pipe.generate(gen, image, pe, ne, ie, height=h, width=w,
                            num_frames=f, num_inference_steps=GEN_STEPS,
                            guidance_scale=5.0, video_ref=frames, mask=mask,
                            guidance=guide, callback=on_step)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    return {"out": out, "guide": guide, "flf": flf,
            "launches": _read_counters(), "total_s": total_s,
            "step_s": [b - a for a, b in zip([t0] + marks[:-1], marks)],
            "final_decode_s": total_s - (marks[-1] - t0),
            "mask_coverage": float(mask.mean())}


def phase_generate(warp_dir, ctx):
    """The guided repaint at full width through the user's entry points,
    fed by the warp phase's frames and masks (at 480 x 832) and the
    encoders phase's text and image contexts."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig

    _small_generate_check()

    dit_cfg = dataclasses.replace(WanDiTConfig.wan_14b_i2v(),
                                  num_layers=GEN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe, _, _ = load_wan_pipeline(
        random_init=True, device="cuda", dit_cfg=dit_cfg,
        vae_cfg=WanVAEConfig.wan_2_1())
    torch.cuda.synchronize()
    init_s = time.time() - t0

    run = _guided_generate(pipe, warp_dir, ctx)
    out, guide, flf, launches = (run["out"], run["guide"], run["flf"],
                                 run["launches"])
    f, h, w = GEN_FRAMES, HEIGHT, WIDTH
    total_s, step_s = run["total_s"], run["step_s"]
    ok_shape = out.shape == (1, 3, f, h, w)
    finite = bool(np.isfinite(out).all())
    emit({"phase": "generate", "config": "wan_14b_i2v + wan_2_1 vae",
          "cuts": {"layers": f"{GEN_LAYERS} of 40", "frames":
                   f"{GEN_FRAMES} of 49", "steps": f"{GEN_STEPS} of 50"},
          "inputs": "the warp phase's frames and masks (LANCZOS / nearest "
                    "to 480x832), the encoders phase's UMT5-XXL and CLIP-H "
                    "contexts", "mask_coverage": run["mask_coverage"],
          "height": h, "width": w, "frames": f, "steps": GEN_STEPS,
          "resample_steps": 2, "guide_steps": GEN_STEPS,
          "guidance_scale": 5.0, "omega": 1.8, "use_flf": guide.use_flf,
          "flf": [{"step": r["step"], "channels": r["channels"],
                   "s": r["s"]} for r in flf],
          "flf_note": "FLF scores the channels at r = 0 of steps 2 and up; "
                      "the Wan schedule hands none back before step 6",
          "init_s": init_s,
          "total_s": total_s, "step_s": step_s,
          "final_decode_s": run["final_decode_s"],
          "launches": launches,
          "launches_per_step": {k: v / GEN_STEPS for k, v in
                                launches.items()},
          "out_shape": list(out.shape), "finite": finite,
          "out_range": [float(out.min()), float(out.max())],
          "max_memory_allocated_gb":
          torch.cuda.max_memory_allocated() / 2 ** 30})
    if not (ok_shape and finite):
        raise SystemExit("chip_smoke: generate output is wrong")
    _require_launches(launches, WAN_PATH_KERNELS, "generate")
    fused_launches, fused_latents = phase_fused(pipe, warp_dir, ctx)
    runtime_subproc_decode(pipe, fused_latents,
                           os.path.join(HERE, "build", "chip_smoke"))
    del pipe, fused_latents
    return {"launches": launches, "out": out, "fused": fused_launches,
            "flf": {r["step"]: r["channels"] for r in flf}}


# ------------------------------------------------------------------ fused

# The fused phase runs the generate's guided repaint (its cuts: 17 frames at
# 480 x 832) through ``generate(fused=True)`` over FUSED_STEPS steps, every
# one guided, so that the Wan schedule hands channels back (from step 6);
# the graph-against-eager and exec_chunk checks run FUSED_CHECK_STEPS steps
# with guide_steps 2 (two guided steps, then a plain one: the carry crosses
# a change of captured graph).
FUSED_STEPS = 7
FUSED_CHECK_STEPS = 3
FUSED_TOL = 2e-2         # the generate's card-against-CPU gate (rel. L2)


@contextlib.contextmanager
def eager_fused():
    """``generate(fused=True)`` with the step body run eagerly on the card
    (``sampling/engine.py::run_plan`` with ``graphs=False``): the body,
    tables and draws of the graph replays, launched op by op."""
    from worldforge_tpu_torch.sampling import engine
    orig = engine.run_plan

    def eager(plan, make_body, carry, graphs=None, **kw):
        return orig(plan, make_body, carry, graphs=False, **kw)

    engine.run_plan = eager
    try:
        yield
    finally:
        engine.run_plan = orig


def _step_marks():
    """A generate callback that synchronizes after each step (inside a
    ``step_end`` profiler mark) and keeps the time and the step's latents
    (a copy)."""
    marks, lat = [], {}

    def on_step(i, latents):
        with torch.profiler.record_function("step_end"):
            torch.cuda.synchronize()
        marks.append(time.time())
        lat[i] = latents.detach().float().clone()

    return on_step, marks, lat


def _idle_by_step(prof) -> list:
    """From a profile of a run with ``_step_marks``'s callback: for each
    step after the first (the window between the ends of two ``step_end``
    marks), the share of its wall time in which no kernel or copy ran on
    the device."""
    from torch.autograd import DeviceType
    syncs, spans = [], []
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU and e.name == "step_end":
            syncs.append(e.time_range.end)
    syncs.sort()
    spans.sort()
    out = []
    for a, b in zip(syncs[:-1], syncs[1:]):
        busy, end = 0.0, a
        for s, e in spans:
            s, e = max(s, end), min(e, b)
            if e > s:
                busy += e - s
                end = e
        out.append(1.0 - busy / (b - a) if b > a else None)
    return out


def _flf_sets(masks) -> dict:
    """``{step: [channels]}`` of a fused run's FLF masks."""
    return {int(i): [int(c) for c in m.nonzero()[0]]
            for i, m in masks.items()}


def _small_fused_check():
    """The reduced random-init Wan pipeline of ``_small_generate_check``
    (fp32 policy, weights drawn on the CPU and copied to the card) through
    ``generate(fused=True)`` over 8 guided steps with FLF: the graph replays
    bit-equal to the same body run eagerly on the card, with a numpy noise
    stream (``noise_fn``) and with a seeded card generator registered with
    the graphs; the same with the generator over a schedule whose three
    segment kinds follow each other (guide_steps 2 < resample_round 4:
    (fuse, IRR), (no fuse, IRR), (no fuse, no IRR), two of them drawing
    from the one registered generator), also at ``exec_chunk=2``;
    ``exec_chunk`` 1, 2 and 3 bit-equal to one program; and the
    fused run against the host loop (``fused=False``) on the card from the
    same noise: FLF's sets equal at every step (on the card against the
    host's), the latents within the generate's gate. Then the reduced
    LongCat's ``generate_i2v(fused=True)`` (distill, FLF): graph against
    eager and exec_chunk 2, bit-equal, and against its host loop."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io.checkpoints import (load_longcat_pipeline,
                                                     load_wan_pipeline)
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
    rng = np.random.default_rng(0)
    f, hw, steps = 5, 64, 8
    image = rng.uniform(-1, 1, (1, 3, hw, hw)).astype(np.float32)
    ref = rng.uniform(0, 1, (1, 3, f, hw, hw)).astype(np.float32)
    mask = np.zeros((1, 1, f, hw, hw), np.float32)
    mask[..., : hw // 2] = 1.0
    guide = GuidanceConfig(guided=True, guide_steps=steps, resample_steps=2,
                           resample_round=steps, omega=1.8)
    pipe, enc_t, enc_i = load_wan_pipeline(random_init=True, device="cpu",
                                           policy=FP32_POLICY)
    pipe = dataclasses.replace(pipe, dit_params=_to_card(pipe.dit_params),
                               vae_params=_to_card(pipe.vae_params))
    pe, ne = enc_t("a prompt").cuda(), enc_t("a negative prompt").cuda()
    ie = enc_i(image).cuda()

    mixed = dataclasses.replace(guide, guide_steps=2, resample_round=4)

    def wan(noise=None, seed=None, g=guide, **kw):
        gen = (None if seed is None else
               torch.Generator(device="cuda").manual_seed(seed))
        out = pipe.generate(
            gen, image, pe, ne, ie, height=hw, width=hw, num_frames=f,
            num_inference_steps=steps, guidance_scale=5.0, video_ref=ref,
            mask=mask, guidance=g, output_type="latent",
            noise_fn=None if noise is None else _numpy_noise(noise), **kw)
        return out.float().cpu()

    rec = {"phase": "fused", "part": "small_wan"}
    graph = wan(7, fused=True)
    graph_masks = _flf_sets(pipe.last_flf_masks)
    with eager_fused():
        eager = wan(7, fused=True)
    rec["graph_eq_eager_noise_fn"] = torch.equal(graph, eager)
    g_gen = wan(seed=3, fused=True)
    with eager_fused():
        e_gen = wan(seed=3, fused=True)
    rec["graph_eq_eager_generator"] = torch.equal(g_gen, e_gen)
    g_mix = wan(seed=4, g=mixed, fused=True)
    with eager_fused():
        e_mix = wan(seed=4, g=mixed, fused=True)
    rec["generator_three_kinds"] = {
        "guide_steps": mixed.guide_steps,
        "resample_round": mixed.resample_round,
        "graph_eq_eager": torch.equal(g_mix, e_mix),
        "exec_chunk2_eq_one_program": torch.equal(
            wan(seed=4, g=mixed, fused=True, exec_chunk=2), g_mix)}
    rec["exec_chunk_eq_one_program"] = {
        k: torch.equal(wan(7, fused=True, exec_chunk=k), graph)
        for k in (1, 2, 3)}
    with timed_calls(guidance, "flf_select", [], flf_record) as sel:
        loop = wan(7)
    host = {r["step"]: r["channels"] for r in sel}
    rec["flf_device_by_step"] = graph_masks
    rec["flf_host_by_step"] = host
    rec["flf_sets_equal"] = all(graph_masks.get(i, []) == c
                                for i, c in host.items())
    rec["channels_handed_back"] = sum(len(c) for c in graph_masks.values())
    rec["fused_vs_loop_rel_l2"] = _rel_l2(graph, loop)
    rec["tol_rel_l2"] = FUSED_TOL
    rec["ok"] = (rec["graph_eq_eager_noise_fn"]
                 and rec["graph_eq_eager_generator"]
                 and rec["generator_three_kinds"]["graph_eq_eager"]
                 and rec["generator_three_kinds"][
                     "exec_chunk2_eq_one_program"]
                 and all(rec["exec_chunk_eq_one_program"].values())
                 and rec["flf_sets_equal"]
                 and rec["channels_handed_back"] >= 1
                 and rec["fused_vs_loop_rel_l2"] < FUSED_TOL)
    emit(rec)
    del pipe

    lc, enc_t = load_longcat_pipeline(random_init=True, device="cpu",
                                      policy=FP32_POLICY)
    lc = dataclasses.replace(lc, dit_params=_to_card(lc.dit_params),
                             vae_params=_to_card(lc.vae_params))
    f, hw, steps = 9, 128, 4
    frames, lmask, limage = _guided_inputs(f, hw, hw, seed=5)
    lpe, lpm = enc_t(LC_PROMPT)
    lguide = GuidanceConfig(guided=True, guide_steps=steps, resample_steps=2,
                            resample_round=steps, omega=1.8,
                            flf_backend="longcat", max_replace=2)

    def longcat(**kw):
        return lc.generate_i2v(
            None, limage, lpe, lpm, height=hw, width=hw, num_frames=f,
            num_inference_steps=steps, use_distill=True, video_ref=frames,
            mask=lmask, guidance=lguide, output_type="latent",
            noise_fn=_numpy_noise(13), **kw).float().cpu()

    lrec = {"phase": "fused", "part": "small_longcat"}
    lgraph = longcat(fused=True)
    with eager_fused():
        lrec["graph_eq_eager"] = torch.equal(longcat(fused=True), lgraph)
    lrec["exec_chunk2_eq_one_program"] = torch.equal(
        longcat(fused=True, exec_chunk=2), lgraph)
    lrec["fused_vs_loop_rel_l2"] = _rel_l2(lgraph, longcat())
    lrec["tol_rel_l2"] = FUSED_TOL
    lrec["ok"] = (lrec["graph_eq_eager"] and lrec["exec_chunk2_eq_one_program"]
                  and lrec["fused_vs_loop_rel_l2"] < FUSED_TOL)
    emit(lrec)
    if not (rec["ok"] and lrec["ok"]):
        raise SystemExit("chip_smoke: the small fused runs disagree")


def phase_fused(pipe, warp_dir, ctx):
    """The guided repaint through ``generate(fused=True)`` at the generate
    phase's width, depth and cuts on its pipeline, fed by the warp's frames
    and masks and the encoders' contexts, every step a replay of a captured
    CUDA graph: FUSED_STEPS steps beside the host loop from the same
    generator seed (s per step, peaks, FLF's sets on the card against the
    host's, the final latents' error); FUSED_CHECK_STEPS steps as graph
    replays, run eagerly, with exec_chunk 2 and as the host loop (the first
    bit-equal to the second and third; the first and the last under
    ``torch.profiler`` for the device's idle share per step). Returns the
    launches of the FUSED_STEPS fused run (replays counted) and its final
    latents."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    _small_fused_check()

    f, h, w = GEN_FRAMES, HEIGHT, WIDTH
    frames, mask = _frames_480p(warp_dir)
    image = (frames[:, :, 0] * 2.0 - 1.0).astype(np.float32)
    pe, ne, ie = ctx["pe"], ctx["ne"], ctx["ie"]

    def run(steps, seed, guide_steps=None, **kw):
        g = guide_steps or steps
        guide = GuidanceConfig(guided=True, guide_steps=g, resample_steps=2,
                               resample_round=g, omega=1.8,
                               omega_resample=1.0)
        on_step, marks, lat = _step_marks()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = pipe.generate(gen, image, pe, ne, ie, height=h, width=w,
                            num_frames=f, num_inference_steps=steps,
                            guidance_scale=5.0, video_ref=frames, mask=mask,
                            guidance=guide, callback=on_step,
                            output_type="latent", **kw)
        torch.cuda.synchronize()
        step_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
        return {"out": out.float(), "step_s": step_s,
                "steady_s_per_step": sum(step_s[1:]) / max(1, len(step_s) - 1),
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "lat": lat}

    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    _reset_counters()
    fused = run(FUSED_STEPS, 42, fused=True)
    launches = _read_counters()
    device_sets = _flf_sets(pipe.last_flf_masks)
    _reset_counters()
    with timed_calls(guidance, "flf_select", [], flf_record) as sel:
        loop = run(FUSED_STEPS, 42)
    loop_launches = _read_counters()
    host_sets = {r["step"]: r["channels"] for r in sel}

    # FUSED_CHECK_STEPS: graphs (profiled), eager, exec_chunk 2, host loop
    # (profiled)
    def profiled(**kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = run(FUSED_CHECK_STEPS, 43, guide_steps=2, **kw)
        r["idle_by_step"] = _idle_by_step(prof)
        return r

    g3 = profiled(fused=True)
    with eager_fused():
        e3 = run(FUSED_CHECK_STEPS, 43, guide_steps=2, fused=True)
    c3 = run(FUSED_CHECK_STEPS, 43, guide_steps=2, fused=True, exec_chunk=2)
    l3 = profiled()
    handed = sum(len(c) for c in device_sets.values())
    rec = {"phase": "fused", "part": "wan_14b",
           "config": "wan_14b_i2v + wan_2_1 vae",
           "cuts": {"layers": f"{GEN_LAYERS} of 40", "frames":
                    f"{GEN_FRAMES} of 49", "steps": f"{FUSED_STEPS} of 50"},
           "height": h, "width": w, "frames": f, "steps": FUSED_STEPS,
           "guide_steps": FUSED_STEPS, "resample_steps": 2,
           "guidance_scale": 5.0,
           "s_per_step": {"fused": fused["steady_s_per_step"],
                          "unfused": loop["steady_s_per_step"]},
           "step_s": {"fused": fused["step_s"], "unfused": loop["step_s"]},
           "first_step_note": "the fused run's first step holds the "
                              "warm-up step and the captures",
           "idle_share_by_step": {"fused": g3["idle_by_step"],
                                  "unfused": l3["idle_by_step"]},
           "idle_note": f"{FUSED_CHECK_STEPS} steps (2 guided, 1 plain) "
                        "under torch.profiler: steps 1 (guided) and 2 "
                        "(plain), each the window between two of the "
                        "callback's synchronizes",
           "s_per_step_3": {"graph": g3["steady_s_per_step"],
                            "eager_fused": e3["steady_s_per_step"],
                            "unfused": l3["steady_s_per_step"]},
           "memory_allocated_before_gb": before_gb,
           "peak_gb": {"fused": fused["peak_gb"], "unfused": loop["peak_gb"]},
           "flf_device_by_step": device_sets, "flf_host_by_step": host_sets,
           "flf_sets_equal": all(device_sets.get(i, []) == c
                                 for i, c in host_sets.items()),
           "channels_handed_back": handed,
           "fused_vs_unfused_rel_l2": _rel_l2(fused["out"], loop["out"]),
           "fused_vs_unfused_rel_max": _rel_max(fused["out"], loop["out"]),
           "tol_rel_l2": FUSED_TOL,
           "graph_eq_eager": torch.equal(g3["out"], e3["out"]),
           "exec_chunk2_eq_one_program": torch.equal(c3["out"], g3["out"]),
           "launches": launches, "launches_unfused": loop_launches,
           "launches_note": "graph replays counted: each replay adds the "
                            "launches its capture recorded; the fused run "
                            "also runs one warm-up step eagerly"}
    rec["ok"] = (rec["flf_sets_equal"] and handed >= 1
                 and rec["fused_vs_unfused_rel_l2"] < FUSED_TOL
                 and rec["graph_eq_eager"]
                 and rec["exec_chunk2_eq_one_program"]
                 and bool(torch.isfinite(fused["out"]).all()))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the fused generate is wrong")
    _require_launches(launches, WAN_PATH_KERNELS, "fused")
    return launches, fused["out"]


# ---------------------------------------------------------------- runtime


def runtime_subproc_decode(pipe, latents, work_dir, reps=2):
    """``decode_in_subprocess`` of ``latents`` (the fused run's final
    latents) on the card, the child building the VAE from the seed the
    generate's loader drew it from (``load_wan_pipeline`` seed 0: the VAE
    from seed 1 on the card), against the streaming decode the child runs
    (``runtime/subproc.py::decode_clip``) in this process: bit for bit in
    fp16, the child's output type (a float32 clip would add 81 MB to the
    disk the run writes, which the checkpoints phase nearly fills)."""
    from worldforge_tpu_torch.runtime.subproc import (decode_clip,
                                                      decode_in_subprocess)
    gc.collect()                 # the fused runs' graph pools, then the
    torch.cuda.empty_cache()     # cached blocks: the child needs the room
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        want = decode_clip(pipe.vae_params, pipe.vae_cfg, latents).half()
        want = want.cpu()
        times.append(time.time() - t0)
    t0 = time.time()
    video, child_s = decode_in_subprocess(
        latents.cpu().numpy(), pipe.vae_cfg, params_seed=1, dtype="float32",
        reps=reps, device="cuda", workdir=os.path.join(work_dir, "subproc"),
        verbose=False)
    call_s = time.time() - t0
    got = torch.from_numpy(video)
    rec = {"phase": "runtime", "part": "subproc_decode",
           "latents": list(latents.shape), "video": list(got.shape),
           "dtype": str(got.dtype),
           "s_per_rep_in_process": times, "s_per_rep_child": child_s,
           "call_s": call_s, "call_note": "the whole call: the child's "
           "start, its VAE init and kernel load, its reps, the files",
           "bit_equal": torch.equal(got, want),
           "max_abs_diff": float((got.float() - want.float()).abs().max())}
    rec["ok"] = rec["bit_equal"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the subprocess decode differs from "
                         "the in-process decode")


def _free_pinned():
    """Hand the pinned host allocator's cached blocks back to the system
    (its name differs between torch versions); returns the name used."""
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return name
    return None


def runtime_streaming(params, cfg, inputs):
    """The Wan DiT's blocks streamed from pinned host memory through
    ``StreamingExecutor`` (``StreamedBlocks`` in place of the block list):
    the forward at the inputs' shape bit for bit against the resident one,
    s per forward against resident, the copy rate to the card, the device
    peak against the resident forward's. Takes the blocks off the card
    (``params["blocks"]`` ends as None, the pinned buffer handed back to
    the system). Returns the two streamed forwards' launches."""
    from worldforge_tpu_torch.models.wan.dit import wan_dit_forward
    from worldforge_tpu_torch.runtime.streaming import (StreamedBlocks,
                                                        to_host_blocks)
    x, t, ctx, clip, y = inputs

    def forward(p):
        torch.cuda.synchronize()
        t0 = time.time()
        out = wan_dit_forward(p, cfg, x, t, ctx, clip_fea=clip, y=y)
        torch.cuda.synchronize()
        return out, time.time() - t0

    forward(params)                        # warm (the kernels' plans)
    torch.cuda.reset_peak_memory_stats()
    out_ref, resident_s = forward(params)
    resident_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    t0 = time.time()
    host = to_host_blocks(params["blocks"])
    pin_s = time.time() - t0
    block_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params["blocks"]))
    params["blocks"] = host
    gc.collect()
    torch.cuda.empty_cache()
    # the copy rate alone: every layer to the card, one after another
    torch.cuda.synchronize()
    t0 = time.time()
    for layer in host:
        dev = [t.to("cuda", non_blocking=True) for t in _leaves(layer)]
        torch.cuda.synchronize()
        del dev
    h2d_s = time.time() - t0
    streamed = dict(params, blocks=StreamedBlocks(host, cfg.num_layers))
    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    _reset_counters()
    for _ in range(2):
        out, s = forward(streamed)
        outs.append(out)
        times.append(s)
    launches = _read_counters()
    streamed_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ex = streamed["blocks"].executor
    prefetch, max_resident = ex.prefetch, ex.max_resident
    rss_before = _rss_gib()
    del host, streamed, layer, ex
    params["blocks"] = None
    gc.collect()
    freed_by = _free_pinned()
    rec = {"phase": "runtime", "part": "streaming",
           "config": "wan_14b_i2v", "layers": cfg.num_layers,
           "tokens": out_ref.shape[2] * out_ref.shape[3] * out_ref.shape[4]
           // 4, "prefetch": prefetch, "max_resident_layers": max_resident,
           "block_gb": block_bytes / 1e9,
           "pin_s": pin_s, "resident_s": resident_s, "streamed_s": times,
           "overhead": min(times) / resident_s - 1.0,
           "h2d_gb_per_s": block_bytes / h2d_s / 1e9,
           "streamed_gb_per_s": block_bytes / min(times) / 1e9,
           "peak_gb": {"resident": resident_peak, "streamed": streamed_peak},
           "host_rss_gib": {"streaming": rss_before,
                            "after_free": _rss_gib()},
           "pinned_freed_by": freed_by, "launches": launches,
           "bit_equal": all(torch.equal(o, out_ref) for o in outs)}
    rec["ok"] = rec["bit_equal"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the streamed forward differs from "
                         "the resident one")
    _require_launches(launches, ("flash_attention", "rope_qk",
                                 "modulated_layer_norm"), "streamed forward")
    return launches


def runtime_dryrun():
    """``parallel/dryrun.py``'s phases at world size 1 on the one-rank NCCL
    mesh, the fused guided generate and the chunked one among them (CUDA
    graphs under the mesh). Returns their launches."""
    from worldforge_tpu_torch.parallel import dryrun
    _nccl_mesh()
    _reset_counters()
    t0 = time.time()
    done = dryrun.run_phases(1, torch.device("cuda"))
    launches = _read_counters()
    rec = {"phase": "runtime", "part": "dryrun_world_1_nccl",
           "phases": {p: {"out": list(s), "s": t} for p, s, t in done},
           "total_s": time.time() - t0, "launches": launches}
    rec["ok"] = {"wan_guided_fused", "wan_chunked"} <= set(rec["phases"])
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the dry run's fused phases did not run")
    _require_launches(launches, ("flash_attention", "rope_qk",
                                 "conv3d_causal"), "dry run")
    return launches


# ------------------------------------------------------------------ quant

# H100 SXM data sheet: the dense int8 tensor-core rate
PEAK_INT8_OPS = 1979e12
WAN_TOKENS = (DIT_FRAMES // 4 + 1) * (HEIGHT // 16) * (WIDTH // 16)  # 20,280
# the small card-against-CPU checks of the quantized products: rows, and
# (K, N) of a tiny layer and of the Wan FFN's fc1
QUANT_ROWS = (1, 7, 16, 17, 300)
QUANT_KN = ((64, 64), (5120, 13824))
# the int8 GEMM at the Wan2.1-14B shapes: (what, M, K, N)
INT8_GEMMS = (("ffn fc1", WAN_TOKENS, 5120, 13824),
              ("self-attn q", WAN_TOKENS, 5120, 5120),
              ("cross-attn k (text)", TEXT_LEN, 5120, 5120))
# the full-width builds of the generate: (name, builder keywords); W8A8 is
# init_wan_dit_int8, the others init_wan_dit_w4 (FFN-int4 is the build the
# JAX package's bench.py measures)
QUANT_BUILDS = (("w8a8", None),
                ("ffn_int4", {}),
                ("int6_ffn_int4", {"int6_keys": ("fc1", "fc2"),
                                   "int4_keys": ("*",)}))
LORA_SMOKE_RANK = 16
LORA_SMOKE_TARGETS = ("q", "k", "v", "o", "fc1", "fc2")


def _quant_kernel_checks():
    """``dense_q8`` / ``dense_q8_pre`` / ``dense_q4`` / ``dense_q6`` on the
    card against the CPU, from one set of CPU-made weights and inputs:
    the activation codes, the int32 sums and the requantized int4 / int6
    weights exactly equal; the outputs to 1e-6 relative in fp32 and 1 ulp
    in bf16 (the rescale is the same elementwise arithmetic on both)."""
    from worldforge_tpu_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(5)
    card = lambda p: {k: v.cuda() for k, v in p.items()}
    worst = {"fp32_rel": 0.0, "bf16_ulps": 0.0}
    equal = {"activation_codes": True, "int32_sums": True,
             "requantized_weights": True}
    for k, n in QUANT_KN:
        w = torch.randn((k, n), generator=gen) / math.sqrt(k)
        b = torch.randn((n,), generator=gen)
        leaves = {"w8": Q.quantize_dense({"w": w, "b": b}),
                  "w4": Q.quantize_dense_int4({"w": w, "b": b}),
                  "w6": Q.quantize_dense_int6({"w": w, "b": b})}
        on_card = {key: card(p) for key, p in leaves.items()}
        for key, fn in (("w4", Q._requantize_int4_to_int8),
                        ("w6", Q._requantize_int6_to_int8)):
            equal["requantized_weights"] &= torch.equal(
                fn(on_card[key]).cpu(), fn(leaves[key]))
        for m in QUANT_ROWS:
            x = torch.randn((m, k), generator=gen)
            x8, sx = Q.quantize_activations(x)
            x8c, sxc = Q.quantize_activations(x.cuda())
            equal["activation_codes"] &= (torch.equal(x8c.cpu(), x8)
                                          and torch.equal(sxc.cpu(), sx))
            equal["int32_sums"] &= torch.equal(
                Q.int8_matmul(x8c, on_card["w8"]["w8"]).cpu(),
                Q.int8_matmul(x8, leaves["w8"]["w8"]))
            pairs = [(Q.dense_q8_pre(on_card["w8"], x8c, sxc),
                      Q.dense_q8_pre(leaves["w8"], x8, sx))]
            for key, fn in (("w8", Q.dense_q8), ("w4", Q.dense_q4),
                            ("w6", Q.dense_q6)):
                for dt in (torch.float32, torch.bfloat16):
                    pairs.append((fn(on_card[key], x.cuda().to(dt)),
                                  fn(leaves[key], x.to(dt))))
            for got, want in pairs:
                got = got.cpu()
                if want.dtype == torch.float32:
                    worst["fp32_rel"] = max(worst["fp32_rel"], float(
                        (got - want).abs().max() / want.abs().max()))
                else:
                    worst["bf16_ulps"] = max(worst["bf16_ulps"],
                                             bf16_ulps(got, want))
    ok = (all(equal.values()) and worst["fp32_rel"] <= 1e-6
          and worst["bf16_ulps"] <= 1.0)
    emit({"phase": "quant", "part": "kernel_checks_vs_cpu",
          "rows": list(QUANT_ROWS), "k_n": [list(kn) for kn in QUANT_KN],
          "equal_to_cpu": {k: bool(v) for k, v in equal.items()},
          **worst, "tol": {"fp32_rel": 1e-6, "bf16_ulps": 1.0},
          "ok": bool(ok)})
    if not ok:
        raise SystemExit("chip_smoke: the quantized products on the card "
                         "disagree with the CPU")


def _int8_gemm_line():
    """The int8 product (``torch._int_mm``, cuBLASLt) at the Wan2.1-14B
    shapes beside the bf16 ``torch.matmul``, and the unfused work around it:
    the activation quantization, the rescale to bf16, the int4 and int6
    requantization of the weight, and each ``dense_q*`` whole."""
    from worldforge_tpu_torch.ops import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    rows = []
    for what, m, k, n in INT8_GEMMS:
        x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(bf16)
        p8 = Q.quantize_dense({"w": w})
        p4 = Q.quantize_dense_int4({"w": w})
        p6 = Q.quantize_dense_int6({"w": w})
        x8, sx = Q.quantize_activations(x)
        acc = Q.int8_matmul(x8, p8["w8"])
        it = 10 if m > 1000 else 50
        t_b, by = bound(2.0 * m * k * n, m * k + k * n + 4 * m * n,
                        PEAK_INT8_OPS)
        rows.append({
            "what": what, "m_k_n": [m, k, n],
            "int8_ms": cuda_ms(lambda: Q.int8_matmul(x8, p8["w8"]), it),
            "bf16_matmul_ms": cuda_ms(lambda: x @ w, it),
            "quantize_activations_ms": cuda_ms(
                lambda: Q.quantize_activations(x), it),
            "rescale_ms": cuda_ms(
                lambda: Q._rescale(acc, sx, p8["scale"], None, bf16), it),
            "requant_int4_ms": cuda_ms(
                lambda: Q._requantize_int4_to_int8(p4), it),
            "requant_int6_ms": cuda_ms(
                lambda: Q._requantize_int6_to_int8(p6), it),
            "dense_q8_ms": cuda_ms(lambda: Q.dense_q8(p8, x), it),
            "dense_q4_ms": cuda_ms(lambda: Q.dense_q4(p4, x), it),
            "dense_q6_ms": cuda_ms(lambda: Q.dense_q6(p6, x), it),
            "int8_bound_ms": t_b, "int8_bound_by": by})
        del x, w, p8, p4, p6, x8, sx, acc
    torch.cuda.empty_cache()
    emit({"phase": "quant", "part": "int8_gemm", "rows": rows,
          "bound": "int8 GEMM: operations over 1,979 TOPS or bytes (int8 "
                   "in, int32 out) over 3.35 TB/s, the larger"})


def _quant_forward_s(params, cfg):
    """Two forwards at the dit phase's 20,280-token inputs (seed 1): the
    seconds of each, and the output."""
    from worldforge_tpu_torch.models.wan.dit import wan_dit_forward
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat = (DIT_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8)
    x = torch.randn((1, cfg.out_dim) + lat, generator=gen, device="cuda")
    y = torch.randn((1, cfg.in_dim - cfg.out_dim) + lat, generator=gen,
                    device="cuda")
    ctx = torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                      device="cuda")
    clip = torch.randn((1, 257, cfg.clip_dim), generator=gen, device="cuda")
    t = torch.tensor([999.0], device="cuda")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        out = wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip, y=y)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return times, out


def _lora_over_w8a8(params, cfg):
    """Rank-16 adapters on q k v o fc1 fc2 of every block (``init_lora``,
    ``up`` randomised), attached unmerged by ``apply_lora``: the forward at
    20,280 tokens; one layer's LoRA term on the card against an fp64 CPU
    recompute of ``((x @ down) @ up) * scale`` and its whole output against
    the CPU's ``dense`` of the same leaf."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.training.lora import apply_lora, init_lora
    gen = P.make_generator(17, "cuda")
    t0 = time.time()
    lora = init_lora(gen, params, rank=LORA_SMOKE_RANK,
                     targets=LORA_SMOKE_TARGETS)
    for a in lora.values():
        a["up"] = 0.02 * P.normal(gen, tuple(a["up"].shape))
    lp = apply_lora(params, lora, scale=0.5)
    torch.cuda.synchronize()
    attach_s = time.time() - t0
    fwd_s, out = _quant_forward_s(lp, cfg)
    leaf = lp["blocks"][0]["self_attn"]["q"]
    xs = torch.randn((64, cfg.dim), generator=gen, device="cuda")
    term = P.dense({"w": torch.zeros((cfg.dim, cfg.dim), device="cuda"),
                    **{k: v for k, v in leaf.items()
                       if k.startswith("lora_")}}, xs).cpu()
    down, up = leaf["lora_down"].cpu().double(), leaf["lora_up"].cpu().double()
    want = ((xs.cpu().double() @ down) @ up * 0.5).float()
    term_rel = float((term - want).abs().max() / want.abs().max())
    cpu_leaf = {k: v.cpu() for k, v in leaf.items()}
    whole = P.dense(leaf, xs).cpu()
    whole_rel = float((whole - P.dense(cpu_leaf, xs.cpu())).abs().max()
                      / whole.abs().max())
    rec = {"adapters": len(lora), "rank": LORA_SMOKE_RANK,
           "targets": list(LORA_SMOKE_TARGETS), "attach_s": attach_s,
           "adapter_bytes": nbytes(*_leaves(lora)),
           "forward_s": fwd_s, "finite": bool(torch.isfinite(out).all()),
           "layer0_q_term_rel_vs_cpu_fp64": term_rel,
           "layer0_q_output_rel_vs_cpu": whole_rel,
           "term_over_output": float(term.abs().max() / whole.abs().max())}
    return rec, rec["finite"] and term_rel <= 1e-5 and whole_rel <= 1e-5


def _quant_generate(name, kw, warp_dir, ctx, bf16_run, vae):
    """One full-width quantized Wan2.1-I2V-14B: built on the card layer by
    layer from the generate phase's seed (its head randomised as that
    phase's is), then the generate phase's guided repaint on it, its DiT
    forwards timed, then two forwards at 20,280 tokens; W8A8 also the
    forward with adapters, and its layer 0 against ``quantize_tree`` of the
    bf16 layer from the same seed. Returns (launches, ok)."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan import dit
    from worldforge_tpu_torch.ops.quant import quantize_tree
    from worldforge_tpu_torch.pipelines import wan_i2v
    cfg = dit.WanDiTConfig.wan_14b_i2v()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    gen = P.make_generator(0, "cuda")
    params = (dit.init_wan_dit_int8(gen, cfg) if kw is None
              else dit.init_wan_dit_w4(gen, cfg, **kw))
    head = params["head"]["head"]
    head["w"] = (0.02 * P.normal(P.make_generator(99, "cuda"),
                                 tuple(head["w"].shape))).to(head["w"].dtype)
    torch.cuda.synchronize()
    rec = {"phase": "quant", "part": "wan_generate", "build": name,
           "builder": "init_wan_dit_int8" if kw is None else
           f"init_wan_dit_w4({kw or ''})", "build_s": time.time() - t0,
           "build_peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "dit_bytes": nbytes(*_leaves(params)),
           "cuts": {"frames": f"{GEN_FRAMES} of 49",
                    "steps": f"{GEN_STEPS} of 50"}}
    ok = True
    if kw is None:
        one = dit.init_wan_dit_layerwise(P.make_generator(0, "cuda"),
                                         dataclasses.replace(cfg,
                                                             num_layers=1))
        bad = _tree_mismatches(params["blocks"][0],
                               quantize_tree(one)["blocks"][0])
        rec["layer0_equal_quantize_tree"] = not bad
        ok &= not bad
        del one
    pipe = wan_i2v.WanI2VPipeline(dit_params=params, dit_cfg=cfg,
                                  vae_params=vae[0], vae_cfg=vae[1])
    fwd = []
    torch.cuda.reset_peak_memory_stats()
    with timed_calls(wan_i2v, "wan_dit_forward", fwd):
        run = _guided_generate(pipe, warp_dir, ctx)
    out, fp = run["out"], bf16_run["out"]
    picked = {r["step"]: r["channels"] for r in run["flf"]}
    finite = bool(np.isfinite(out).all())
    rec.update({
        "total_s": run["total_s"], "step_s": run["step_s"],
        "dit_forward_s": [r["s"] for r in fwd],
        "final_decode_s": run["final_decode_s"],
        "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "drift_vs_bf16": float(np.abs(fp - out).max() / np.abs(fp).max()),
        "drift_metric": "max|bf16 - q| / max|bf16| over the decoded "
                        "frames (tests/test_int4_quality.py's metric)",
        "flf_channels_by_step": picked,
        "flf_sets_equal_bf16": picked == bf16_run["flf"],
        "launches": run["launches"], "finite": finite,
        "out_shape": list(out.shape)})
    ok &= finite and out.shape == fp.shape
    launches = run["launches"]
    del pipe, run, out
    gc.collect()
    rec["forward_20280_s"], f_out = _quant_forward_s(params, cfg)
    rec["forward_20280_finite"] = bool(torch.isfinite(f_out).all())
    ok &= rec["forward_20280_finite"]
    del f_out
    if kw is None:
        rec["lora"], lora_ok = _lora_over_w8a8(params, cfg)
        ok &= lora_ok
    rec["ok"] = bool(ok)
    emit(rec)
    return launches, ok


def _quant_umt5(ctx):
    """UMT5-XXL W8A8 (``init_umt5_int8`` from the encoders phase's seed) on
    that phase's 512 ids and masks: s, bytes, and the drift from the bf16
    encoder's output (``tests/test_umt5_int8.py``'s metric)."""
    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.encoders import umt5
    ucfg = umt5.UMT5Config.xxl()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    up = umt5.init_umt5_int8(P.make_generator(13, "cuda"), ucfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, ucfg.vocab_size, (2, TEXT_LEN)), device="cuda")
    mask = torch.zeros((2, TEXT_LEN), dtype=torch.int32, device="cuda")
    mask[0, :PROMPT_TOKENS] = 1
    mask[1, :NEGATIVE_TOKENS] = 1
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        text = umt5.umt5_encode(up, ucfg, ids, mask)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    q_bytes, q_embed = nbytes(*_leaves(up)), nbytes(up["embed"])
    q_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del up
    fp = torch.cat([ctx["pe"], ctx["ne"]])
    drift = lambda a: float((a - fp).abs().max() / fp.abs().max())
    # the yardstick: the same bf16 weights with fp32 activations
    bf = umt5.init_umt5(P.make_generator(13, "cuda"), ucfg)
    text32 = umt5.umt5_encode(bf, ucfg, ids, mask,
                              compute_dtype=torch.float32)
    del bf
    ok = (bool(torch.isfinite(text).all())
          and not bool(text[0, PROMPT_TOKENS:].any()))
    emit({"phase": "quant", "part": "umt5_int8", "build_s": build_s,
          "bytes": q_bytes, "embed_bytes": q_embed, "encode_s": times,
          "peak_gb": q_peak, "drift_vs_bf16": drift(text),
          "drift_fp32_compute_vs_bf16": drift(text32),
          "drift_metric": "max|bf16 - q| / max|bf16| over both rows "
                          "(tests/test_umt5_int8.py's metric)", "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: the int8 UMT5 output is wrong")


def _quant_longcat():
    """LongCat-Video-13.6B all-int4 W4A8 (``init_longcat_dit_w4``): built
    on the card, one forward at 20,280 tokens (the guided i2v's shape, a
    cond frame, the hash prompt's mask). Returns the forward's launches."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.longcat import dit
    cfg = dit.LongCatDiTConfig.longcat_13b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = dit.init_longcat_dit_w4(P.make_generator(7, "cuda"), cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    gen = torch.Generator(device="cuda").manual_seed(8)
    t_lat = DIT_FRAMES // 4 + 1
    x = torch.randn((1, cfg.in_channels, t_lat, HEIGHT // 8, WIDTH // 8),
                    generator=gen, device="cuda")
    ctx = torch.randn((1, TEXT_LEN, cfg.caption_channels), generator=gen,
                      device="cuda")
    mask = torch.zeros((1, TEXT_LEN), dtype=torch.int32, device="cuda")
    mask[:, :LC_KV_LEN] = 1
    t = torch.full((1, t_lat), 700.0, device="cuda")
    t[:, 0] = 0.0
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    out = dit.longcat_dit_forward(params, cfg, x, t, ctx,
                                  encoder_attention_mask=mask,
                                  num_cond_latents=1)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    launches = _read_counters()
    ok = (bool(torch.isfinite(out).all())
          and tuple(out.shape) == tuple(x.shape))
    emit({"phase": "quant", "part": "longcat_all_int4", "build_s": build_s,
          "dit_bytes": nbytes(*_leaves(params)), "tokens": LC_TOKENS,
          "forward_s": fwd_s,
          "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "ok": ok})
    del params, out
    if not ok:
        raise SystemExit("chip_smoke: the all-int4 LongCat forward is wrong")
    _require_launches(launches, ("flash_attention", "rope_qk"),
                      "quant LongCat")
    return launches


def phase_quant(warp_dir, ctx, bf16_run):
    """Quantized serving (W8A8 / W4A8 / W6A8, ``ops/quant.py``): the
    products on the card against the CPU (and a small W4A8 generate), the
    int8 GEMM at the Wan shapes, the three full-width Wan builds through
    the generate phase's guided repaint (each freed before the next), a
    LoRA over the W8A8 build, UMT5-XXL int8 and the all-int4 LongCat
    forward. Returns the launches of each path."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    _quant_kernel_checks()
    _small_generate_check(quant={"int4_keys": ("fc1", "fc2")})
    _int8_gemm_line()
    vcfg = WanVAEConfig.wan_2_1()
    vae = (init_wan_vae(P.make_generator(1, "cuda"), vcfg), vcfg)
    by_path = {}
    for name, kw in QUANT_BUILDS:
        launches, ok = _quant_generate(name, kw, warp_dir, ctx, bf16_run,
                                       vae)
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"chip_smoke: the {name} generate is wrong")
        _require_launches(launches, WAN_PATH_KERNELS, f"quant {name}")
        by_path[f"quant_{name}"] = launches
    del vae
    _quant_umt5(ctx)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["quant_longcat_all_int4"] = _quant_longcat()
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


# ------------------------------------------------------------------ train

# The Wan DiT's fp32 islands: the leaves init_wan_dit keeps fp32 in a bf16
# build (adaLN modulation, time embedding and projection)
WAN_FP32_ISLANDS = ("modulation", "time_embedding", "time_projection")
TRAIN_STEPS_WAN14B, TRAIN_STEPS_T2V13B, TRAIN_STEPS_LONGCAT = 3, 3, 2
TRAIN_RANK = 16
T2V_TRAIN_TOKENS = (T2V_PUBLISHED_FRAMES // 4 + 1) * (HEIGHT // 16) * (
    WIDTH // 16)                                                  # 32,760
WAN_TRAIN_KERNELS = ("flash_attention", "flash_attention_backward",
                     "rope_qk", "rope_qk_backward", "modulated_layer_norm",
                     "modulated_layer_norm_backward")
LONGCAT_TRAIN_KERNELS = ("flash_attention", "flash_attention_backward",
                         "rope_qk", "rope_qk_backward")


def _bf16_layout(params):
    """An fp32 Wan DiT tree cast (differentiably) to the dtypes of a bf16
    ``init_wan_dit``: every leaf bf16 but the fp32 islands."""
    def walk(node, fp32):
        if isinstance(node, dict):
            return {k: walk(v, fp32 or k in WAN_FP32_ISLANDS)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, fp32) for v in node]
        return node if fp32 else node.to(torch.bfloat16)
    return walk(params, False)


def _bf16_compute_forward(params, cfg, x, t, ctx, **kw):
    """``make_train_step``'s forward for fp32 master weights with bf16
    compute: the Wan forward on the bf16 layout of the weights (gradients
    flow back to the fp32 leaves through the casts)."""
    from worldforge_tpu_torch.training.step import _wan_forward
    return _wan_forward(_bf16_layout(params), cfg, x, t, ctx, **kw)


def _block_lora(gen, params, rank):
    """Rank-``rank`` adapters on every LORA_TARGETS leaf of the blocks."""
    from worldforge_tpu_torch.training import init_lora
    return {p: a for p, a in init_lora(gen, params, rank=rank).items()
            if p.startswith("blocks/")}


def _train_inputs(shape, ctx_dim, gen, y_ch=0, clip_dim=0):
    x0 = torch.randn(shape, generator=gen, device="cuda")
    batch = {"x0": x0, "context": torch.randn(
        (shape[0], TEXT_LEN, ctx_dim), generator=gen, device="cuda")}
    if y_ch:
        batch["y"] = torch.randn((shape[0], y_ch) + tuple(shape[2:]),
                                 generator=gen, device="cuda")
        batch["clip_fea"] = torch.randn((shape[0], 257, clip_dim),
                                        generator=gen, device="cuda")
    return batch


def _run_train(name, step, state, batch, steps, kernels, extra):
    """``steps`` steps of a train step on the card (launch counts from 0
    just before the first, read after each), one JSON line; returns the
    run's launches."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    losses, secs, per_step = [], [], []
    prev = {k: 0 for k in kernel_counters()}
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(state, batch, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        now = _read_counters()
        per_step.append({k: now[k] - prev[k] for k in kernels})
        prev = dict(now)
    launches = _read_counters()
    ok = all(math.isfinite(v) for v in losses)
    emit({"phase": "train", "part": name, "steps": steps, "losses": losses,
          "step_s": secs, "peak_gb": torch.cuda.max_memory_allocated()
          / 2 ** 30, "launches_per_step": per_step,
          "launches": {k: launches[k] for k in kernels}, **extra,
          "ok": ok and extra.get("ok", True)})
    if not (ok and extra.get("ok", True)):
        raise SystemExit(f"chip_smoke: the {name} training run is wrong")
    _require_launches(launches, kernels, f"train {name}")
    return launches


def _small_train_check():
    """A widened tiny Wan2.1 i2v (2 layers, 2 heads of 128: the kernels'
    instantiation) takes one ``make_lora_train_step`` step on the card and
    one on the CPU from one set of bf16 weights (drawn on the CPU, zero
    leaves randomised), rank-4 adapters (``up`` randomised so both factors
    get gradients), one sigma and noise: the loss within 1e-2 relative and
    each adapter gradient within 5e-2 relative L2 (bf16 activations and
    upstream gradients, rounded in other places on the two sides, through
    both layers' chains)."""
    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, init_wan_dit
    from worldforge_tpu_torch.training import (make_lora_train_step,
                                               trainable_leaves)
    cfg = WanDiTConfig(model_type="i2v", dim=256, ffn_dim=512, num_heads=2,
                       num_layers=2, text_len=16, text_dim=64, freq_dim=32)
    gen = P.make_generator(3)
    base = _randomize_zero_leaves(init_wan_dit(gen, cfg), gen)
    lora = _randomize_zero_leaves(_block_lora(gen, base, 4), gen, std=0.05)
    rng = np.random.default_rng(4)
    grid = (3, 18, 20)                            # 3 x 9 x 10 = 270 tokens
    arrays = {"x0": (1, cfg.out_dim) + grid, "y": (1, cfg.in_dim -
                                                  cfg.out_dim) + grid,
              "context": (1, cfg.text_len, cfg.text_dim),
              "clip_fea": (1, 257, cfg.clip_dim)}
    batch = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in arrays.items()}
    sigma = torch.tensor([0.63])
    noise = torch.from_numpy(rng.standard_normal(arrays["x0"]).astype(
        np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        mv = lambda t: P.tree_map(lambda a: a.to(dev), t)
        b_, l_ = mv(base), mv({p: {k: v.clone() for k, v in a.items()}
                               for p, a in lora.items()})
        opt = torch.optim.AdamW(trainable_leaves(l_), lr=1e-3,
                                weight_decay=1e-4)
        step = make_lora_train_step(cfg, opt, b_)
        loss = step(l_, mv(batch), sigma=sigma.to(dev), noise=noise.to(dev))
        out[dev] = (float(loss), {p: {k: v.grad.float().cpu()
                                      for k, v in a.items()}
                                  for p, a in l_.items()})
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = max(_rel_l2(out["cuda"][1][p][k], out["cpu"][1][p][k])
                   for p in lora for k in ("down", "up"))
    ok = loss_rel <= 1e-2 and grad_rel <= 5e-2
    emit({"phase": "train", "part": "small_lora_step_vs_cpu",
          "config": "tiny i2v widened: 2 layers, dim 256, 2 heads of 128",
          "tokens": math.prod(grid) // 4, "loss_card": out["cuda"][0],
          "loss_cpu": out["cpu"][0], "loss_rel_err": loss_rel,
          "tol_loss_rel": 1e-2, "max_grad_rel_l2_err": grad_rel,
          "tol_grad_rel_l2": 5e-2, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: the small LoRA step disagrees card "
                         "against CPU")


def _train_wan14b_lora():
    """Wan2.1-I2V-14B (published widths and depth, random bf16 weights with
    the zero leaves randomised) with rank-16 adapters on every
    LORA_TARGETS leaf of the 40 blocks, ``make_lora_train_step`` with
    remat and AdamW (lr 1e-4, weight decay 1e-4) on 49 x 480 x 832
    latents [1, 16, 13, 60, 104] (20,280 tokens) with ``y``, a 512-token
    context and 257 CLIP tokens."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, init_wan_dit
    from worldforge_tpu_torch.training import (make_lora_train_step,
                                               trainable_leaves)
    cfg = WanDiTConfig.wan_14b_i2v()
    gen = P.make_generator(21, "cuda")
    base = _randomize_zero_leaves(init_wan_dit(gen, cfg), gen)
    lora = _block_lora(gen, base, TRAIN_RANK)
    watch = {"blocks/0/self_attn/q/w": base["blocks"][0]["self_attn"]["q"]["w"],
             "blocks/39/ffn/fc2/w": base["blocks"][39]["ffn"]["fc2"]["w"],
             "head/head/w": base["head"]["head"]["w"]}
    before = {k: v.clone() for k, v in watch.items()}
    up0 = {p: a["up"].clone() for p, a in lora.items()}
    opt = torch.optim.AdamW(trainable_leaves(lora), lr=1e-4,
                            weight_decay=1e-4)
    step = make_lora_train_step(cfg, opt, base, remat=True)
    batch = _train_inputs((1, 16, DIT_FRAMES // 4 + 1, HEIGHT // 8,
                           WIDTH // 8), cfg.text_dim, gen, y_ch=20,
                          clip_dim=cfg.clip_dim)
    moved = lambda: sum(int(not torch.equal(a["up"], up0[p]))
                        for p, a in lora.items())
    extra = {"model": "Wan2.1-I2V-14B", "mode": "lora", "rank": TRAIN_RANK,
             "adapters": len(lora), "adapter_params": sum(
                 t.numel() for a in lora.values() for t in a.values()),
             "tokens": LC_TOKENS, "remat": True}
    launches = _run_train("wan_i2v_14b_lora", step, lora, batch,
                          TRAIN_STEPS_WAN14B, WAN_TRAIN_KERNELS, extra)
    unchanged = {k: torch.equal(v, before[k]) for k, v in watch.items()}
    n_moved = moved()
    emit({"phase": "train", "part": "wan_i2v_14b_lora_state",
          "adapters_moved": n_moved, "adapters": len(lora),
          "base_unchanged": unchanged,
          "ok": n_moved == len(lora) and all(unchanged.values())})
    if n_moved != len(lora) or not all(unchanged.values()):
        raise SystemExit("chip_smoke: the 14B LoRA run moved the base or "
                         "left adapters still")
    return launches


def _train_wan1_3b_full():
    """Wan2.1-T2V-1.3B (``wan_1_3b_t2v``, the published widths) fully
    fine-tuned: fp32 parameters, bf16 compute, AdamW (lr 1e-5, weight decay
    1e-4), remat, on 81 x 480 x 832 latents [1, 16, 21, 60, 104] (32,760
    tokens) and a 512-token context."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, init_wan_dit
    from worldforge_tpu_torch.training import (make_train_step,
                                               trainable_leaves)
    cfg = WanDiTConfig.wan_1_3b_t2v()
    gen = P.make_generator(22, "cuda")
    params = _randomize_zero_leaves(init_wan_dit(gen, cfg,
                                                 dtype=torch.float32), gen)
    leaves = trainable_leaves(params)
    w0 = params["blocks"][0]["self_attn"]["q"]["w"].detach().clone()
    opt = torch.optim.AdamW(leaves, lr=1e-5, weight_decay=1e-4)
    step = make_train_step(cfg, opt, remat=True,
                           forward_fn=_bf16_compute_forward)
    batch = _train_inputs((1, 16, T2V_PUBLISHED_FRAMES // 4 + 1,
                           HEIGHT // 8, WIDTH // 8), cfg.text_dim, gen)
    n = sum(t.numel() for t in leaves)
    extra = {"model": "Wan2.1-T2V-1.3B", "mode": "full fine-tune",
             "params": n, "param_dtype": "float32", "compute": "bfloat16",
             "tokens": T2V_TRAIN_TOKENS, "remat": True,
             "note": "a 14B full fine-tune needs 16 B a parameter (fp32 "
                     "weights, gradients and two Adam moments): ~224 GB at "
                     "14B, more than one card's 80 GB"}
    launches = _run_train("wan_t2v_1_3b_full", step, params, batch,
                          TRAIN_STEPS_T2V13B, WAN_TRAIN_KERNELS, extra)
    moved = not torch.equal(params["blocks"][0]["self_attn"]["q"]["w"], w0)
    emit({"phase": "train", "part": "wan_t2v_1_3b_full_state",
          "params_moved": moved, "ok": moved})
    if not moved:
        raise SystemExit("chip_smoke: the 1.3B fine-tune left its weights")
    return launches


def _train_longcat_lora():
    """LongCat-Video-13.6B (published widths and depth, random bf16
    weights, zero leaves randomised) with rank-16 adapters on every
    LORA_TARGETS leaf of the 48 blocks, ``make_lora_train_step`` through
    ``longcat_forward`` (remat, AdamW lr 1e-4) on [1, 16, 13, 60, 104]
    latents (20,280 tokens) and a 512-token context."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                         init_longcat_dit)
    from worldforge_tpu_torch.training import (longcat_forward,
                                               make_lora_train_step,
                                               trainable_leaves)
    cfg = LongCatDiTConfig.longcat_13b()
    gen = P.make_generator(23, "cuda")
    base = _randomize_zero_leaves(init_longcat_dit(gen, cfg), gen)
    lora = _block_lora(gen, base, TRAIN_RANK)
    w0 = base["blocks"][0]["qkv"]["w"].clone()
    opt = torch.optim.AdamW(trainable_leaves(lora), lr=1e-4,
                            weight_decay=1e-4)
    step = make_lora_train_step(cfg, opt, base, remat=True,
                                forward_fn=longcat_forward)
    batch = _train_inputs((1, cfg.in_channels, DIT_FRAMES // 4 + 1,
                           HEIGHT // 8, WIDTH // 8), cfg.caption_channels,
                          gen)
    extra = {"model": "LongCat-Video-13.6B", "mode": "lora",
             "rank": TRAIN_RANK, "adapters": len(lora),
             "tokens": LC_TOKENS, "remat": True}
    launches = _run_train("longcat_13b_lora", step, lora, batch,
                          TRAIN_STEPS_LONGCAT, LONGCAT_TRAIN_KERNELS, extra)
    if not torch.equal(base["blocks"][0]["qkv"]["w"], w0):
        raise SystemExit("chip_smoke: the LongCat LoRA run moved the base")
    return launches


def phase_train():
    """Training (``training/step.py``, ``make_lora_train_step``): the small
    LoRA step card against CPU, then the Wan2.1-I2V-14B LoRA, the
    Wan2.1-T2V-1.3B full fine-tune and the LongCat-13.6B LoRA, each freed
    before the next. Returns each run's launches."""
    _small_train_check()
    by_path = {}
    for name, run in (("train_wan_i2v_14b_lora", _train_wan14b_lora),
                      ("train_wan_t2v_1_3b_full", _train_wan1_3b_full),
                      ("train_longcat_13b_lora", _train_longcat_lora)):
        by_path[name] = run()
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def _stage1_video(t, h, w, seed=0):
    """A smooth moving pattern with a little noise, [T, H, W, 3] in [0, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((t, h, w, 3), np.float32)
    for i in range(t):
        base = 0.5 + 0.4 * np.sin((xx + 6 * i) / 41.0) * np.cos(yy / 29.0)
        for c in range(3):
            frames[i, ..., c] = base * (0.8 + 0.1 * c)
    frames += 0.03 * rng.standard_normal(frames.shape).astype(np.float32)
    return np.clip(frames, 0.0, 1.0)


def _small_refine_check():
    """The reduced random-init LongCat refine (the loader's default configs,
    default bf16 policy; weights drawn on the CPU and copied to the card) at
    13 x 64 x 128 -> 128 x 256, spatial only, block-sparse attention at
    sparsity 0.5 on its 4 chunks: run on the card with the kernels and on
    the CPU with their plain versions, from one noise stream."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    pipe, enc_t = load_longcat_pipeline(random_init=True, device="cpu")
    on_card = dataclasses.replace(
        pipe, dit_params=P.tree_map(lambda t: t.cuda(), pipe.dit_params),
        vae_params=P.tree_map(lambda t: t.cuda(), pipe.vae_params))
    stage1 = _stage1_video(13, 64, 128, seed=3)
    pe, pmask = enc_t(REFINE_PROMPT)
    _reset_counters()
    outs = {}
    for dev, p in (("cuda", on_card), ("cpu", pipe)):
        noise = np.random.default_rng(11)
        outs[dev] = p.generate_refine(
            None, stage1, pe, pmask, height=128, width=256,
            num_inference_steps=4, t_thresh=0.5, spatial_refine_only=True,
            bsa_sparsity=0.5, output_type="latent",
            noise_fn=lambda s: noise.standard_normal(s).astype(np.float32)
        ).float().cpu()
        if dev == "cuda":
            launches = _read_counters()
    a, b = outs["cuda"], outs["cpu"]
    rel_l2 = float((a - b).norm() / b.norm())
    rel_max = float((a - b).abs().max() / b.abs().max())
    # bf16 policy: the DiT's bf16 products and the conv's bf16 input
    # rounding differ in the last bits between cuBLAS / the kernels and the
    # CPU, and flips compound over the steps: bf16 noise level
    tol = 2e-2
    ok = (bool(torch.isfinite(a).all()) and tuple(a.shape) == (1, 16, 4, 16, 32)
          and rel_l2 < tol)
    emit({"phase": "refine_small_vs_cpu", "shape": list(a.shape),
          "rel_l2": rel_l2, "rel_max": rel_max, "tol_rel_l2": tol,
          "launches_on_card": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small refine disagrees with the CPU "
                         "run of the plain versions")
    _require_launches(launches, REFINE_PATH_KERNELS, "small refine")


def phase_refine():
    """The LongCat 480p -> 720p refine at full width and depth through the
    user's entry points (``run_upscale`` calls the same two)."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig

    _small_refine_check()

    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe, encode_text = load_longcat_pipeline(
        random_init=True, device="cuda",
        dit_cfg=LongCatDiTConfig.longcat_13b(),
        vae_cfg=WanVAEConfig.wan_2_1())
    pipe = dataclasses.replace(pipe, streaming_vae=True)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    sizes = []
    P.tree_map(lambda t: sizes.append(t.numel() * t.element_size()),
               pipe.dit_params)
    dit_gb = sum(sizes) / 2 ** 30

    stage1 = _stage1_video(REFINE_FRAMES, STAGE1_H, STAGE1_W)
    pe, pmask = encode_text(REFINE_PROMPT)
    gen = torch.Generator(device="cuda").manual_seed(42)
    marks = []

    def on_step(i, lat):
        torch.cuda.synchronize()
        marks.append(time.time())

    encode = {}
    prepare = pipe.prepare_refine_latents

    def timed_prepare(*args, **kwargs):
        t1 = time.time()
        lat = prepare(*args, **kwargs)
        torch.cuda.synchronize()
        encode["s"] = time.time() - t1
        encode["shape"] = list(lat.shape)
        return lat

    pipe.prepare_refine_latents = timed_prepare
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    out = pipe.generate_refine(
        gen, stage1, pe, pmask, height=REFINE_H, width=REFINE_W,
        num_inference_steps=REFINE_STEPS, t_thresh=0.5,
        spatial_refine_only=True, use_bsa=True, bsa_sparsity=BSA_SPARSITY,
        callback=on_step)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    step_s = [b - a for a, b in zip([t0 + encode["s"]] + marks[:-1], marks)]
    want = (1, 3, REFINE_FRAMES, REFINE_H, REFINE_W)
    ok_shape = out.shape == want
    finite = bool(np.isfinite(out).all())
    emit({"phase": "refine", "config": "longcat_13b + wan_2_1 vae (streaming)",
          "cuts": {"steps": f"num_inference_steps {REFINE_STEPS} of 50: "
                   f"{len(marks)} steps below t_thresh 0.5 (production: 26)"},
          "stage1": [REFINE_FRAMES, STAGE1_H, STAGE1_W],
          "height": REFINE_H, "width": REFINE_W,
          "latents": encode.get("shape"), "tokens": REFINE_TOKENS,
          "bsa_sparsity": BSA_SPARSITY, "kv_len": int(pmask.sum()),
          "dit_weights_gb": dit_gb, "init_s": init_s,
          "encode_s": encode.get("s"), "step_s": step_s,
          "decode_s": total_s - (marks[-1] - t0), "total_s": total_s,
          "launches": launches, "memory_allocated_before_gb": before_gb,
          "launches_per_step": {k: launches[k] / len(marks)
                                for k in ("rope_qk", "bsa")},
          "out_shape": list(out.shape), "finite": finite,
          "out_range": [float(out.min()), float(out.max())],
          "max_memory_allocated_gb":
          torch.cuda.max_memory_allocated() / 2 ** 30})
    if not (ok_shape and finite):
        raise SystemExit("chip_smoke: refine output is wrong")
    _require_launches(launches, REFINE_PATH_KERNELS + ("conv2d_3x3",),
                      "refine")
    _profile_refine_forward(pipe, encode["shape"], pe, pmask)
    nccl = _parallel_nccl_longcat(pipe, encode["shape"], pe, pmask)
    del pipe.prepare_refine_latents, out
    return launches, (pipe, encode_text, init_s), nccl


def _guided_inputs(t, h, w, seed=0):
    """A warped-video stand-in [1, 3, T, H, W] in [0, 1] (the moving
    pattern of ``_stage1_video``), a mask trusting its left half, and the
    first frame in [-1, 1]."""
    import numpy as np
    frames = _stage1_video(t, h, w, seed).transpose(3, 0, 1, 2)[None]
    frames = np.ascontiguousarray(frames)
    mask = np.zeros((1, 1, t, h, w), np.float32)
    mask[..., : w // 2] = 1.0
    return frames, mask, frames[:, :, 0] * 2.0 - 1.0


def _small_longcat_check():
    """The reduced random-init LongCat (the loader's default configs, fp32
    policy; weights drawn on the CPU and copied to the card) through
    ``generate_i2v`` guided with FLF (distill, and standard with CFG) and
    ``generate_vc`` (fp32 cache), on the card with the kernels and on the
    CPU with their plain versions, from one noise stream each."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
    pipe, enc_t = load_longcat_pipeline(random_init=True, device="cpu",
                                        policy=FP32_POLICY)
    on_card = dataclasses.replace(
        pipe, dit_params=P.tree_map(lambda t: t.cuda(), pipe.dit_params),
        vae_params=P.tree_map(lambda t: t.cuda(), pipe.vae_params))
    f, hw, steps = 9, 128, 4
    frames, mask, image = _guided_inputs(f, hw, hw, seed=5)
    pe, pmask = enc_t(LC_PROMPT)
    ne, nmask = enc_t("a negative prompt")
    guide = GuidanceConfig(guided=True, guide_steps=steps, resample_steps=2,
                           resample_round=steps, omega=1.8,
                           flf_backend="longcat", max_replace=2)
    runs = {
        "i2v distill": lambda p: p.generate_i2v(
            None, image, pe, pmask, height=hw, width=hw, num_frames=f,
            num_inference_steps=steps, use_distill=True, video_ref=frames,
            mask=mask, guidance=guide, output_type="latent",
            noise_fn=noise_fn()),
        "i2v standard cfg": lambda p: p.generate_i2v(
            None, image, pe, pmask, ne, nmask, height=hw, width=hw,
            num_frames=f, num_inference_steps=steps, guidance_scale=4.0,
            video_ref=frames, mask=mask, guidance=guide,
            output_type="latent", noise_fn=noise_fn()),
        "vc fp32 cache": lambda p: p.generate_vc(
            None, frames[:, :, :5] * 2.0 - 1.0, pe, pmask, height=hw,
            width=hw, num_frames=13, num_cond_frames=5,
            num_inference_steps=3, enhance_hf=False, output_type="latent",
            noise_fn=noise_fn()),
    }

    def noise_fn():
        rng = np.random.default_rng(13)
        return lambda s: rng.standard_normal(s).astype(np.float32)

    tol = 2e-2
    for name, run in runs.items():
        outs, picked = {}, {}
        for dev, p in (("cuda", on_card), ("cpu", pipe)):
            _reset_counters()
            with timed_calls(guidance, "flf_select", [], flf_record) as sel:
                outs[dev] = run(p).float().cpu()
            if dev == "cuda":
                launches = _read_counters()
            picked[dev] = {r["step"]: r["channels"] for r in sel}
        a, b = outs["cuda"], outs["cpu"]
        rel_l2 = float((a - b).norm() / b.norm())
        rel_max = float((a - b).abs().max() / b.abs().max())
        need = ("flash_attention",) if name.startswith("vc") \
            else LONGCAT_GUIDED_PATH_KERNELS
        ok = bool(torch.isfinite(a).all()) and rel_l2 < tol
        emit({"phase": "longcat_small_vs_cpu", "run": name,
              "shape": list(a.shape), "flf_channels_by_step_card":
              picked["cuda"], "flf_sets_equal_cpu":
              picked["cuda"] == picked["cpu"], "rel_l2": rel_l2,
              "rel_max": rel_max, "tol_rel_l2": tol,
              "launches_on_card": launches, "ok": ok})
        if not ok:
            raise SystemExit(f"chip_smoke: small LongCat {name} disagrees "
                             f"with the CPU run of the plain versions")
        _require_launches(launches, need, f"small LongCat {name}")


def phase_longcat_guided(pipe, encode_text, init_s):
    """The LongCat guided i2v at full width and depth through the user's
    entry points (``run_longcat`` calls the same two): the refine phase's
    pipeline (``load_longcat_pipeline``, LongCat-13.6B, the streaming
    Wan2.1 VAE), ``generate_i2v`` at 480x832 x 49 frames (13 x 60 x 104
    latents, 20,280 tokens, 1,560 of them cond), the distill table without
    CFG, guided on every step (IRR 2, FLF with max_replace 2), with the
    step cut listed on its line."""
    from worldforge_tpu_torch.pipelines import longcat
    from worldforge_tpu_torch.sampling import guidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    _small_longcat_check()

    frames, mask, image = _guided_inputs(DIT_FRAMES, HEIGHT, WIDTH, seed=1)
    pe, pmask = encode_text(LC_PROMPT)
    guide = GuidanceConfig(guided=True, guide_steps=LC_GUIDED_STEPS,
                           resample_steps=2, resample_round=LC_GUIDED_STEPS,
                           omega=1.8, omega_resample=1.0,
                           flf_backend="longcat", max_replace=2)
    gen = torch.Generator(device="cuda").manual_seed(42)
    marks = []

    def on_step(i, lat):
        torch.cuda.synchronize()
        marks.append(time.time())

    before_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    peaks = []
    with timed_calls(guidance, "flf_select", [], flf_record) as flf, \
            timed_calls(guidance, "fuse_latents", [], peaks=peaks) as fuse, \
            timed_calls(longcat, "longcat_dit_forward", [],
                        peaks=peaks) as fwd:
        out = pipe.generate_i2v(
            gen, image, pe, pmask, height=HEIGHT, width=WIDTH,
            num_frames=DIT_FRAMES, num_inference_steps=LC_GUIDED_STEPS,
            use_distill=True, video_ref=frames, mask=mask, guidance=guide,
            callback=on_step)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    peak_gb = max(peaks + [r["peak_gb"] for r in fuse + fwd]
                  + [torch.cuda.max_memory_allocated() / 2 ** 30])
    import numpy as np
    step_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    handed = {r["step"]: r["channels"] for r in flf}
    want = (1, 3, DIT_FRAMES, HEIGHT, WIDTH)
    ok_shape = out.shape == want
    finite = bool(np.isfinite(out).all())
    handed_ok = all(len(handed.get(i, [])) == 1 for i in (2, 3))
    emit({"phase": "longcat_guided",
          "config": "longcat_13b + wan_2_1 vae (streaming)",
          "cuts": {"steps": f"num_inference_steps {LC_GUIDED_STEPS} of the "
                   f"16-step distill table (production: 16)"},
          "height": HEIGHT, "width": WIDTH, "frames": DIT_FRAMES,
          "latents": [16, DIT_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8],
          "tokens": LC_TOKENS, "cond_tokens": LC_COND_TOKENS,
          "use_distill": True, "cfg": False, "resample_steps": 2,
          "guide_steps": LC_GUIDED_STEPS, "use_flf": True, "max_replace": 2,
          "kv_len": int(pmask.sum()), "init_s_shared_with_refine": init_s,
          "total_s": total_s, "step_s": step_s,
          "s_per_step": (marks[-1] - t0) / len(marks),
          "flf_s_by_step": {r["step"]: r["s"] for r in flf},
          "fuse_s": [r["s"] for r in fuse],
          "dit_forward_s": [r["s"] for r in fwd],
          "peak_gb_dit_forward": max(r["peak_gb"] for r in fwd),
          "peak_gb_fuse": max(r["peak_gb"] for r in fuse),
          "final_decode_s": total_s - (marks[-1] - t0),
          "channels_handed_back_by_step": handed,
          "launches": launches,
          "launches_per_step": {k: v / len(marks)
                                for k, v in launches.items()},
          "out_shape": list(out.shape), "finite": finite,
          "out_range": [float(out.min()), float(out.max())],
          "memory_allocated_before_gb": before_gb,
          "max_memory_allocated_gb": peak_gb})
    if not (ok_shape and finite and handed_ok):
        raise SystemExit("chip_smoke: LongCat guided output is wrong")
    _require_launches(launches, LONGCAT_GUIDED_PATH_KERNELS,
                      "LongCat guided")
    fused_launches = _longcat_guided_fused(
        pipe, (image, pe, pmask, frames, mask, guide), out,
        {"s_per_step": (marks[-1] - t0) / len(marks), "peak_gb": peak_gb})
    del out
    _profile_longcat_guided_forward(pipe, pe, pmask)
    return launches, fused_launches


def _longcat_guided_fused(pipe, inputs, want, unfused):
    """The LongCat guided i2v of ``phase_longcat_guided`` again through
    ``generate_i2v(fused=True)`` (every step a CUDA graph replay, FLF on
    the card) from the same generator seed, against the host loop's output
    ``want``. Returns its launches (replays counted)."""
    import numpy as np
    image, pe, pmask, frames, mask, guide = inputs
    on_step, marks, _ = _step_marks()
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.time()
    out = pipe.generate_i2v(
        gen, image, pe, pmask, height=HEIGHT, width=WIDTH,
        num_frames=DIT_FRAMES, num_inference_steps=LC_GUIDED_STEPS,
        use_distill=True, video_ref=frames, mask=mask, guidance=guide,
        callback=on_step, fused=True)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    step_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    a, b = np.asarray(out, np.float64), np.asarray(want, np.float64)
    rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    rec = {"phase": "fused", "part": "longcat_13b_guided",
           "config": "longcat_13b + wan_2_1 vae (streaming)",
           "cuts": {"steps": f"num_inference_steps {LC_GUIDED_STEPS} of "
                    "the 16-step distill table (production: 16)"},
           "total_s": total_s, "step_s": step_s,
           "s_per_step": {"fused_steady": sum(step_s[1:]) /
                          max(1, len(step_s) - 1),
                          "unfused": unfused["s_per_step"]},
           "unfused_note": "the unfused run is timed with a synchronize "
                           "around each DiT forward, fuse and FLF call",
           "peak_gb": {"fused": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "unfused": unfused["peak_gb"]},
           "out_shape": list(out.shape),
           "finite": bool(np.isfinite(out).all()),
           "fused_vs_unfused_rel_l2": rel_l2, "tol_rel_l2": FUSED_TOL,
           "launches": launches}
    rec["ok"] = rec["finite"] and rel_l2 < FUSED_TOL
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the fused LongCat guided i2v "
                         "disagrees with its host loop")
    _require_launches(launches, LONGCAT_GUIDED_PATH_KERNELS,
                      "LongCat guided fused")
    return launches


def _profile_longcat_guided_forward(pipe, pe, pmask):
    """One DiT forward at the guided i2v shape (20,280 tokens, the cond
    frame at timestep 0 attending to itself only), as ``generate_i2v``
    calls it."""
    from worldforge_tpu_torch.models.longcat.dit import longcat_dit_forward
    gen = torch.Generator(device="cuda").manual_seed(7)
    t_lat = DIT_FRAMES // 4 + 1
    x = torch.randn((1, 16, t_lat, HEIGHT // 8, WIDTH // 8), generator=gen,
                    device="cuda")
    t = torch.full((1, t_lat), 500.0, device="cuda")
    t[:, 0] = 0.0

    def forward():
        return longcat_dit_forward(
            pipe.dit_params, pipe.dit_cfg, x, t, pe,
            encoder_attention_mask=pmask, num_cond_latents=1,
            policy=pipe.policy)

    _profile_forward(forward, "longcat_guided_profile", "one LongCat-13.6B "
                     "DiT forward at the guided i2v shape (20,280 tokens, "
                     "1,560 cond) under torch.profiler",
                     {"tokens": LC_TOKENS})


KERNEL_GROUPS = (
    ("bsa (kernel 5)", ("bsatiles",)),
    ("flash attention (kernel 1)", ("densetiles", "attn_short_kernel",
                                    "fa_f32_wgmma_kernel",
                                    "fa_f32_scores_kernel",
                                    "fa_f32_pv_kernel")),
    ("rope (kernel 2)", ("rope_qk_kernel",)),
    ("modulated LN (kernel 3)", ("mod_ln_kernel",)),
    ("conv3d (kernel 4)", ("conv3d_kernel",)),
    ("other convs (cuDNN)", ("fprop", "convolve", "conv2d", "conv3d",
                             "cudnn", "winograd", "implicit", "nchwtonhwc",
                             "nhwctonchw")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("memcpy / memset", ("memcpy", "memset")),
)


def _randomize_zero_leaves(tree, gen, std=0.02):
    """Every all-zero floating leaf of a param tree -> N(0, std^2) drawn
    from ``gen`` on the leaf's device (the zero-initialised Wan head, FLF2V's
    ``emb_pos``, VACE's ``before_proj`` / ``after_proj``, the biases), so no
    branch of the forward hides behind a zero."""
    from worldforge_tpu_torch.core import params as P

    def f(t):
        if t.is_floating_point() and t.numel() and not bool(t.any()):
            return (std * P.normal(gen, tuple(t.shape))).to(t.dtype)
        return t
    return P.tree_map(f, tree)


def _to_card(tree):
    from worldforge_tpu_torch.core import params as P
    return P.tree_map(lambda t: t.cuda(), tree)


def _rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def _numpy_noise(seed):
    """A numpy noise stream for ``noise_fn``: the same draws on both sides
    of a card-vs-CPU check."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return lambda s: rng.standard_normal(s).astype(np.float32)


def _small_wan_facades_check():
    """Reduced T2V, FLF2V and VACE pipelines (the random-init loader's
    widths, 2 layers, the small VAE; fp32 policy; every zero leaf
    randomised; weights drawn on the CPU and copied to the card), 3 UniPC
    steps with CFG, on the card with the kernels and on the CPU with their
    plain versions from one noise stream; ``prepare_vace_context`` with two
    reference images; ``VaceVideoProcessor``'s resize of a synthetic uint8
    video on the card against the CPU; one ``dpm_update`` of each order."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io import vace_processor as vp
    from worldforge_tpu_torch.io.checkpoints import DEFAULT_RANDOM_VAE
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     init_wan_dit)
    from worldforge_tpu_torch.models.wan.vace import VaceConfig, init_vace
    from worldforge_tpu_torch.models.wan.vae import init_wan_vae
    from worldforge_tpu_torch.pipelines.wan_t2v import WanT2VPipeline
    from worldforge_tpu_torch.pipelines.wan_vace import (
        WanVacePipeline, prepare_vace_context)
    from worldforge_tpu_torch.sampling import dpm

    z = DEFAULT_RANDOM_VAE.z_dim
    kw = dict(out_dim=z, dim=256, ffn_dim=512, num_heads=4, num_layers=2,
              text_len=16, text_dim=64)
    gen = P.make_generator(31)
    vae = _randomize_zero_leaves(init_wan_vae(gen, DEFAULT_RANDOM_VAE), gen)
    rng = np.random.default_rng(32)
    f32 = lambda a: a.astype(np.float32)
    f, hw = 5, 64
    pe, ne = (f32(rng.standard_normal((1, 16, 64))) for _ in range(2))
    first, last = (f32(rng.uniform(-1, 1, (1, 3, hw, hw))) for _ in range(2))
    clip2 = f32(rng.standard_normal((1, 514, 1280)))
    src = f32(rng.uniform(-1, 1, (1, 3, f, hw, hw)))
    mask = np.zeros((1, 1, f, hw, hw), np.float32)
    mask[..., hw // 2:] = 1.0

    def wan(model_type, in_dim):
        cfg = WanDiTConfig(model_type=model_type, in_dim=in_dim, **kw)
        params = _randomize_zero_leaves(
            init_wan_dit(gen, cfg, dtype=torch.float32), gen)
        return WanT2VPipeline(dit_params=params, dit_cfg=cfg,
                              vae_params=vae, vae_cfg=DEFAULT_RANDOM_VAE,
                              policy=FP32_POLICY)

    vcfg = VaceConfig(base=WanDiTConfig(model_type="t2v", in_dim=z, **kw),
                      vace_layers=(0, 1), vace_in_dim=2 * z + 64)
    vace = WanVacePipeline(
        vace_params=_randomize_zero_leaves(
            init_vace(gen, vcfg, dtype=torch.float32), gen),
        vace_cfg=vcfg, vae_params=vae, vae_cfg=DEFAULT_RANDOM_VAE,
        policy=FP32_POLICY)
    gen_kw = dict(num_inference_steps=3, guidance_scale=5.0,
                  output_type="latent")
    t2v_kw = dict(height=hw, width=hw, num_frames=f, **gen_kw)
    # (pipeline, its params field, run, kernels that must launch, gate):
    # T2V returns latents without a VAE (fp32 DiT only); FLF2V and VACE
    # encode through kernel 4, whose bf16 input rounding flips on last-bit
    # differences, so they are held at bf16 noise level
    wan_kernels = ("flash_attention", "rope_qk", "modulated_layer_norm")
    runs = {
        "t2v": (wan("t2v", z), "dit_params",
                lambda p: p.generate(None, pe, ne, noise_fn=_numpy_noise(33),
                                     **t2v_kw), wan_kernels, 1e-3),
        "flf2v": (wan("flf2v", 4 + 2 * z), "dit_params",
                  lambda p: p.generate(None, pe, ne, first_frame=first,
                                       last_frame=last, image_embeds=clip2,
                                       noise_fn=_numpy_noise(33), **t2v_kw),
                  wan_kernels + ("conv3d_causal",), 2e-2),
        "vace": (vace, "vace_params",
                 lambda p: p.generate(None, src, mask, pe, ne,
                                      context_scale=0.8,
                                      noise_fn=_numpy_noise(33), **gen_kw),
                 wan_kernels + ("conv3d_causal",), 2e-2),
    }
    for name, (pipe, field, run, need, tol) in runs.items():
        on_card = dataclasses.replace(
            pipe, vae_params=_to_card(pipe.vae_params),
            **{field: _to_card(getattr(pipe, field))})
        _reset_counters()
        a = run(on_card).float().cpu()
        launches = _read_counters()
        b = run(pipe).float().cpu()
        rel_l2 = _rel_l2(a, b)
        ok = bool(torch.isfinite(a).all()) and rel_l2 < tol
        emit({"phase": "wan_facades_small_vs_cpu", "run": name,
              "shape": list(a.shape), "steps": 3, "guidance_scale": 5.0,
              "rel_l2": rel_l2, "rel_max": _rel_max(a, b),
              "tol_rel_l2": tol, "launches_on_card": launches, "ok": ok})
        if not ok:
            raise SystemExit(f"chip_smoke: small {name} disagrees with the "
                             f"CPU run of the plain versions")
        _require_launches(launches, need, f"small {name}")

    # the VACE context with two reference images in front
    refs = [f32(rng.uniform(-1, 1, (1, 3, 1, hw, hw))) for _ in range(2)]
    args = (torch.from_numpy(src), torch.from_numpy(mask))
    ctx_card = prepare_vace_context(
        *(t.cuda() for t in args), _to_card(vae), DEFAULT_RANDOM_VAE,
        ref_images=[torch.from_numpy(r).cuda() for r in refs])
    ctx_cpu = prepare_vace_context(
        *args, vae, DEFAULT_RANDOM_VAE,
        ref_images=[torch.from_numpy(r) for r in refs])
    ctx_err = _rel_l2(ctx_card, ctx_cpu)
    # the processor's antialiased cubic resize + crop (host code) of a
    # synthetic uint8 video, its resize run once more on the card
    video = rng.integers(0, 256, (20, 40, 56, 3), dtype=np.uint8)
    proc = vp.VaceVideoProcessor(seq_len=60, max_area=24 * 32)
    out, ids, (oh, ow), _ = proc.load_video(video)
    sel = vp._to_float01(video[ids])
    card = vp._resize_crop(sel.cuda(), oh, ow).cpu()
    proc_err = float((card - out).abs().max())
    # one DPM-Solver++ update of each order (the warm-up of order 3)
    sched = dpm.make_flow_dpm_schedule(6, solver_order=3)
    x = torch.from_numpy(f32(rng.standard_normal((1, 16, 5, 8, 8))))
    ms = [torch.from_numpy(f32(rng.standard_normal(tuple(x.shape))))
          for _ in range(3)]
    dpm_err = {}
    for i in range(3):
        hist = ms[:i + 1][::-1]
        a = dpm.dpm_update(sched, i, x.cuda(), *(m.cuda() for m in hist))
        b = dpm.dpm_update(sched, i, x, *hist)
        dpm_err[int(sched.order[i])] = _rel_max(a.cpu(), b)
    ok = (ctx_err < 2e-2 and proc_err <= 1e-5
          and max(dpm_err.values()) <= 1e-6 and sorted(dpm_err) == [1, 2, 3])
    emit({"phase": "wan_facades_small_vs_cpu", "run": "pieces",
          "vace_context_shape": list(ctx_card.shape),
          "vace_context_rel_l2": ctx_err, "tol_vace_context": 2e-2,
          "processor_frames": len(ids), "processor_size": [oh, ow],
          "processor_max_abs": proc_err, "tol_processor": 1e-5,
          "dpm_rel_max_by_order": dpm_err, "tol_dpm": 1e-6, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: VACE context, processor or DPM "
                         "pieces disagree with the CPU")


def _facade_vae():
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    cfg = WanVAEConfig.wan_2_1()
    return init_wan_vae(P.make_generator(41, "cuda"), cfg), cfg


def _run_facade(name, build, generate, module, forward_name, extra):
    """Build one full-width facade on the card (its zero leaves randomised),
    run its generate with the counters from 0, and time every DiT forward
    and the streaming decode. Returns (record, launches, the pipeline,
    whether the output is right)."""
    from worldforge_tpu_torch.pipelines import wan_t2v
    import numpy as np
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    pipe = build()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    fwd, dec, peaks = [], [], []
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with timed_calls(module, forward_name, fwd, peaks=peaks), \
            timed_calls(wan_t2v, "vae_decode_streaming", dec, peaks=peaks):
        out = generate(pipe)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    peak = max(peaks + [r["peak_gb"] for r in fwd + dec]
               + [torch.cuda.max_memory_allocated() / 2 ** 30])
    steps = [fwd[2 * i]["s"] + fwd[2 * i + 1]["s"]
             for i in range(len(fwd) // 2)]
    ok = (out.shape == (1, 3, FACADE_FRAMES, HEIGHT, WIDTH)
          and bool(np.isfinite(out).all()))
    rec = {"phase": "wan_facades", "model": name, **extra,
           "cuts": {"frames": f"{FACADE_FRAMES} of 81",
                    "steps": f"{FACADE_STEPS} of 50",
                    "decode": "streaming"},
           "height": HEIGHT, "width": WIDTH, "frames": FACADE_FRAMES,
           "tokens": FACADE_TOKENS, "guidance_scale": 5.0,
           "flow_shift": 5.0, "init_s": init_s, "total_s": total_s,
           "dit_forward_s": [r["s"] for r in fwd],
           "step_dit_s": steps, "decode_s": sum(r["s"] for r in dec),
           "peak_gb": peak, "peak_by_span_gb": {
               "dit_forward": max(r["peak_gb"] for r in fwd),
               "decode": max(r["peak_gb"] for r in dec)},
           "launches": launches, "out_shape": list(out.shape),
           "out_range": [float(out.min()), float(out.max())], "ok": ok}
    return rec, launches, pipe, ok


def phase_wan_facades(warp_dir, ctx):
    """Wan2.1-T2V-14B, FLF2V-14B and VACE-14B at full width and depth
    (random bf16 weights from seeds, every zero leaf randomised), one at a
    time and each freed before the next, through ``WanT2VPipeline`` /
    ``WanVacePipeline.generate`` at 480 x 832 with the cuts on their lines,
    fed by the encoders phase's UMT5-XXL and CLIP-H contexts and the warp's
    frames; one T2V forward at the published 81 frames. Kernels 1-4 must
    launch on each path. Before it, the reduced card-vs-CPU checks."""
    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.vace_processor import (VaceVideoProcessor,
                                                        prepare_source)
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     init_wan_dit,
                                                     wan_dit_forward)
    from worldforge_tpu_torch.models.wan.vace import VaceConfig, init_vace
    from worldforge_tpu_torch.pipelines import wan_t2v, wan_vace

    _small_wan_facades_check()
    by_path = {}
    pe, ne = ctx["pe"], ctx["ne"]
    frames, valid = _frames_480p(warp_dir)    # [1,3,F,H,W], [1,1,F,H,W]
    gen_kw = dict(num_inference_steps=FACADE_STEPS, guidance_scale=5.0,
                  flow_shift=5.0)
    t2v_kw = dict(height=HEIGHT, width=WIDTH, num_frames=FACADE_FRAMES,
                  **gen_kw)

    def wan_pipe(cfg, seed):
        g = P.make_generator(seed, "cuda")
        vae, vcfg = _facade_vae()
        return wan_t2v.WanT2VPipeline(
            dit_params=_randomize_zero_leaves(init_wan_dit(g, cfg), g),
            dit_cfg=cfg, vae_params=vae, vae_cfg=vcfg, streaming_vae=True)

    # T2V-14B: the JAX defaults, the published Wan2.1-T2V-14B widths
    t2v_cfg = WanDiTConfig(model_type="t2v", in_dim=16)
    rec, by_path["t2v"], pipe, ok = _run_facade(
        "t2v_14b", lambda: wan_pipe(t2v_cfg, 42),
        lambda p: p.generate(torch.Generator(device="cuda").manual_seed(1),
                             pe, ne, **t2v_kw),
        wan_t2v, "wan_dit_forward",
        {"config": "WanDiTConfig(model_type='t2v', in_dim=16): dim 5120, "
                   "40 layers, 40 heads, ffn 13824"})
    # one forward at the published 81 frames (21 x 30 x 52 latent tokens)
    lat = torch.randn((1, 16, T2V_PUBLISHED_FRAMES // 4 + 1, HEIGHT // 8,
                       WIDTH // 8), generator=torch.Generator(
                           device="cuda").manual_seed(2), device="cuda")
    tb = torch.full((1,), 999.0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    out81 = wan_dit_forward(pipe.dit_params, t2v_cfg, lat, tb, pe)
    torch.cuda.synchronize()
    rec["forward_81_frames"] = {
        "tokens": (T2V_PUBLISHED_FRAMES // 4 + 1) * (HEIGHT // 16)
        * (WIDTH // 16), "s": time.time() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "finite": bool(torch.isfinite(out81).all())}
    by_path["t2v81"] = _read_counters()
    ok = ok and rec["forward_81_frames"]["finite"]
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: T2V-14B output is wrong")
    _require_launches(by_path["t2v"], WAN_PATH_KERNELS, "t2v")
    del pipe, lat, out81
    gc.collect()
    torch.cuda.empty_cache()

    # FLF2V-14B: the warp's frames 0 and 16, CLIP-H on both
    image_embeds = torch.cat([ctx["ie"], ctx["ie_last"]], dim=1)
    first = frames[:, :, 0] * 2.0 - 1.0
    last = frames[:, :, FACADE_FRAMES - 1] * 2.0 - 1.0
    rec, by_path["flf2v"], pipe, ok = _run_facade(
        "flf2v_14b", lambda: wan_pipe(WanDiTConfig(model_type="flf2v"), 43),
        lambda p: p.generate(torch.Generator(device="cuda").manual_seed(1),
                             pe, ne, first_frame=first, last_frame=last,
                             image_embeds=image_embeds, **t2v_kw),
        wan_t2v, "wan_dit_forward",
        {"config": "WanDiTConfig(model_type='flf2v'): the 14B widths, "
                   "in_dim 36, 2 x 257 CLIP-H tokens (emb_pos)",
         "image_embeds": list(image_embeds.shape)})
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: FLF2V-14B output is wrong")
    _require_launches(by_path["flf2v"], WAN_PATH_KERNELS, "flf2v")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # VACE-14B repaints the warp's holes: the source is the warp's 17
    # frames and the edit mask 1 - validity, through prepare_source and
    # VaceVideoProcessor.load_video_pair
    video = (frames[0].transpose(1, 2, 3, 0) * 255.0).round().astype(
        np.uint8)                                  # [T, H, W, 3]
    edit = 1.0 - valid[0].transpose(1, 2, 3, 0)    # [T, H, W, 1]
    src, src_mask, ids, size, _ = VaceVideoProcessor().load_video_pair(
        video, edit)
    src_v, src_m, _ = prepare_source([src], [src_mask], [None],
                                     FACADE_FRAMES, size)
    vace_cfg = VaceConfig(base=t2v_cfg, vace_layers=VACE_14B_LAYERS,
                          vace_in_dim=96)

    def vace_pipe():
        g = P.make_generator(44, "cuda")
        vae, vcfg = _facade_vae()
        return wan_vace.WanVacePipeline(
            vace_params=_randomize_zero_leaves(init_vace(g, vace_cfg), g),
            vace_cfg=vace_cfg, vae_params=vae, vae_cfg=vcfg,
            streaming_vae=True)

    rec, by_path["vace"], pipe, ok = _run_facade(
        "vace_14b", vace_pipe,
        lambda p: p.generate(torch.Generator(device="cuda").manual_seed(1),
                             src_v[0][None], src_m[0][None], pe, ne,
                             **gen_kw),
        wan_vace, "vace_forward",
        {"config": "VaceConfig(base=T2V-14B, vace_layers=(0, 5, ..., 35), "
                   "vace_in_dim=96), the published Wan2.1-VACE-14B layout",
         "source": {"frames": len(ids), "size": list(size),
                    "edit_coverage": float(edit.mean())}})
    ok = ok and len(ids) == FACADE_FRAMES and tuple(size) == (HEIGHT, WIDTH)
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: VACE-14B output is wrong")
    _require_launches(by_path["vace"], WAN_PATH_KERNELS, "vace")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def _avatar_waveform(seconds, seed=0):
    """A speech-like synthetic waveform [1, L] at 16 kHz: a few voiced
    harmonics under a syllable-rate envelope, plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * AUDIO_RATE))) / AUDIO_RATE
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / AUDIO_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t)) ** 2
    x = 0.2 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return x.astype(np.float32)[None]


def _small_avatar_check(work_dir):
    """A widened tiny avatar (2 heads of 64, 4 audio tokens) with the tiny
    wav2vec2 and the small VAE, fp32 policy, every zero leaf randomised,
    weights drawn on the CPU and copied to the card, both sides fed one
    numpy noise stream: ``generate_i2v_audio`` with CFG and with distill,
    one multitalk forward, and the k/v-cache forward against the joint
    forward; then ``run_avatar --random-init`` with ``--device cuda`` and
    ``--device cpu`` on a synthetic 16-bit WAV (the CPU run takes weights
    drawn on the CPU, the card run a copy of them, and both the same noise
    stream): both write an mp4 and their frames agree."""
    import dataclasses
    import functools
    import wave

    import numpy as np
    from worldforge_tpu_torch.cli import run_avatar
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io import checkpoints
    from worldforge_tpu_torch.io import frames as frames_io
    from worldforge_tpu_torch.io.checkpoints import DEFAULT_RANDOM_VAE
    from worldforge_tpu_torch.models.encoders.wav2vec2 import (
        Wav2Vec2Config, init_wav2vec2)
    from worldforge_tpu_torch.models.longcat import avatar
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    from worldforge_tpu_torch.models.wan.vae import init_wan_vae
    from worldforge_tpu_torch.pipelines.avatar import (AvatarPipeline,
                                                       encode_audio_windows)

    wcfg = Wav2Vec2Config.tiny()
    base = LongCatDiTConfig(in_channels=DEFAULT_RANDOM_VAE.z_dim,
                            out_channels=DEFAULT_RANDOM_VAE.z_dim,
                            hidden_size=128, depth=2, num_heads=2,
                            caption_channels=64, adaln_tembed_dim=32,
                            frequency_embedding_size=16)
    cfg = avatar.AvatarConfig(base=base, audio_blocks=wcfg.num_layers,
                              audio_channels=wcfg.hidden_size,
                              intermediate_dim=32, output_dim=16,
                              context_tokens=4)
    gen = P.make_generator(51)
    dit = _randomize_zero_leaves(
        avatar.init_avatar_dit(gen, cfg, dtype=torch.float32), gen)
    w2v = _randomize_zero_leaves(init_wav2vec2(gen, wcfg), gen)
    vae = _randomize_zero_leaves(init_wan_vae(gen, DEFAULT_RANDOM_VAE), gen)
    pipe = AvatarPipeline(dit_params=dit, dit_cfg=cfg, vae_params=vae,
                          vae_cfg=DEFAULT_RANDOM_VAE, policy=FP32_POLICY)
    on_card = dataclasses.replace(pipe, dit_params=_to_card(dit),
                                  vae_params=_to_card(vae))
    rng = np.random.default_rng(52)
    f32 = lambda a: a.astype(np.float32)
    f, hw = 9, 64
    image = f32(rng.uniform(-1, 1, (1, 3, hw, hw)))
    wav = _avatar_waveform(0.4, seed=53)
    wins = {"cuda": encode_audio_windows(_to_card(w2v), wcfg, wav, f),
            "cpu": encode_audio_windows(w2v, wcfg, wav, f)}
    win_err = _rel_max(wins["cuda"].cpu(), wins["cpu"])
    pe, ne = (f32(rng.standard_normal((1, 8, 64))) for _ in range(2))
    pm = np.zeros((1, 8), np.int32)
    pm[:, :5] = 1
    nm = np.ones((1, 8), np.int32)
    kw = dict(height=hw, width=hw, num_frames=f, num_inference_steps=3,
              guidance_scale=4.0, output_type="latent")
    need = ("flash_attention", "rope_qk", "conv3d_causal")
    for name, distill in (("i2v cfg", False), ("i2v distill", True)):
        outs = {}
        for dev, p in (("cuda", on_card), ("cpu", pipe)):
            _reset_counters()
            outs[dev] = p.generate_i2v_audio(
                None, image, wins[dev], pe, pm, ne, nm, use_distill=distill,
                noise_fn=_numpy_noise(54), **kw).float().cpu()
            if dev == "cuda":
                launches = _read_counters()
        rel_l2 = _rel_l2(outs["cuda"], outs["cpu"])
        # the reference image's VAE encode runs kernel 4 (bf16 inputs)
        ok = bool(torch.isfinite(outs["cuda"]).all()) and rel_l2 < 2e-2
        emit({"phase": "avatar_small_vs_cpu", "run": name,
              "shape": list(outs["cuda"].shape), "rel_l2": rel_l2,
              "rel_max": _rel_max(outs["cuda"], outs["cpu"]),
              "tol_rel_l2": 2e-2, "audio_windows_rel_max": win_err,
              "launches_on_card": launches, "ok": ok and win_err < 1e-4})
        if not (ok and win_err < 1e-4):
            raise SystemExit(f"chip_smoke: small avatar {name} disagrees "
                             f"with the CPU run of the plain versions")
        _require_launches(launches, need, f"small avatar {name}")

    # the DiT alone (fp32, kernel 1 in 3xTF32): multitalk, and the k/v
    # cache against the joint forward
    x = f32(rng.standard_normal((1, base.in_channels, 4, 8, 8)))
    ctx = f32(rng.standard_normal((1, 8, 64)))
    aud = f32(rng.standard_normal((2, 13, 5, wcfg.num_layers,
                                   wcfg.hidden_size)))
    masks = np.zeros((2, 8, 8), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, 4:] = 1.0
    t = np.array([[0.0, 0.0, 600.0, 600.0]], np.float32)

    def both(fn, *arrays):
        ts = [torch.from_numpy(a) for a in arrays]
        return {"cuda": fn(on_card.dit_params,
                           *(t.cuda() for t in ts)).float().cpu(),
                "cpu": fn(dit, *ts).float().cpu()}

    multi = both(lambda p, x_, t_, c_, a_, m_, pm_: avatar.avatar_dit_forward(
        p, cfg, x_, t_, c_, a_, encoder_attention_mask=pm_,
        num_cond_latents=2, ref_target_masks=m_, policy=FP32_POLICY),
        x, t, ctx, aud, masks, pm)
    joint = both(lambda p, x_, t_, c_, a_, pm_: avatar.avatar_dit_forward(
        p, cfg, x_, t_, c_, a_, encoder_attention_mask=pm_,
        num_cond_latents=2, policy=FP32_POLICY), x, t, ctx, aud[:1], pm)

    def cached(p, x_, c_, a_, pm_):
        cache = avatar.avatar_dit_cache_cond(p, cfg, x_[:, :, :2],
                                             policy=FP32_POLICY)
        return avatar.avatar_dit_forward_with_cache(
            p, cfg, x_[:, :, 2:], torch.full((1,), 600.0,
                                             device=x_.device), c_, a_,
            cache, (2,), encoder_attention_mask=pm_, policy=FP32_POLICY)
    cache = both(cached, x, ctx, aud[:1], pm)
    errs = {"multitalk_card_vs_cpu": _rel_max(multi["cuda"], multi["cpu"]),
            "cache_card_vs_cpu": _rel_max(cache["cuda"], cache["cpu"]),
            "cache_vs_joint_card": _rel_max(cache["cuda"],
                                            joint["cuda"][:, :, 2:])}
    ok = max(errs.values()) < 1e-4
    emit({"phase": "avatar_small_vs_cpu", "run": "dit forwards",
          "max_rel_err": errs, "tol": 1e-4, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small avatar forwards disagree")

    # run_avatar on both devices: the CPU run's weights drawn on the CPU,
    # the card run's a copy of them; one noise stream for both; the frames
    # before the mp4's lossy encode are compared
    img_path = os.path.join(work_dir, "avatar_face.png")
    from PIL import Image
    Image.fromarray((image[0].transpose(1, 2, 0) * 127.5 + 127.5).astype(
        np.uint8)).save(img_path)
    wav_path = os.path.join(work_dir, "avatar_voice.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(AUDIO_RATE)
        w.writeframes((np.clip(wav[0], -1, 1) * 32767).astype("<i2")
                      .tobytes())
    real_load = checkpoints.load_avatar_pipeline
    real_export = frames_io.export_video
    written = {}

    def load_on(dev):
        def load(*args, **kwargs):
            kwargs["device"] = "cpu"
            p, enc_t, _ = real_load(*args, **kwargs)
            w = init_wav2vec2(P.make_generator(2),
                              checkpoints.DEFAULT_RANDOM_WAV2VEC2)
            if dev == "cuda":
                p = dataclasses.replace(p, dit_params=_to_card(p.dit_params),
                                        vae_params=_to_card(p.vae_params))
                w = _to_card(w)
            p.generate_i2v_audio = functools.partial(
                p.generate_i2v_audio, noise_fn=_numpy_noise(55))

            def enc_a(wave_, n):
                return encode_audio_windows(
                    w, checkpoints.DEFAULT_RANDOM_WAV2VEC2, wave_, n)
            return p, enc_t, enc_a
        return load

    def export(dev):
        def run(frames, path, fps=16):
            written[dev] = np.stack(frames)
            real_export(frames, path, fps=fps)
        return run

    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work_dir, f"avatar_{dev}.mp4")
        checkpoints.load_avatar_pipeline = load_on(dev)
        frames_io.export_video = export(dev)
        _reset_counters()
        try:
            run_avatar.main(["--image", img_path, "--audio", wav_path,
                             "--random-init", "--device", dev,
                             "--num-frames", "9", "--num-inference-steps",
                             "4", "--output", out])
        finally:
            checkpoints.load_avatar_pipeline = real_load
            frames_io.export_video = real_export
        if dev == "cuda":
            launches = _read_counters()
        outs[dev] = out
    a, b = (torch.from_numpy(written[d]) for d in ("cuda", "cpu"))
    rel_l2 = _rel_l2(a, b)
    # the CLI runs the default bf16 policy: card kernels and CPU plain
    # versions round differently at every bf16 cast
    tol = 5e-2
    ok = (all(os.path.getsize(o) > 0 for o in outs.values())
          and a.shape == (9, hw, hw, 3) and rel_l2 < tol)
    emit({"phase": "avatar_small_vs_cpu", "run": "run_avatar cli",
          "frames": list(a.shape), "mp4_bytes": {
              d: os.path.getsize(o) for d, o in outs.items()},
          "rel_l2": rel_l2, "tol_rel_l2": tol,
          "launches_on_card": launches, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: run_avatar on the card disagrees "
                         "with the CPU")
    _require_launches(launches, AVATAR_PATH_KERNELS, "small run_avatar")


def _decode_alone(t_lat: int) -> dict:
    """The Wan2.1 VAE's single-pass decode of ``t_lat`` latent frames at
    480 x 832 (random weights and latents) on its own: seconds and peak.
    Run in a child process (``_measure_decode_alone``)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae, vae_decode)
    cfg = WanVAEConfig.wan_2_1()
    params = init_wan_vae(P.make_generator(41, "cuda"), cfg)
    z = torch.randn((1, cfg.z_dim, t_lat, HEIGHT // 8, WIDTH // 8),
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    video = vae_decode(params, cfg, z)
    torch.cuda.synchronize()
    return {"latent_frames": t_lat, "frames": int(video.shape[2]),
            "s": time.time() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "held_before_gb": held,
            "card_gb": torch.cuda.get_device_properties(0).total_memory
            / 2 ** 30, "finite": bool(torch.isfinite(video).all())}


def _measure_decode_alone(t_lat: int) -> dict:
    """``_decode_alone`` in a child process started before any phase holds
    memory, so its blocks come from a fresh allocator (with expandable
    segments, which do not change what is allocated); the child exits
    before this returns."""
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    code = ("import json, chip_smoke; "
            f"print(json.dumps(chip_smoke._decode_alone({t_lat})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"chip_smoke: the single-pass decode of {t_lat} "
                         f"latent frames failed on its own:\n"
                         f"{res.stderr[-3000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    emit({"phase": "avatar_decode_alone", **rec})
    if not rec["finite"]:
        raise SystemExit("chip_smoke: the decode alone is not finite")
    return rec


def phase_avatar(frames, ctx, work_dir, decode93):
    """The LongCat-Video-Avatar at full width and depth: what the JAX
    converted branch builds (the 13.6B LongCat base with the audio blocks,
    wav2vec2-base, the Wan2.1 VAE; random weights from seeds, the DiT's
    zero leaves randomised) through ``load_avatar_pipeline``, the
    ``encode_audio`` it returns (a synthetic 3.72 s waveform) and
    ``generate_i2v_audio`` on the warp's first frame at 480 x 832, with the
    encoders phase's UMT5-XXL contexts and the cuts on its line; kernels 1,
    2 and 4 must launch. Then one DiT forward at the CLI's default 93
    frames (37,440 tokens). ``decode93`` is the single-pass decode of its
    24 latent frames measured alone (``_measure_decode_alone``): its peak
    beside the DiT's weights says whether 93 frames fit the card. Before
    it, the reduced card-vs-CPU checks. Returns the launches of the
    generate and of the forward."""
    import numpy as np
    from worldforge_tpu_torch.io.checkpoints import load_avatar_pipeline
    from worldforge_tpu_torch.models.encoders.wav2vec2 import Wav2Vec2Config
    from worldforge_tpu_torch.models.longcat.avatar import (
        AvatarConfig, avatar_dit_forward)
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
    from worldforge_tpu_torch.pipelines import avatar as avatar_pipe
    from worldforge_tpu_torch.core import params as P

    _small_avatar_check(work_dir)
    cfg = AvatarConfig(base=LongCatDiTConfig.longcat_13b())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe, _, encode_audio = load_avatar_pipeline(
        random_init=True, device="cuda", dit_cfg=cfg,
        vae_cfg=WanVAEConfig.wan_2_1(), w2v_cfg=Wav2Vec2Config(), seed=61)
    pipe.dit_params = _randomize_zero_leaves(
        pipe.dit_params, P.make_generator(62, "cuda"))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    params = sum(t.numel() for t in _leaves(pipe.dit_params))
    weights_gb = torch.cuda.memory_allocated() / 2 ** 30
    wav = _avatar_waveform(AVATAR_SECONDS, seed=63)
    image = frames[:, :, 0] * 2.0 - 1.0
    pm = torch.zeros((1, TEXT_LEN), dtype=torch.int32, device="cuda")
    nm = torch.zeros_like(pm)
    pm[:, :PROMPT_TOKENS] = 1
    nm[:, :NEGATIVE_TOKENS] = 1

    fwd, enc, dec, peaks = [], [], [], []
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    windows = encode_audio(wav, AVATAR_FRAMES)
    torch.cuda.synchronize()
    w2v_s = time.time() - t0
    w2v_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with timed_calls(avatar_pipe, "avatar_dit_forward", fwd, peaks=peaks), \
            timed_calls(avatar_pipe, "vae_encode", enc, peaks=peaks), \
            timed_calls(avatar_pipe, "vae_decode", dec, peaks=peaks):
        out = pipe.generate_i2v_audio(
            torch.Generator(device="cuda").manual_seed(3), image, windows,
            ctx["pe"], pm, ctx["ne"], nm, height=HEIGHT, width=WIDTH,
            num_frames=AVATAR_FRAMES, num_inference_steps=AVATAR_STEPS,
            guidance_scale=4.0)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    spans = {"wav2vec2": w2v_peak,
             "vae_encode": max(r["peak_gb"] for r in enc),
             "dit_forward": max(r["peak_gb"] for r in fwd),
             "vae_decode": max(r["peak_gb"] for r in dec)}
    ok = (out.shape == (1, 3, AVATAR_FRAMES, HEIGHT, WIDTH)
          and tuple(windows.shape) == (1, AVATAR_FRAMES, cfg.audio_window,
                                       12, 768)
          and bool(np.isfinite(out).all()))
    del out

    # one forward at the CLI's 93 frames: 24 latent frames, the first the
    # reference image's at t = 0
    t_cli = (AVATAR_CLI_FRAMES - 1) // 4 + 1
    g = torch.Generator(device="cuda").manual_seed(4)
    lat = torch.randn((1, 16, t_cli, HEIGHT // 8, WIDTH // 8), generator=g,
                      device="cuda")
    tb = torch.full((1, t_cli), 500.0, device="cuda")
    tb[:, 0] = 0.0
    windows93 = encode_audio(wav, AVATAR_CLI_FRAMES)
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    v = avatar_dit_forward(pipe.dit_params, cfg, lat, tb, ctx["pe"],
                           windows93, encoder_attention_mask=pm,
                           num_cond_latents=1, policy=pipe.policy)
    torch.cuda.synchronize()
    forward93 = {"tokens": t_cli * (HEIGHT // 16) * (WIDTH // 16),
                 "s": time.time() - t0,
                 "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "finite": bool(torch.isfinite(v).all())}
    launches93 = _read_counters()
    ok = ok and forward93["finite"]

    # the pipeline's weights (DiT, VAE, wav2vec2) beside the decode's own
    # peak (its VAE weights are held_before_gb)
    decode93 = dict(decode93, pipeline_weights_gb=weights_gb)
    decode93["fits_beside_dit"] = (decode93["peak_gb"]
                                   - decode93["held_before_gb"] + weights_gb
                                   < decode93["card_gb"])
    del pipe, encode_audio, v, lat
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "avatar", "config": "AvatarConfig(base=LongCatDiTConfig."
          "longcat_13b()) + Wav2Vec2Config() + WanVAEConfig.wan_2_1()",
          "dit_params": params, "weights_gb": weights_gb,
          "cuts": {"frames": f"{AVATAR_FRAMES} of the CLI's "
                   f"{AVATAR_CLI_FRAMES}: the single-pass decode of 93 "
                   f"frames does not fit beside the DiT (decode_93_frames_"
                   f"alone)", "steps": f"{AVATAR_STEPS} of 50"},
          "height": HEIGHT, "width": WIDTH, "frames": AVATAR_FRAMES,
          "latent_frames": (AVATAR_FRAMES - 1) // 4 + 1,
          "tokens": ((AVATAR_FRAMES - 1) // 4 + 1) * (HEIGHT // 16)
          * (WIDTH // 16),
          "audio_s": AVATAR_SECONDS, "audio_samples": int(wav.shape[1]),
          "audio_windows": list(windows.shape), "guidance_scale": 4.0,
          "init_s": init_s, "wav2vec2_s": w2v_s, "total_s": total_s,
          "encode_s": sum(r["s"] for r in enc),
          "dit_forward_s": [r["s"] for r in fwd],
          "decode_s": sum(r["s"] for r in dec),
          "peak_gb": max(spans.values()), "peak_by_span_gb": spans,
          "peak_span": max(spans, key=spans.get), "launches": launches,
          "forward_93_frames": forward93, "launches_93_frames": launches93,
          "decode_93_frames_alone": decode93, "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: avatar output is wrong")
    _require_launches(launches, AVATAR_PATH_KERNELS, "avatar")
    _require_launches(launches93, ("flash_attention", "rope_qk"),
                      "avatar 93-frame forward")
    return {"avatar": launches, "avatar93": launches93}


# --------------------------------------------------------- checkpoints
# The checkpoints phase: torch-only inverse writers (a port tree -> the
# upstream state dict, names -> views of the tree's tensors as upstream lays
# them out) and a safetensors writer that streams one tensor at a time from
# the card; then the port's loaders read the files back.

CKPT_SHARD_BYTES = 5 * 10 ** 9          # upstream shards are about 5 GB
CKPT_DISK_MARGIN = 2 * 10 ** 9
LORA_RANK = 128


def _w_lin(sd, name, p):
    sd[f"{name}.weight"] = p["w"].t()
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def _w_norm(sd, name, p):
    sd[f"{name}.weight"] = p["scale"]
    if "bias" in p:
        sd[f"{name}.bias"] = p["bias"]


def _w_conv(sd, name, p):
    w = p["w"]                                   # [*k, in, out]
    nd = w.dim() - 2
    sd[f"{name}.weight"] = w.permute(nd + 1, nd, *range(nd))
    if "b" in p:
        sd[f"{name}.bias"] = p["b"]


def _w_patch3d(w, patch, cin):
    """dense [(pt ph pw c), out] -> Conv3d [out, c, pt, ph, pw]."""
    return w.reshape(*patch, cin, -1).permute(4, 3, 0, 1, 2)


def wan_dit_state_dict(params, cfg) -> dict:
    """A port Wan DiT tree -> the vendored WanModel state dict."""
    sd = {"patch_embedding.weight": _w_patch3d(
        params["patch_embedding"]["w"], cfg.patch_size, cfg.in_dim),
        "patch_embedding.bias": params["patch_embedding"]["b"]}
    _w_lin(sd, "text_embedding.0", params["text_embedding"]["fc1"])
    _w_lin(sd, "text_embedding.2", params["text_embedding"]["fc2"])
    _w_lin(sd, "time_embedding.0", params["time_embedding"]["fc1"])
    _w_lin(sd, "time_embedding.2", params["time_embedding"]["fc2"])
    _w_lin(sd, "time_projection.1", params["time_projection"])
    for i, blk in enumerate(params["blocks"]):
        b = f"blocks.{i}"
        for a in ("self_attn", "cross_attn"):
            for k, p in blk[a].items():
                (_w_norm if k.startswith("norm") else _w_lin)(
                    sd, f"{b}.{a}.{k}", p)
        if blk["norm3"]:
            _w_norm(sd, f"{b}.norm3", blk["norm3"])
        _w_lin(sd, f"{b}.ffn.0", blk["ffn"]["fc1"])
        _w_lin(sd, f"{b}.ffn.2", blk["ffn"]["fc2"])
        sd[f"{b}.modulation"] = blk["modulation"]
    _w_lin(sd, "head.head", params["head"]["head"])
    sd["head.modulation"] = params["head"]["modulation"]
    if "img_emb" in params:
        e = params["img_emb"]
        _w_norm(sd, "img_emb.proj.0", e["norm_in"])
        _w_lin(sd, "img_emb.proj.1", e["fc1"])
        _w_lin(sd, "img_emb.proj.3", e["fc2"])
        _w_norm(sd, "img_emb.proj.4", e["norm_out"])
        if "emb_pos" in e:
            sd["img_emb.emb_pos"] = e["emb_pos"]
    return sd


def wan_vae_state_dict(params) -> dict:
    """A port Wan VAE tree -> the ``WanVAE_`` state dict: its
    ``nn.Sequential`` indices, the RMS gammas as [C, 1, 1, 1]."""
    sd = {}

    def rms(name, p):
        sd[f"{name}.gamma"] = p["gamma"].reshape(-1, 1, 1, 1)

    def res(pre, p):
        rms(f"{pre}.residual.0", p["norm1"])
        _w_conv(sd, f"{pre}.residual.2", p["conv1"])
        rms(f"{pre}.residual.3", p["norm2"])
        _w_conv(sd, f"{pre}.residual.6", p["conv2"])
        if "shortcut" in p:
            _w_conv(sd, f"{pre}.shortcut", p["shortcut"])

    def mid(pre, p):
        res(f"{pre}.0", p["res1"])
        rms(f"{pre}.1.norm", p["attn"]["norm"])
        _w_conv(sd, f"{pre}.1.to_qkv", p["attn"]["qkv"])
        _w_conv(sd, f"{pre}.1.proj", p["attn"]["proj"])
        res(f"{pre}.2", p["res2"])

    def stages(pre, sts, key):
        seq = 0
        for st in sts:
            for blk in st["blocks"]:
                res(f"{pre}.{seq}", blk)
                seq += 1
            if key in st:
                _w_conv(sd, f"{pre}.{seq}.resample.1", st[key]["conv"])
                if "time_conv" in st[key]:
                    _w_conv(sd, f"{pre}.{seq}.time_conv",
                            st[key]["time_conv"])
                seq += 1

    enc, dec = params["encoder"], params["decoder"]
    _w_conv(sd, "encoder.conv1", enc["conv_in"])
    stages("encoder.downsamples", enc["stages"], "down")
    mid("encoder.middle", enc["mid"])
    rms("encoder.head.0", enc["norm_out"])
    _w_conv(sd, "encoder.head.2", enc["conv_out"])
    _w_conv(sd, "conv1", params["conv1"])
    _w_conv(sd, "conv2", params["conv2"])
    _w_conv(sd, "decoder.conv1", dec["conv_in"])
    mid("decoder.middle", dec["mid"])
    stages("decoder.upsamples", dec["stages"], "up")
    rms("decoder.head.0", dec["norm_out"])
    _w_conv(sd, "decoder.head.2", dec["conv_out"])
    return sd


def umt5_state_dict(params) -> dict:
    """A port UMT5 tree -> transformers UMT5EncoderModel names."""
    sd = {"shared.weight": params["embed"],
          "encoder.final_layer_norm.weight": params["ln_f"]["scale"]}
    for i, p in enumerate(params["blocks"]):
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = p["ln1"]["scale"]
        for k in "qkvo":
            _w_lin(sd, f"{b}.0.SelfAttention.{k}", p[k])
        sd[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = \
            p["rel_bias"]
        sd[f"{b}.1.layer_norm.weight"] = p["ln2"]["scale"]
        for k in ("wi_0", "wi_1", "wo"):
            _w_lin(sd, f"{b}.1.DenseReluDense.{k}", p[k])
    return sd


def clip_state_dict(params, cfg) -> dict:
    """A port CLIP vision tree -> transformers CLIPVisionModel names (the
    ``pre_layrnorm`` spelling)."""
    pre = "vision_model"
    ps = cfg.patch_size
    sd = {f"{pre}.embeddings.patch_embedding.weight":
          params["patch"]["w"].reshape(ps, ps, 3, -1).permute(3, 2, 0, 1),
          f"{pre}.embeddings.class_embedding": params["cls"].reshape(-1),
          f"{pre}.embeddings.position_embedding.weight": params["pos"][0]}
    _w_norm(sd, f"{pre}.pre_layrnorm", params["ln_pre"])
    for i, p in enumerate(params["blocks"]):
        b = f"{pre}.encoder.layers.{i}"
        _w_norm(sd, f"{b}.layer_norm1", p["ln1"])
        for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            _w_lin(sd, f"{b}.self_attn.{n}", p[k])
        _w_norm(sd, f"{b}.layer_norm2", p["ln2"])
        _w_lin(sd, f"{b}.mlp.fc1", p["fc1"])
        _w_lin(sd, f"{b}.mlp.fc2", p["fc2"])
    _w_norm(sd, f"{pre}.post_layernorm", params["ln_post"])
    return sd


def _w_svd_res2d(sd, pre, p):
    _w_norm(sd, f"{pre}.norm1", p["norm1"])
    _w_conv(sd, f"{pre}.conv1", p["conv1"])
    _w_norm(sd, f"{pre}.norm2", p["norm2"])
    _w_conv(sd, f"{pre}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _w_lin(sd, f"{pre}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _w_conv(sd, f"{pre}.conv_shortcut", p["conv_shortcut"])


def _w_svd_st_res(sd, pre, p):
    _w_svd_res2d(sd, f"{pre}.spatial_res_block", p["spatial_res_block"])
    _w_svd_res2d(sd, f"{pre}.temporal_res_block", p["temporal_res_block"])
    sd[f"{pre}.time_mixer.mix_factor"] = p["time_mixer"]["mix_factor"]


def _w_svd_attn(sd, pre, p):
    for k in ("to_q", "to_k", "to_v"):
        _w_lin(sd, f"{pre}.{k}", p[k])
    _w_lin(sd, f"{pre}.to_out.0", p["to_out"])


def _w_svd_basic(sd, pre, p):
    for i in (1, 2):
        _w_norm(sd, f"{pre}.norm{i}", p[f"norm{i}"])
        _w_svd_attn(sd, f"{pre}.attn{i}", p[f"attn{i}"])
    _w_norm(sd, f"{pre}.norm3", p["norm3"])
    for key, name in (("ff", "ff"), ("ff_in", "ff_in")):
        if key in p:
            _w_lin(sd, f"{pre}.{name}.net.0.proj", p[key]["proj"])
            _w_lin(sd, f"{pre}.{name}.net.2", p[key]["out"])
    if "norm_in" in p:
        _w_norm(sd, f"{pre}.norm_in", p["norm_in"])


def _w_svd_transformer(sd, pre, p):
    _w_norm(sd, f"{pre}.norm", p["norm"])
    _w_lin(sd, f"{pre}.proj_in", p["proj_in"])
    for i, b in enumerate(p["blocks"]):
        _w_svd_basic(sd, f"{pre}.transformer_blocks.{i}", b)
    for i, b in enumerate(p["temporal_blocks"]):
        _w_svd_basic(sd, f"{pre}.temporal_transformer_blocks.{i}", b)
    _w_lin(sd, f"{pre}.time_pos_embed.linear_1", p["time_pos_embed"]["fc1"])
    _w_lin(sd, f"{pre}.time_pos_embed.linear_2", p["time_pos_embed"]["fc2"])
    sd[f"{pre}.time_mixer.mix_factor"] = p["time_mixer"]["mix_factor"]
    _w_lin(sd, f"{pre}.proj_out", p["proj_out"])


def svd_unet_state_dict(params) -> dict:
    """A port SVD UNet tree -> the diffusers
    UNetSpatioTemporalConditionModel names."""
    sd = {}
    _w_conv(sd, "conv_in", params["conv_in"])
    for k in ("time_embedding", "add_embedding"):
        _w_lin(sd, f"{k}.linear_1", params[k]["fc1"])
        _w_lin(sd, f"{k}.linear_2", params[k]["fc2"])

    def block(pre, blk, sampler, key):
        for j, r in enumerate(blk["resnets"]):
            _w_svd_st_res(sd, f"{pre}.resnets.{j}", r)
        for j, a in enumerate(blk["attentions"]):
            _w_svd_transformer(sd, f"{pre}.attentions.{j}", a)
        if key in blk:
            _w_conv(sd, f"{pre}.{sampler}.0.conv", blk[key])

    for i, blk in enumerate(params["down_blocks"]):
        block(f"down_blocks.{i}", blk, "downsamplers", "downsampler")
    block("mid_block", params["mid_block"], None, None)
    for i, blk in enumerate(params["up_blocks"]):
        block(f"up_blocks.{i}", blk, "upsamplers", "upsampler")
    _w_norm(sd, "conv_norm_out", params["conv_norm_out"])
    _w_conv(sd, "conv_out", params["conv_out"])
    return sd


def svd_vae_state_dict(params) -> dict:
    """A port SVD VAE tree -> the diffusers AutoencoderKLTemporalDecoder
    names."""
    sd = {}
    enc, dec = params["encoder"], params["decoder"]

    def mid(pre, p, res):
        res(sd, f"{pre}.resnets.0", p["res1"])
        _w_norm(sd, f"{pre}.attentions.0.group_norm", p["attn_norm"])
        _w_svd_attn(sd, f"{pre}.attentions.0", p["attn"])
        res(sd, f"{pre}.resnets.1", p["res2"])

    _w_conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down"]):
        pre = f"encoder.down_blocks.{i}"
        for j, r in enumerate(blk["resnets"]):
            _w_svd_res2d(sd, f"{pre}.resnets.{j}", r)
        if "down" in blk:
            _w_conv(sd, f"{pre}.downsamplers.0.conv", blk["down"])
    mid("encoder.mid_block", enc["mid"], _w_svd_res2d)
    _w_norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _w_conv(sd, "encoder.conv_out", enc["conv_out"])
    _w_conv(sd, "quant_conv", enc["quant_conv"])
    _w_conv(sd, "decoder.conv_in", dec["conv_in"])
    mid("decoder.mid_block", dec["mid"], _w_svd_st_res)
    for i, blk in enumerate(dec["up"]):
        pre = f"decoder.up_blocks.{i}"
        for j, r in enumerate(blk["resnets"]):
            _w_svd_st_res(sd, f"{pre}.resnets.{j}", r)
        if "up" in blk:
            _w_conv(sd, f"{pre}.upsamplers.0.conv", blk["up"])
    _w_norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _w_conv(sd, "decoder.conv_out", dec["conv_out"])
    _w_conv(sd, "decoder.time_conv_out", dec["time_conv_out"])
    return sd


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _nbytes_of(sd) -> int:
    return sum(t.numel() * t.element_size() for t in sd.values())


def write_safetensors(path, tensors) -> int:
    """``tensors`` (name -> tensor on any device, any layout) as one
    .safetensors file through the port's writer
    (``io/torch_load.py::save_safetensors``: each tensor made contiguous
    where it lives and copied to the host one at a time); then fsync and
    drop the file from the page cache (so a later read comes from the
    disk). Returns the file's bytes."""
    from worldforge_tpu_torch.io.torch_load import save_safetensors
    n = save_safetensors(path, tensors)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return n


def write_sharded(dirpath, sd, prefix="model") -> int:
    """``sd`` as ~CKPT_SHARD_BYTES safetensors shards in name order with a
    ``model.safetensors.index.json``, as upstream shards a checkpoint.
    Returns the bytes written."""
    os.makedirs(dirpath, exist_ok=True)
    groups, cur, size = [], {}, 0
    for name, t in sd.items():
        n = t.numel() * t.element_size()
        if cur and size + n > CKPT_SHARD_BYTES:
            groups.append(cur)
            cur, size = {}, 0
        cur[name] = t
        size += n
    groups.append(cur)
    weight_map, total = {}, 0
    for i, g in enumerate(groups):
        fname = f"{prefix}-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        total += write_safetensors(os.path.join(dirpath, fname), g)
        weight_map.update({k: fname for k in g})
    with open(os.path.join(dirpath, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": _nbytes_of(sd)},
                   "weight_map": weight_map}, f)
    return total


def _tree_mismatches(got, want, path="") -> list:
    """The paths where two trees differ in structure, dtype, shape or any
    bit."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path or "/"]
        return [m for k in want
                for m in _tree_mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [path]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in _tree_mismatches(g, w, f"{path}[{i}]")]
    if (got.dtype != want.dtype or got.shape != want.shape
            or got.device != want.device
            or not torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8))):
        return [path]
    return []


def _rss_gib() -> float:
    """This process's resident set now (``/proc/self/statm``), GiB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def _maxrss_gib() -> float:
    """``resource.getrusage``'s peak resident set of the process, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


@contextlib.contextmanager
def _host_peak(rec, key):
    """rec[key] = the peak resident set while the block runs (sampled every
    10 ms), and rec[key + "_maxrss"] = getrusage's lifetime peak after it,
    GiB."""
    import threading
    peak = [_rss_gib()]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.01):
            peak[0] = max(peak[0], _rss_gib())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join()
        rec[key] = max(peak[0], _rss_gib())
        rec[key + "_maxrss"] = _maxrss_gib()


UMT5_SEED, CLIP_SEED = 13, 14          # the encoders phase's


def _wan_source_pipe():
    """The generate phase's full-width Wan pipeline (Wan2.1-I2V-14B DiT +
    Wan2.1 VAE) from its seeds: a second call gives the same bits."""
    import dataclasses

    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
    pipe, _, _ = load_wan_pipeline(
        random_init=True, device="cuda",
        dit_cfg=dataclasses.replace(WanDiTConfig.wan_14b_i2v(),
                                    num_layers=GEN_LAYERS),
        vae_cfg=WanVAEConfig.wan_2_1())
    return pipe


def phase_checkpoints(warp_dir, first_frame):
    """The flagship Wan set through files and the port's loader: the
    generate and encoders phases' full-width trees (Wan2.1-I2V-14B bf16,
    the Wan2.1 VAE fp32, UMT5-XXL bf16, CLIP-H fp32) exported to the
    upstream layout by this script's writers into ``build/chip_smoke/
    wan_models`` (``transformer/`` and ``text_encoder/`` as ~5 GB
    safetensors shards with an index, ``vae/`` a ``.pth``,
    ``image_encoder/`` one safetensors file), written one tensor at a time
    from the card and dropped from the page cache; ``load_wan_pipeline``
    reads them back onto the card (cold); every leaf must equal its source
    (rebuilt from its seed) bit for bit; then the generate phase's guided
    repaint runs on the loaded pipeline with UMT5 contexts from the loaded
    weights on fixed ids and the CLIP context from the loader's
    ``encode_image``. The directory is deleted afterwards."""
    import shutil

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.models.encoders import clip_vision, umt5

    root = os.path.join(HERE, "build", "chip_smoke", "wan_models")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rec = {"phase": "checkpoints", "part": "wan_i2v_14b_set",
           "models": "wan_14b_i2v (bf16) + wan_2_1 vae (fp32) + UMT5-XXL "
                     "(bf16) + CLIP-H (fp32), random weights from the "
                     "generate / encoders phases' seeds",
           "layout": {"transformer": "safetensors shards + index",
                      "vae": ".pth (torch.save)",
                      "text_encoder": "safetensors shards + index",
                      "image_encoder": "model.safetensors"}}
    try:
        t0 = time.time()
        ucfg = umt5.UMT5Config.xxl()
        ccfg = clip_vision.CLIPVisionConfig.vit_h_14()
        pipe = _wan_source_pipe()
        up = umt5.init_umt5(P.make_generator(UMT5_SEED, "cuda"), ucfg)
        cp = clip_vision.init_clip_vision(P.make_generator(CLIP_SEED, "cuda"),
                                          ccfg)
        torch.cuda.synchronize()
        rec["source_init_s"] = time.time() - t0
        parts = {"transformer": wan_dit_state_dict(pipe.dit_params,
                                                   pipe.dit_cfg),
                 "vae": wan_vae_state_dict(pipe.vae_params),
                 "text_encoder": umt5_state_dict(up),
                 "image_encoder": clip_state_dict(cp, ccfg)}
        rec["tensors"] = {k: len(v) for k, v in parts.items()}
        rec["bytes"] = {k: _nbytes_of(v) for k, v in parts.items()}
        need = sum(rec["bytes"].values())
        free = shutil.disk_usage(root).free
        rec.update({"disk_free_gb": free / 1e9, "disk_needed_gb": need / 1e9})
        if free < need + CKPT_DISK_MARGIN:
            emit(rec)
            raise SystemExit(
                f"chip_smoke: {free / 1e9:.1f} GB free under {root}, the "
                f"checkpoints phase writes {need / 1e9:.1f} GB (+ "
                f"{CKPT_DISK_MARGIN / 1e9:.0f} GB margin)")

        with _host_peak(rec, "write_host_peak_rss_gib"):
            t0 = time.time()
            written = write_sharded(os.path.join(root, "transformer"),
                                    parts["transformer"],
                                    "diffusion_pytorch_model")
            os.makedirs(os.path.join(root, "vae"))
            vae_path = os.path.join(root, "vae", "Wan2.1_VAE.pth")
            torch.save({k: v.contiguous().cpu()
                        for k, v in parts["vae"].items()}, vae_path)
            written += os.path.getsize(vae_path)
            written += write_sharded(os.path.join(root, "text_encoder"),
                                     parts["text_encoder"])
            os.makedirs(os.path.join(root, "image_encoder"))
            written += write_safetensors(
                os.path.join(root, "image_encoder", "model.safetensors"),
                parts["image_encoder"])
            with open(vae_path, "rb") as f:
                os.fsync(f.fileno())
                os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
            rec["write_s"] = time.time() - t0
        rec["written_gb"] = written / 1e9
        rec["write_gb_per_s"] = written / 1e9 / rec["write_s"]
        rec["files"] = sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs)
        del parts, pipe, up, cp
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _host_peak(rec, "load_host_peak_rss_gib"):
            rec["load_host_rss_before_gib"] = _rss_gib()
            t0 = time.time()
            pipe, enc_t, enc_i = load_wan_pipeline(root, device="cuda")
            torch.cuda.synchronize()
            rec["load_s"] = time.time() - t0
        gc.collect()
        # what the load left on the host: a view of a mapped file or of a
        # read buffer would keep its pages resident after the load
        rec["load_host_rss_after_gib"] = _rss_gib()
        loaded = list(_leaves((pipe.dit_params, pipe.vae_params,
                               enc_t.params, enc_i.params)))
        rec["leaves_loaded"] = len(loaded)
        rec["loaded_leaves_off_the_card"] = sum(
            t.device.type != "cuda" for t in loaded)
        del loaded
        rec["load_gb_per_s"] = written / 1e9 / rec["load_s"]
        rec["load_device_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       - base) / 2 ** 30
        rec["loaded_device_gib"] = (torch.cuda.memory_allocated()
                                    - base) / 2 ** 30

        # every leaf against its source, rebuilt from its seed one model at
        # a time beside the loaded set
        t0 = time.time()
        mism = _tree_mismatches(enc_t.params, umt5.init_umt5(
            P.make_generator(UMT5_SEED, "cuda"), ucfg), "/umt5")
        mism += _tree_mismatches(enc_i.params, clip_vision.init_clip_vision(
            P.make_generator(CLIP_SEED, "cuda"), ccfg), "/clip")
        ids = torch.as_tensor(np.random.default_rng(3).integers(
            0, enc_t.cfg.vocab_size, (2, TEXT_LEN)), device="cuda")
        mask = torch.zeros((2, TEXT_LEN), dtype=torch.int32, device="cuda")
        mask[0, :PROMPT_TOKENS] = 1
        mask[1, :NEGATIVE_TOKENS] = 1
        text = umt5.umt5_encode(enc_t.params, enc_t.cfg, ids, mask)
        ctx = {"pe": text[:1], "ne": text[1:], "ie": enc_i(first_frame)}
        del enc_t, enc_i, text
        gc.collect()
        torch.cuda.empty_cache()
        src = _wan_source_pipe()
        mism += _tree_mismatches(pipe.dit_params, src.dit_params, "/dit")
        mism += _tree_mismatches(pipe.vae_params, src.vae_params, "/vae")
        del src
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        rec["rebuild_encode_compare_s"] = time.time() - t0
        rec["leaves_differing"] = mism[:20]
        rec["bit_equal"] = not mism
        if mism or rec["loaded_leaves_off_the_card"]:
            emit(rec)
            raise SystemExit(
                f"chip_smoke: {len(mism)} loaded leaves differ from their "
                f"sources ({mism[:5]}), "
                f"{rec['loaded_leaves_off_the_card']} are off the card")

        torch.cuda.reset_peak_memory_stats()
        run = _guided_generate(pipe, warp_dir, ctx)
        out = run["out"]
        ok = (out.shape == (1, 3, GEN_FRAMES, HEIGHT, WIDTH)
              and bool(np.isfinite(out).all()))
        rec.update({"generate": {
            "frames": GEN_FRAMES, "steps": GEN_STEPS, "height": HEIGHT,
            "width": WIDTH, "total_s": run["total_s"],
            "step_s": run["step_s"], "final_decode_s": run["final_decode_s"],
            "out_shape": list(out.shape), "finite": ok,
            "out_range": [float(out.min()), float(out.max())],
            "max_memory_allocated_gb":
            torch.cuda.max_memory_allocated() / 2 ** 30},
            "launches": run["launches"], "ok": ok})
        emit(rec)
        if not ok:
            raise SystemExit("chip_smoke: the generate on the loaded Wan set "
                             "gave a wrong output")
        _require_launches(run["launches"], WAN_PATH_KERNELS, "checkpoints")
        del pipe, out, run
        return rec["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _bf16_ulps(got, want) -> torch.Tensor:
    """|got - want| in bf16 ulps of ``want``, elementwise, fp32."""
    g, w = got.float(), want.float()
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return (g - w).abs() / torch.exp2(e - 7)


def phase_checkpoints_lora(pipe):
    """The distill LoRA merged into the refine / guided phases' 13.6B
    LongCat DiT, in memory: a synthetic rank-128 LoRA in the upstream
    naming (``lora___lorahyphen___`` names, the ``alpha_scale`` buffer) on
    every ``_TORCH_TO_TREE`` target of all 48 blocks, ``attn.qkv`` and
    ``cross_attn.kv_linear`` as ``lora_up.blocks.N``; then
    ``convert_longcat_lora`` + ``merge_lora_stacked`` on the card (timed)
    and one block's merged leaves against an fp32 CPU recompute, to 1 bf16
    ulp."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.convert_longcat import (
        _TORCH_TO_TREE, convert_longcat_lora, merge_lora_stacked)

    blocks = pipe.dit_params["blocks"]
    dev = blocks[0]["qkv"]["w"].device
    gen = P.make_generator(47, dev)
    hy = "___lorahyphen___"
    sd = {}
    for i, blk in enumerate(blocks):
        for sub, key in _TORCH_TO_TREE.items():
            din, dout = blk[key]["w"].shape
            n = {"attn.qkv": 3, "cross_attn.kv_linear": 2}.get(sub, 1)
            nm = "lora" + hy + f"blocks.{i}.{sub}".replace(".", hy)
            sd[f"{nm}.lora_down.weight"] = (P.normal(
                gen, (n * LORA_RANK, din)) / math.sqrt(din)).bfloat16()
            if n == 1:
                sd[f"{nm}.lora_up.weight"] = (0.02 * P.normal(
                    gen, (dout, LORA_RANK))).bfloat16()
            for j in range(n if n > 1 else 0):
                sd[f"{nm}.lora_up.blocks.{j}.weight"] = (0.02 * P.normal(
                    gen, (dout // n, LORA_RANK))).bfloat16()
            sd[f"{nm}.alpha_scale"] = torch.tensor(64.0 / LORA_RANK,
                                                   device=dev)
    rec = {"phase": "checkpoints", "part": "longcat_distill_lora",
           "config": f"longcat_13b (bf16; adaLN fp32), rank {LORA_RANK} on "
                     f"{len(_TORCH_TO_TREE)} targets x {len(blocks)} blocks",
           "lora_tensors": len(sd), "lora_gb": _nbytes_of(sd) / 1e9}
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    lora = convert_longcat_lora(sd)
    _sync(dev)
    rec["convert_s"] = time.time() - t0
    t0 = time.time()
    merged = merge_lora_stacked(pipe.dit_params, lora)
    _sync(dev)
    rec["merge_s"] = time.time() - t0
    rec["device_peak_above_model_gib"] = (torch.cuda.max_memory_allocated()
                                          - base) / 2 ** 30
    changed = sum(merged["blocks"][i][k]["w"] is not blocks[i][k]["w"]
                  for i in range(len(blocks)) for k in _TORCH_TO_TREE.values())
    b = len(blocks) - 1
    check, worst, off, total = {}, 0.0, 0, 0
    for sub, key in _TORCH_TO_TREE.items():
        ad = lora[f"blocks.{b}.{sub}"]
        w0 = blocks[b][key]["w"].cpu()
        down, up = ad["down"].cpu(), ad["up"].cpu()
        want = (w0.float() + down @ up * ad["multiplier"]
                * (ad["alpha"] / down.shape[1])).to(w0.dtype)
        d = _bf16_ulps(merged["blocks"][b][key]["w"].cpu(), want)
        check[key] = {"dtype": str(w0.dtype).split(".")[-1],
                      "max_bf16_ulps": float(d.max()),
                      "share_at_1_ulp": float((d > 0).float().mean())}
        worst = max(worst, float(d.max()))
        off += int((d > 0).sum())
        total += d.numel()
    ok = worst <= 1.0 and changed == len(lora) == len(blocks) * len(
        _TORCH_TO_TREE)
    rec.update({"adapters": len(lora), "leaves_changed": changed,
                "checked_block": b, "vs_cpu_fp32": check,
                "max_bf16_ulps": worst, "share_at_1_ulp": off / total,
                "ok": ok})
    emit(rec)
    del merged, lora, sd
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("chip_smoke: the merged LoRA disagrees with the CPU "
                         "recompute or missed a target")


def _fold_indices(name: str) -> str:
    import re
    return re.sub(r"(?<=\.)\d+(?=\.)", "N", name)


def _svd_checkpoint_check(up, ucfg, vp, vcfg):
    """The SVD UNet and VAE through the upstream layout: the tiny configs'
    exports (their inits on the card) must equal the frozen manifests
    ``tests/fixtures/svd_{unet,vae}_manifest.json`` name for name and shape
    for shape (the manifests were frozen at the tiny configs); the full-width
    exports of the depthcrafter phase's trees must have the manifests' names
    with the block and layer indices folded, the same ranks and kernel
    sizes; ``convert_svd_unet`` / ``convert_svd_vae`` on the card must give
    the trees back bit for bit."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.convert_depthcrafter import (
        convert_svd_unet, convert_svd_vae)
    from worldforge_tpu_torch.models.depthcrafter.unet import (SVDUNetConfig,
                                                               init_svd_unet)
    from worldforge_tpu_torch.models.depthcrafter.vae import (SVDVAEConfig,
                                                              init_svd_vae)
    rec = {"phase": "checkpoints", "part": "svd_unet_vae"}
    dev = up["conv_in"]["w"].device
    ok = True
    for which, tree, cfg, write, convert, tiny in (
            ("unet", up, ucfg, svd_unet_state_dict, convert_svd_unet,
             lambda: init_svd_unet(P.make_generator(48, dev),
                                   SVDUNetConfig.tiny())),
            ("vae", vp, vcfg, svd_vae_state_dict, convert_svd_vae,
             lambda: init_svd_vae(P.make_generator(49, dev),
                                  SVDVAEConfig.tiny()))):
        with open(os.path.join(HERE, "tests", "fixtures",
                               f"svd_{which}_manifest.json")) as f:
            manifest = json.load(f)
        tiny_sd = {k: list(v.shape) for k, v in write(tiny()).items()}
        tiny_equal = tiny_sd == manifest
        sd = write(tree)
        patterns = {}
        for k, s in manifest.items():
            patterns.setdefault(_fold_indices(k), s)

        def agrees(k, t):
            s = patterns.get(_fold_indices(k))
            return (s is not None and len(s) == t.dim()
                    and (t.dim() < 3 or list(t.shape[2:]) == s[2:]))
        names_ok = {_fold_indices(k) for k in sd} == set(patterns)
        shapes_ok = all(agrees(k, t) for k, t in sd.items())
        _sync(dev)
        t0 = time.time()
        back = convert(sd, cfg, device=dev)
        _sync(dev)
        convert_s = time.time() - t0
        mism = _tree_mismatches(back, tree)
        rec[which] = {"tiny_export_equals_manifest": tiny_equal,
                      "manifest_keys": len(manifest),
                      "full_width_keys": len(sd),
                      "names_fold_to_manifest": names_ok,
                      "ranks_and_kernels_agree": shapes_ok,
                      "gb": _nbytes_of(sd) / 1e9, "convert_s": convert_s,
                      "leaves_differing": mism[:10], "bit_equal": not mism}
        ok = ok and tiny_equal and names_ok and shapes_ok and not mism
        del sd, back
    rec["ok"] = ok
    emit(rec)
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("chip_smoke: the SVD export / conversion check "
                         "failed")


def _kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other PyTorch kernels"


def _profile_refine_forward(pipe, latent_shape, pe, pmask):
    """One DiT forward at the refine shape (the BSA step's model call)."""
    from worldforge_tpu_torch.models.longcat.dit import longcat_dit_forward
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(latent_shape, generator=gen, device="cuda")
    t = torch.full((1, latent_shape[2]), 333.0, device="cuda")
    pe, pmask = pe.cuda(), pmask.cuda()

    def forward():
        return longcat_dit_forward(
            pipe.dit_params, pipe.dit_cfg, x, t, pe,
            encoder_attention_mask=pmask, policy=pipe.policy,
            bsa_params={"sparsity": BSA_SPARSITY})

    _profile_forward(forward, "refine_profile", "one LongCat-13.6B DiT "
                     "forward at the refine shape, BSA 0.875, under "
                     "torch.profiler", {"latents": list(latent_shape)})


def _profile_forward(forward, phase, what, extra, warmup=None):
    """``forward`` (after one call of ``warmup``, by default ``forward``
    itself) under ``torch.profiler``: device time by kernel group, the
    device's busy and idle share of the forward's wall time, and the
    largest kernels. Outside the main paths' counting windows; a
    measurement, not a check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    (warmup or forward)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        forward()
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    spans, groups, kernels = [], {}, {}
    for e in prof.events():
        # device kernels and copies only: a user annotation's device span
        # covers the kernels inside it
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + us / 1e6
        ms, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (ms + us / 1e3, n + 1)
    busy_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": phase, "what": what, **extra, "wall_s": wall_s,
          "device_events": len(spans), "device_busy_s": busy_us / 1e6,
          "device_time_sum_s": sum(groups.values()),
          "device_idle_share": (1.0 - busy_us / 1e6 / wall_s)
          if spans else None,
          "by_group_s": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
          "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                          for n, (ms, c) in top]})


# ------------------------------------------------------------- parallel

PAR_RANKS = 4            # virtual ranks of the per-rank bodies
PAR_KERNELS = ("flash_attention", "rope_qk", "bsa")
_NCCL = {}


def _errors(out, ref, tol_rel=2e-2, tol_l2=1e-2) -> dict:
    """Kernel 1's gates (bf16 outputs): the largest error over the largest
    |ref| and the relative L2 error; NaN / inf fail."""
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel = err / max(float(ref.float().abs().max()), 1e-12)
    l2 = float(diff.norm() / ref.float().norm().clamp_min(1e-12))
    finite = bool(torch.isfinite(out).all())
    return {"max_abs_err": err, "max_rel_err": rel, "tol_rel": tol_rel,
            "rel_l2_err": l2, "tol_rel_l2": tol_l2, "finite": finite,
            "ok": finite and rel <= tol_rel and l2 <= tol_l2}


def _ring_body(q, k, v, r, p, scale):
    """Rank r's ring attention as ``ring_attention`` runs it between its
    exchanges: ``ring.ring_step`` over the shard ``ring.ring_owner`` says
    visits at each step."""
    from worldforge_tpu_torch.parallel import ring
    n = q.shape[1] // p
    qr = q[:, r * n:(r + 1) * n]
    state = None
    for step in range(p):
        o = ring.ring_owner(r, step, p)
        state = ring.ring_step(qr, k[:, o * n:(o + 1) * n],
                               v[:, o * n:(o + 1) * n], state, scale)
    return state[0].to(q.dtype)


def _bsa_rank_plan(q, k, r, p, sparsity):
    """Rank r's rows and selection as ``bsa_attention_3d_cp`` makes them:
    ``bsa_cp.rank_selection`` of its query chunks over every shard's
    ``bsa_cp.pool_keys`` (what the all-gather gives it); then, for each ring
    step, the visiting shard's rows, its owner, and (for the kernel-only
    timing) the owner's chunks of the selection by ``member_indices``."""
    from worldforge_tpu_torch.ops.bsa import CHUNK_Q
    from worldforge_tpu_torch.parallel import bsa_cp, ring
    nl = k.shape[1] // CHUNK_Q // p

    def rows(o):
        return slice(o * nl * CHUNK_Q, (o + 1) * nl * CHUNK_Q)

    kc = torch.cat([bsa_cp.pool_keys(k[:, rows(o)]) for o in range(p)],
                   dim=1)
    indices, counts = bsa_cp.rank_selection(q[:, rows(r)], kc,
                                            sparsity=sparsity)
    steps = []
    for step in range(p):
        o = ring.ring_owner(r, step, p)
        steps.append((rows(o), o,
                      *bsa_cp.member_indices(indices, counts, o * nl, nl)))
    return rows(r), indices, counts, steps


def _bsa_rank_body(q, k, v, plan, scale):
    """Rank r's BSA CP as ``bsa_attention_3d_cp`` runs it between its
    exchanges: ``bsa_cp.bsa_ring_step`` per visiting shard. Returns the
    rank's rows of the output and each step's counts."""
    from worldforge_tpu_torch.parallel import bsa_cp
    rows, indices, counts, steps = plan
    state, cnts = None, []
    for keys, owner, _, _ in steps:
        state, cnt = bsa_cp.bsa_ring_step(q[:, rows], k[:, keys], v[:, keys],
                                          indices, counts, owner, state,
                                          scale)
        cnts.append(cnt)
    return state[0].to(q.dtype), cnts


def _parallel_bodies(dev="cuda", grid=(13, 30, 52), heads=40, d=128,
                     bsa=(LC_HEADS, REFINE_TOKENS, 128), p=PAR_RANKS,
                     iters=3, timed=True):
    """The parallel phase's part (a): what each of ``p`` ranks computes
    between its collectives, one rank after another on one card, at the
    main paths' widths, held against the unsharded kernel on the same
    inputs. Returns (records, launches of the ranks' bodies)."""
    from worldforge_tpu_torch.ops.bsa import (CHUNK_Q, bsa_bhsd,
                                              select_blocks)
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    from worldforge_tpu_torch.ops.rope import apply_rope_qk, rope_cos_sin
    from worldforge_tpu_torch.parallel.cp2d import get_optimal_split
    gen = torch.Generator(device=dev).manual_seed(13)
    f, gh, gw = grid
    s = f * gh * gw
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn((1, s, heads, d), generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    bh, sb, db = bsa
    qb, kb, vb = (torch.randn((bh, sb, db), generator=gen, device=dev)
                  .bfloat16() for _ in range(3))
    nl = sb // CHUNK_Q // p
    # forced: the first nl // 5 query chunks of rank 0 select only rank 2's
    # key chunks (a shared direction in both), so ranks 0, 1 and 3 hold no
    # selected chunk of theirs: count 0 there
    u = torch.full((db,), 0.5, device=dev)
    qf, kf = qb.clone(), kb.clone()
    forced = nl // 5
    qf[:, :forced * CHUNK_Q] += u.bfloat16()
    kf[:, 2 * nl * CHUNK_Q:3 * nl * CHUNK_Q] += u.bfloat16()
    sph, spw = get_optimal_split(p)
    hl, wl = gh // sph, gw // spw
    raster = torch.arange(s, device=dev).reshape(f, gh, gw)
    cos_g, sin_g = rope_cos_sin(f, gh, gw, d, device=dev)

    # the unsharded kernels on the same inputs (outside the counted run)
    ref = flash_attention(q, k, v)
    rq_g, rk_g = apply_rope_qk(q, k, cos_g, sin_g)
    bsa_cases = {}
    for name, (qq, kk) in (("random", (qb, kb)), ("forced", (qf, kf))):
        idx, cnt = select_blocks(qq, kk, sparsity=BSA_SPARSITY)
        bsa_cases[name] = (qq, kk, idx, cnt, bsa_bhsd(qq, kk, vb, idx, cnt))
    _sync(dev)

    _reset_counters()
    ring_out = [_ring_body(q, k, v, r, p, scale) for r in range(p)]
    hg = heads // p
    uly_in = [[x[:, :, r * hg:(r + 1) * hg].contiguous() for x in (q, k, v)]
              for r in range(p)]
    uly_out = [flash_attention(*uly_in[r]) for r in range(p)]
    rope = []
    for r in range(p):
        i, j = divmod(r, spw)
        idx = raster[:, i * hl:(i + 1) * hl, j * wl:(j + 1) * wl].reshape(-1)
        cos, sin = rope_cos_sin(f, hl, wl, d, h_offset=i * hl,
                                w_offset=j * wl, device=dev)
        rope.append((idx, cos, sin, apply_rope_qk(q[:, idx], k[:, idx], cos,
                                                  sin)))
    plans, bsa_out = {}, {}
    bsa_scale = 1.0 / math.sqrt(db)
    for name, (qq, kk, idx, cnt, _) in bsa_cases.items():
        plans[name] = [_bsa_rank_plan(qq, kk, r, p, BSA_SPARSITY)
                       for r in range(p)]
        bsa_out[name] = [_bsa_rank_body(qq, kk, vb, plan, bsa_scale)
                         for plan in plans[name]]
    _sync(dev)
    launches = _read_counters()

    n = s // p
    recs = []
    rec = {"phase": "parallel", "part": "ring",
           "what": f"kernel 1 with return_lse over {p} shards of "
                   f"[1, {s}, {heads}, {d}] bf16 (Wan-14B self-attention), "
                   "by parallel/ring.py::ring_step in ring_owner's order, "
                   "against the unsharded kernel",
           "ranks": p, "shard_tokens": n,
           **_errors(torch.cat(ring_out, dim=1), ref)}
    recs.append(rec)
    rec = {"phase": "parallel", "part": "ulysses",
           "what": f"each rank's {hg} heads over all {s} tokens (kernel 1) "
                   "against the unsharded kernel's heads",
           "ranks": p, **_errors(torch.cat(uly_out, dim=2), ref)}
    rec["bit_equal"] = all(torch.equal(uly_out[r],
                                       ref[:, :, r * hg:(r + 1) * hg])
                           for r in range(p))
    recs.append(rec)
    rows_equal = all(torch.equal(c, cos_g[i]) and torch.equal(sn, sin_g[i])
                     for i, c, sn, _ in rope)
    rope_equal = all(torch.equal(o[0], rq_g[:, i]) and
                     torch.equal(o[1], rk_g[:, i]) for i, _, _, o in rope)
    recs.append({"phase": "parallel", "part": "cp2d_rope",
                 "what": f"{sph} x {spw} blocks of the {f} x {gh} x {gw} "
                         "grid: RoPE rows by h_offset / w_offset and kernel "
                         "2 on the block, against the global table's rows "
                         "and the unsharded kernel",
                 "block": [f, hl, wl], "rows_equal": rows_equal,
                 "bit_equal": rope_equal, "ok": rows_equal and rope_equal})
    for name, (qq, kk, idx, cnt, want) in bsa_cases.items():
        got = torch.cat([o for o, _ in bsa_out[name]], dim=1)
        sel_equal = all(torch.equal(plan[1], idx[:, r * nl:(r + 1) * nl])
                        for r, plan in enumerate(plans[name]))
        empty = [int(sum((c == 0).sum() for c in cnts))
                 for _, cnts in bsa_out[name]]
        rec = {"phase": "parallel", "part": f"bsa_cp_{name}",
               "what": f"BSA ring CP over {p} ranks of {nl} chunks each, "
                       f"[{bh}, {sb}, {db}] bf16 at sparsity {BSA_SPARSITY}"
                       ", parallel/bsa_cp.py::bsa_ring_step (kernel 5 "
                       "with return_lse per visiting shard, merged) in "
                       "ring_owner's order, against the unsharded kernel",
               "chunks": sb // CHUNK_Q, "kmax": int(idx.shape[-1]),
               "selection_equal": sel_equal,
               "empty_rank_pairs_by_rank": empty,
               "empty_rank_pairs": sum(empty), **_errors(got, want)}
        if name == "forced":
            rec["forced_query_chunks"] = forced
            rec["ok"] = rec["ok"] and sum(empty) >= forced * bh * (p - 1)
        recs.append(rec)
    if timed:
        _time_bodies(recs, q, k, v, scale, p, uly_in, bsa_cases, plans, vb,
                     iters)
    return recs, launches


def _time_bodies(recs, q, k, v, scale, p, uly_in, bsa_cases, plans, vb,
                 iters):
    """Each rank's kernel time beside the unsharded kernel's (kernel
    launches only; the merges and the selection are not in ``rank_ms``)."""
    from worldforge_tpu_torch.ops.bsa import bsa_bhsd
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    n = q.shape[1] // p
    by = {r["part"]: r for r in recs}

    def ring_kernels(r):
        for o in range(p):
            flash_attention(q[:, r * n:(r + 1) * n], k[:, o * n:(o + 1) * n],
                            v[:, o * n:(o + 1) * n], scale=scale,
                            return_lse=True)

    full = cuda_ms(lambda: flash_attention(q, k, v), iters)
    by["ring"].update(unsharded_ms=full, rank_ms=[
        cuda_ms(lambda r=r: ring_kernels(r), iters) for r in range(p)],
        rank_body_ms=[cuda_ms(lambda r=r: _ring_body(q, k, v, r, p, scale),
                              iters) for r in range(p)])
    by["ulysses"].update(unsharded_ms=full, rank_ms=[
        cuda_ms(lambda r=r: flash_attention(*uly_in[r]), iters)
        for r in range(p)])
    for name, (qq, kk, idx, cnt, _) in bsa_cases.items():
        def kernels(rows, steps, qq=qq, kk=kk):
            for keys, _, i, c in steps:
                bsa_bhsd(qq[:, rows], kk[:, keys], vb[:, keys], i, c,
                         return_lse=True)
        by[f"bsa_cp_{name}"].update(
            unsharded_ms=cuda_ms(lambda: bsa_bhsd(qq, kk, vb, idx, cnt),
                                 iters),
            rank_ms=[cuda_ms(lambda rw=rw, st=st: kernels(rw, st), iters)
                     for rw, _, _, st in plans[name]])


def phase_parallel_bodies():
    """Part (a) of the parallel phase: one line a part, then the launches
    line; every part must pass and kernels 1, 2 and 5 must launch."""
    t0 = time.time()
    recs, launches = _parallel_bodies()
    for rec in recs:
        emit(rec)
    emit({"phase": "parallel", "part": "bodies_launches",
          "launches": dict(launches), "seconds": time.time() - t0})
    bad = [r["part"] for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: parallel per-rank bodies failed: "
                         f"{bad}")
    _require_launches(launches, PAR_KERNELS, "parallel bodies")
    return launches


def _nccl_mesh():
    """The one-rank NCCL mesh of part (b), made once: the default group on
    NCCL over a localhost store, then the exchanges the parallel layer
    uses, each on the card through NCCL, held against their inputs."""
    if "mesh" in _NCCL:
        return _NCCL["mesh"]
    import socket

    import torch.distributed as dist
    from worldforge_tpu_torch.core.mesh import (AXIS_FSDP, AXIS_SP,
                                                TokenSplit,
                                                init_process_group,
                                                make_mesh)
    from worldforge_tpu_torch.parallel.sharding import gather_params
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_process_group("cuda", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{port}")
    mesh = make_mesh(1, 1, 1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((1, 333, 40, 128), generator=gen,
                    device="cuda").bfloat16()
    order = torch.randperm(333, generator=gen, device="cuda")
    split = TokenSplit(333, mesh, (AXIS_SP,), order=order)
    loc = split.split(x)
    heads = split.to_heads(loc)
    w = torch.randn((64, 96), generator=gen, device="cuda")
    chunk = w.clone().requires_grad_(True)
    chunk.fsdp_axis = 1
    full = gather_params({"w": chunk}, mesh)["w"]
    (full * 2.0).sum().backward()
    checks = {
        "to_heads": torch.equal(heads, x),
        "from_heads": torch.equal(split.from_heads(heads), loc),
        "gather": torch.equal(split.gather(loc), x),
        "fsdp_gather": torch.equal(full, w),
        "fsdp_reduce_scatter": torch.equal(chunk.grad,
                                           torch.full_like(w, 2.0))}
    torch.cuda.synchronize()
    rec = {"phase": "parallel", "part": "nccl_exchanges",
           "backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "mesh": mesh.shape, "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: an NCCL exchange at world size 1 "
                         "changed its input")
    _NCCL["mesh"] = mesh
    return mesh


def _parallel_nccl_forward(name, what, forward, kernels):
    """Part (b): the forward with the one-rank NCCL mesh against the same
    forward without one: bit for bit (the mesh path with every axis 1 is
    the mesh-free arithmetic). Returns the mesh run's launches."""
    mesh = _nccl_mesh()
    times = {}
    torch.cuda.synchronize()
    t0 = time.time()
    want = forward(None)
    torch.cuda.synchronize()
    times["mesh_free_s"] = time.time() - t0
    _reset_counters()
    t0 = time.time()
    got = forward(mesh)
    torch.cuda.synchronize()
    times["mesh_s"] = time.time() - t0
    launches = _read_counters()
    equal = torch.equal(got, want)
    rec = {"phase": "parallel", "part": name, "what": what,
           "mesh": mesh.shape, "backend": "nccl", **times,
           "out_shape": list(got.shape),
           "finite": bool(torch.isfinite(got).all()), "bit_equal": equal,
           "max_abs_diff": float((got - want).abs().max()),
           "launches": dict(launches)}
    rec["ok"] = equal and rec["finite"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"chip_smoke: the {name} forward under the "
                         "one-rank NCCL mesh differs from the mesh-free one")
    _require_launches(launches, kernels, name)
    return launches


def _dit_token_chunk(params, cfg, fwd_inputs, out_ref):
    """The Wan-14B forward at token_chunk 4 beside token_chunk 1 (the FFN
    over 4 token chunks: the same math, matmuls of a quarter of the rows),
    each with its device peak above the resident model."""
    from worldforge_tpu_torch.models.wan.dit import wan_dit_forward
    x, t, ctx, clip, y = fwd_inputs
    outs, rec = {}, {"phase": "dit", "part": "token_chunk",
                     "config": "wan_14b_i2v", "tokens":
                     (DIT_FRAMES // 4 + 1) * (HEIGHT // 16) * (WIDTH // 16)}
    for tc in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        outs[tc] = wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip,
                                   y=y, token_chunk=tc)
        torch.cuda.synchronize()
        rec[f"token_chunk_{tc}"] = {
            "forward_s": time.time() - t0,
            "peak_above_model_gib":
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    # a quarter of the rows may take another cuBLAS algorithm: the bf16
    # products then round elsewhere, so the gate is bf16-level
    rec.update(_errors(outs[4], outs[1], tol_rel=5e-2, tol_l2=1e-2))
    rec["bit_equal"] = torch.equal(outs[4], outs[1])
    rec["tc1_equals_phase_forward"] = torch.equal(outs[1], out_ref)
    rec["ok"] = rec["ok"] and rec["tc1_equals_phase_forward"]
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: the token_chunk=4 forward disagrees")


def phase_parallel_multi_card():
    """Part (c): the dry run over NCCL on min(4, cards) cards where there
    are two or more."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "parallel", "part": "multi_card",
              "multi_card": "not run: 1 card"})
        return
    from worldforge_tpu_torch.parallel.dryrun import run_dryrun
    n = min(4, count)
    t0 = time.time()
    phases = run_dryrun(n, "cuda")
    emit({"phase": "parallel", "part": "multi_card", "cards": n,
          "phases": phases, "seconds": time.time() - t0, "ok": True})


def _parallel_nccl_longcat(pipe, latent_shape, pe, pmask):
    """Part (b) for LongCat: one 13.6B refine forward (56,320 tokens, BSA
    0.875) under the one-rank NCCL mesh against the mesh-free one."""
    from worldforge_tpu_torch.models.longcat.dit import longcat_dit_forward
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(latent_shape, generator=gen, device="cuda")
    t = torch.full((1, latent_shape[2]), 333.0, device="cuda")
    pe, pmask = pe.cuda(), pmask.cuda()
    return _parallel_nccl_forward(
        "nccl_longcat_13b_refine", "one LongCat-13.6B refine forward at "
        "56,320 tokens with BSA 0.875 under make_mesh(1, 1, 1, "
        "device='cuda') (NCCL) against the mesh-free forward",
        lambda mesh: longcat_dit_forward(
            pipe.dit_params, pipe.dit_cfg, x, t, pe,
            encoder_attention_mask=pmask, policy=pipe.policy,
            bsa_params={"sparsity": BSA_SPARSITY}, mesh=mesh),
        ("flash_attention", "rope_qk", "bsa"))


# ------------------------------------------------ vae strips, depth tools

STRIP_COUNTS = (1, 2, 4)
STRIP_REPS = 1           # timed runs after the counted one (480p)
STRIP_GATE = 1e-5        # tiled against untiled, of the output's max |value|
# the card against the CPU: relative L2, tests/test_torch_vae_stream.py's
# kernel-mode gate (as the small refine check gates its streaming VAE)
STRIP_SMALL_TOL = 2e-2


def _merge_launches(a, b):
    """The sum of two runs' ``Launches``."""
    out = Launches((k, a.get(k, 0) + b.get(k, 0)) for k in set(a) | set(b))
    out.by_shape = {}
    for src in (a, b):
        for name, shapes in src.by_shape.items():
            dst = out.by_shape.setdefault(name, {})
            for key, n in shapes.items():
                dst[key] = dst.get(key, 0) + n
    return out


def _small_vae_strips_check():
    """``WanVAEConfig.tiny()`` widened to 32 (its mid attention one head of
    64, which the card's kernel takes), the zero-initialised attention
    projections randomised: the H-strip decode (3 latent frames of 4 x 4)
    and encode (5 frames of 32 x 32) at 2 and 4 strips on the card against
    the card's untiled run (within STRIP_GATE) and against the CPU's plain
    path, tiled and untiled: relative L2 within STRIP_SMALL_TOL, the
    largest relative difference recorded (one flipped bf16 rounding moves
    single values by percents). The CPU computes the card's conv
    arithmetic: kernel 4's plain version rounds its operands to bf16, and
    for the run the convs the card gives bf16 operands (``vae._xla_conv``:
    time convs, shortcuts; the CPU's stride-2 downsample, which the card
    runs on kernel 4's one tap) get them on the CPU too."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan import vae as wvae
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    from worldforge_tpu_torch.models.wan.vae_stream import (
        vae_decode_streaming, vae_encode_streaming)
    cfg = dataclasses.replace(WanVAEConfig.tiny(), dim=32)
    cpu = init_wan_vae(P.make_generator(3), cfg)
    gen = torch.Generator().manual_seed(5)
    for part in ("encoder", "decoder"):
        w = cpu[part]["mid"]["attn"]["proj"]["w"]
        w.copy_(0.2 * torch.randn(w.shape, generator=gen))
    card = P.tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.standard_normal((1, cfg.z_dim, 3, 4, 4)).astype(
        np.float32))
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 5, 32, 32)).astype(
        np.float32))
    rec = {"phase": "vae_strips", "part": "small_vs_cpu",
           "config": "WanVAEConfig.tiny() at dim 32",
           "gate_card_vs_cpu_rel_l2": STRIP_SMALL_TOL,
           "gate_tiled_vs_untiled": STRIP_GATE,
           "errors (rel max, rel l2)": {}}
    ok = True
    for what, fn, x in (("decode", vae_decode_streaming, z),
                        ("encode", vae_encode_streaming, video)):
        xla_conv = wvae._xla_conv
        wvae._xla_conv = lambda p, x, *, stride, padding: P.conv(
            p, x, stride=stride, padding=padding, bf16_operands=True)
        try:
            want = {n: fn(cpu, cfg, x, spatial_chunks=n) for n in (1, 2)}
        finally:
            wvae._xla_conv = xla_conv
        whole = fn(card, cfg, x.cuda()).cpu()
        for n in (1, 2, 4):
            got = fn(card, cfg, x.cuda(), spatial_chunks=n).cpu()
            if n > 1:
                err = _rel_max(got, whole)
                rec["errors (rel max, rel l2)"][
                    f"{what} card n{n} vs card n1"] = err
                ok &= err <= STRIP_GATE
            for ref_n, ref in want.items():
                err = (_rel_max(got, ref), _rel_l2(got, ref))
                rec["errors (rel max, rel l2)"][
                    f"{what} card n{n} vs cpu n{ref_n}"] = err
                ok &= err[1] <= STRIP_SMALL_TOL
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit("chip_smoke: the small H-strip VAE differs between "
                         "the card and the CPU")


def phase_vae_strips(card, work_dir):
    """The streaming Wan2.1 VAE's H-strip tiling (``spatial_chunks``) on the
    full-width VAE (random fp32 weights from seed 1, the subprocess child's
    seed), after the small check on the card against the CPU:

    - the streaming decode of 5 x 60 x 104 latents and the streaming
      encode of 17 x 480 x 832 frames at 1, 2 and 4 strips, each after a
      warm-up call, then STRIP_REPS more times: seconds of each run
      through ``utils/profiling.phase(sync_on=)``,
      the peak (``max_memory_allocated`` after a reset; also above what
      was allocated before), kernel 4's launches (3x3x3 and one-tap); the
      tiled outputs against the untiled: bit-equal, else within
      STRIP_GATE of the output's largest magnitude; more launches tiled;
    - the refine's streaming decode to 61 x 704 x 1280 at 1 and 4 strips
      (one run each, no warm-up): peaks and seconds;
    - ``decode_in_subprocess(spatial_chunks=2)`` of the 480p latents,
      bit-equal to the in-process decode (fp16, the child's output);
    - one decode at 2 strips under ``utils/profiling.trace``: its Chrome
      trace and its device events must name kernel 4's ``conv3d_kernel``.

    Returns the tiled runs' launches (the ``vae_strips`` path)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    from worldforge_tpu_torch.models.wan.vae_stream import (
        vae_decode_streaming, vae_encode_streaming)
    from worldforge_tpu_torch.ops.conv3d import conv2d_3x3, conv3d_causal
    from worldforge_tpu_torch.runtime.subproc import (decode_clip,
                                                      decode_in_subprocess)
    from worldforge_tpu_torch.utils import profiling

    _small_vae_strips_check()
    cfg = WanVAEConfig.wan_2_1()
    params = init_wan_vae(P.make_generator(1, "cuda"), cfg)
    gen = torch.Generator(device="cuda").manual_seed(6)
    z = torch.randn((1, cfg.z_dim, GEN_FRAMES // 4 + 1, HEIGHT // 8,
                     WIDTH // 8), generator=gen, device="cuda")
    video = torch.rand((1, 3, GEN_FRAMES, HEIGHT, WIDTH), generator=gen,
                       device="cuda") * 2 - 1
    zr = torch.randn((1, cfg.z_dim, REFINE_GRID[0], REFINE_H // 8,
                      REFINE_W // 8), generator=gen, device="cuda")
    fns = {"decode": lambda n: vae_decode_streaming(params, cfg, z,
                                                    spatial_chunks=n),
           "encode": lambda n: vae_encode_streaming(params, cfg, video,
                                                    spatial_chunks=n),
           "decode_704x1280": lambda n: vae_decode_streaming(
               params, cfg, zr, spatial_chunks=n)}
    tiled = None
    rec = {"phase": "vae_strips", "card": card,
           "config": "WanVAEConfig.wan_2_1(), fp32, random (seed 1)",
           "gate": STRIP_GATE, "runs": []}
    ok = True
    for what, fn in fns.items():
        counts = STRIP_COUNTS if what != "decode_704x1280" else (1, 4)
        whole = None
        for n in counts:
            if what != "decode_704x1280":
                fn(n)                      # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            holder = []
            with profiling.phase(f"{what} n{n}", sync_on=holder):
                holder.append(fn(n))
            launches = _read_counters()
            out = holder[0]
            run = {"what": what, "spatial_chunks": n,
                   "shape": list(out.shape),
                   "s": profiling.phase_report()[f"{what} n{n}"]["total_s"],
                   "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "peak_above_start_gb":
                       (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                   "conv3d_causal_launches": launches["conv3d_causal"],
                   "conv2d_3x3_launches": launches["conv2d_3x3"]}
            if n == 1:
                whole = out
            else:
                tiled = (launches if tiled is None
                         else _merge_launches(tiled, launches))
                diff = float((out - whole).abs().max())
                scale = float(whole.abs().max())
                run.update(bit_equal=torch.equal(out, whole),
                           max_abs_diff=diff, rel_to_max=diff / scale)
            del out, holder
            for k in range(STRIP_REPS if what != "decode_704x1280" else 0):
                again = []
                with profiling.phase(f"{what} n{n} rep{k}", sync_on=again):
                    again.append(fn(n))
                del again
            run["s_reps"] = [v["total_s"]
                             for v in profiling.phase_report().values()]
            rec["runs"].append(run)
        ones = [r for r in rec["runs"] if r["what"] == what]
        for r in ones[1:]:
            r["more_launches"] = (r["conv3d_causal_launches"]
                                  > ones[0]["conv3d_causal_launches"])
            ok &= r["more_launches"] and (r["bit_equal"]
                                          or r["rel_to_max"] <= STRIP_GATE)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    del zr, video

    # the subprocess decode at 2 strips: the child draws the same VAE
    lat = z.cpu().numpy()
    got, child_s = decode_in_subprocess(
        lat, cfg, params_seed=1, dtype="float32", spatial_chunks=2,
        device="cuda", workdir=os.path.join(work_dir, "subproc_strips"),
        verbose=False)
    want = decode_clip(params, cfg, z, spatial_chunks=2).half().cpu()
    got = torch.from_numpy(got)
    rec["subprocess"] = {"spatial_chunks": 2, "s_child": child_s,
                         "bit_equal": torch.equal(got, want),
                         "max_abs_diff": float((got.float()
                                                - want.float()).abs().max())}
    ok &= rec["subprocess"]["bit_equal"]

    # one tiled decode under the port's trace
    trace_dir = os.path.join(work_dir, "vae_strips_trace")
    with profiling.trace(trace_dir) as prof:
        vae_decode_streaming(params, cfg, z, spatial_chunks=2)
        torch.cuda.synchronize()
    kernel_events = [e for e in prof.key_averages()
                     if "conv3d_kernel" in e.key]
    with open(os.path.join(trace_dir, "trace.json")) as f:
        in_file = "conv3d_kernel" in f.read()
    rec["trace"] = {"file": os.path.relpath(os.path.join(trace_dir,
                                                         "trace.json"), HERE),
                    "conv3d_kernel_in_file": in_file,
                    "conv3d_kernel_events": sum(e.count
                                                for e in kernel_events),
                    "conv3d_kernel_device_ms": sum(
                        getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0))
                        for e in kernel_events) / 1e3}
    ok &= in_file and bool(kernel_events)
    rec["ok"] = ok
    emit(rec)
    del params, z
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("chip_smoke: the H-strip VAE failed a check")
    return tiled


DEPTH_APP_FRAMES = (8, 320, 512)         # the app's synthetic clip
DEPTH_BENCH_FRAMES = (8, 128, 192)       # each benchmark sequence


def _depth_clip(path, t, h, w, seed):
    """``_dc_video`` frames as a directory of PNGs."""
    import numpy as np
    from PIL import Image
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(_dc_video(t, h, w, seed)):
        Image.fromarray((f * 255).astype(np.uint8)).save(
            os.path.join(path, f"f{i:03d}.png"))


def phase_depth_tools(work_dir, card):
    """The depth tools through their entry points:

    - ``cli/depth_app`` with ``--random-init --device cuda`` at full width
      (the SVD UNet bf16 from seed 0, the VAE fp32 from seed 1, as JAX's
      app draws them), served on a localhost port: the form, one ``POST
      /run`` of an 8-frame 320 x 512 synthetic clip (max_res 512, 2 steps),
      the files it writes and ``/files/`` serving the depth npz;
    - ``cli/visualize_pcd`` on that npz and ``_input.mp4``: one PLY a frame;
    - ``cli/depth_benchmark --device cuda`` twice, each on two synthetic
      sequences: first through a ``--checkpoint_dir`` this phase writes
      with the script's ``svd_unet_state_dict`` / ``svd_vae_state_dict``
      from the small DepthCrafter's widened tiny trees (the loader's
      configs patched to them; the loader's route only, deleted
      afterwards), then at full width on 8 frames of 320 x 512, with
      ``load_converted_depthcrafter`` handing over the app's trees in
      memory: a full-width checkpoint would write 3.4 GB, past what a call
      may write to the card machine's disk beside the checkpoints phase's
      Wan set. The full-width pass is timed and counted. In both, each
      sequence's metrics must equal ``depth_metrics`` of ``estimate_depth``
      called directly, within 1e-6.

    Returns the app's and the full-width benchmark's launches by path."""
    import dataclasses
    import shutil
    import threading
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from worldforge_tpu_torch.cli import (depth_app, depth_benchmark,
                                          visualize_pcd)
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.frames import load_frames
    from worldforge_tpu_torch.models.depthcrafter import inference
    from worldforge_tpu_torch.models.depthcrafter.unet import (SVDUNetConfig,
                                                               init_svd_unet)
    from worldforge_tpu_torch.models.depthcrafter.vae import (SVDVAEConfig,
                                                              init_svd_vae)
    from worldforge_tpu_torch.utils.depth_metrics import depth_metrics
    from worldforge_tpu_torch.warp.pcd import read_ply

    root = os.path.join(work_dir, "depth_tools")
    shutil.rmtree(root, ignore_errors=True)
    t, h, w = DEPTH_APP_FRAMES
    _depth_clip(os.path.join(root, "clip"), t, h, w, seed=3)
    rec = {"phase": "depth_tools", "card": card, "part": "depth_app",
           "clip": [t, h, w], "max_res": 512, "steps": 2}
    paths = {}
    args = depth_app.build_parser().parse_args(
        ["--random-init", "--device", "cuda", "--port", "0",
         "--output-dir", os.path.join(root, "app_out")])
    t0 = time.time()
    pipe = depth_app._build_pipeline(args)
    torch.cuda.synchronize()
    rec["init_s"] = time.time() - t0
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              depth_app.make_handler(pipe, args))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            form_ok = "num denoising steps" in r.read().decode()
        body = urllib.parse.urlencode({
            "video": os.path.join(root, "clip"), "steps": "2", "cfg": "1.0",
            "max_res": "512", "length": str(t), "fps": "8"}).encode()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.time()
        with urllib.request.urlopen(base + "/run", data=body,
                                    timeout=600) as r:
            page = r.read().decode()
        rec["post_run_s"] = time.time() - t0
        paths["depth_app"] = _read_counters()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        outs = sorted(os.listdir(args.output_dir))
        npz = [n for n in outs if n.endswith("_depth.npz")]
        with urllib.request.urlopen(base + "/files/" + npz[0],
                                    timeout=60) as r:
            served = r.read()
    finally:
        srv.shutdown()
        srv.server_close()
    npz_path = os.path.join(args.output_dir, npz[0])
    depth = np.load(npz_path)["depth"]
    with open(npz_path, "rb") as f:
        served_equal = served == f.read()
    rec.update(form_ok=form_ok, result_page_ok="Generated depth" in page,
               files=outs, depth_shape=list(depth.shape),
               depth_finite=bool(np.isfinite(depth).all()),
               depth_range=[float(depth.min()), float(depth.max())],
               served_equal=served_equal,
               launches=dict(paths["depth_app"]))
    rec["ok"] = (form_ok and rec["result_page_ok"] and rec["served_equal"]
                 and rec["depth_finite"] and depth.shape == (t, h, w)
                 and 0.0 <= depth.min() and depth.max() <= 1.0
                 and any(n.endswith("_vis.mp4") for n in outs)
                 and any(n.endswith("_input.mp4") for n in outs))
    emit(rec)
    if not rec["ok"]:
        raise SystemExit("chip_smoke: depth_app failed a check")
    _require_launches(paths["depth_app"], ("flash_attention", "conv2d_3x3"),
                      "depth_app")

    # visualize_pcd on the app's npz and input video
    tag = npz[0][:-len("_depth.npz")]
    pcd_in = os.path.join(root, "pcd_in")
    os.makedirs(pcd_in)
    os.symlink(os.path.join(args.output_dir, npz[0]),
               os.path.join(pcd_in, "clip.npz"))
    os.symlink(os.path.join(args.output_dir, f"{tag}_input.mp4"),
               os.path.join(pcd_in, "clip_input.mp4"))
    t0 = time.time()
    visualize_pcd.main(["--data-path", pcd_in, "--vid-name", "clip",
                        "--out-dir", os.path.join(root, "pcd")])
    plys = sorted(os.listdir(os.path.join(root, "pcd")))
    pts, cols = read_ply(os.path.join(root, "pcd", plys[0]))
    pcd = {"phase": "depth_tools", "card": card, "part": "visualize_pcd",
           "s": time.time() - t0, "ply_frames": len(plys),
           "points_per_frame": len(pts)}
    pcd["ok"] = (len(plys) == t and len(pts) == -(-h * w // 8)
                 and cols.dtype == np.uint8)
    emit(pcd)
    if not pcd["ok"]:
        raise SystemExit("chip_smoke: visualize_pcd failed a check")

    # depth_benchmark on the card: the checkpoint route through a widened
    # tiny checkpoint, then the timed pass at full width on the app's trees
    ucfg = dataclasses.replace(SVDUNetConfig.tiny(),
                               block_out_channels=(64, 64, 128, 128),
                               num_attention_heads=(1, 1, 2, 2),
                               cross_attention_dim=64)
    vcfg = dataclasses.replace(SVDVAEConfig.tiny(),
                               block_out_channels=(32, 32, 64, 512))
    ckpt = os.path.join(root, "checkpoint")
    for which, sd in (
            ("unet", svd_unet_state_dict(init_svd_unet(
                P.make_generator(51, "cuda"), ucfg))),
            ("vae", svd_vae_state_dict(init_svd_vae(
                P.make_generator(52, "cuda"), vcfg)))):
        os.makedirs(os.path.join(ckpt, which))
        write_safetensors(os.path.join(ckpt, which, "model.safetensors"), sd)
    rng = np.random.default_rng(9)

    def sequences(name, frames, seed):
        seqs = []
        bt, bh, bw = frames
        for i in range(2):
            seq = os.path.join(root, f"{name}{i}")
            _depth_clip(os.path.join(seq, "frames"), bt, bh, bw,
                        seed=seed + i)
            np.save(os.path.join(seq, "depth.npy"),
                    rng.uniform(0.5, 4.0, (bt, bh, bw)).astype(np.float32))
            seqs.append(seq)
        with open(os.path.join(root, f"{name}.csv"), "w") as f:
            f.write("".join(s + "\n" for s in seqs))
        return seqs

    def bench_pass(name, seqs, max_res, checkpoint):
        """The CLI over the sequences (seconds, launches), then
        ``depth_metrics(estimate_depth(...))`` of each called directly."""
        out = os.path.join(root, f"{name}_eval.json")
        _reset_counters()
        t0 = time.time()
        depth_benchmark.main([
            "--csv", os.path.join(root, f"{name}.csv"), "--checkpoint_dir",
            checkpoint, "--num-inference-steps", "2", "--max_res",
            str(max_res), "--device", "cuda", "--output", out])
        cli_s = time.time() - t0
        launches = _read_counters()
        with open(out) as f:
            got = json.load(f)["per_sequence"]
        diffs = []
        for seq in seqs:
            pred = inference.estimate_depth(
                load_frames(os.path.join(seq, "frames")),
                num_inference_steps=2, max_res=max_res,
                checkpoint=checkpoint, device="cuda")
            want = depth_metrics(pred, np.load(os.path.join(seq,
                                                            "depth.npy")))
            diffs.append(max(abs(got[seq][k] - v) for k, v in want.items()))
        return {"cli_s": cli_s, "max_metric_diff": max(diffs),
                "abs_rel": [got[s]["abs_rel"] for s in seqs]}, launches

    bt, bh, bw = DEPTH_BENCH_FRAMES
    small = sequences("seq", DEPTH_BENCH_FRAMES, 10)
    saved = SVDUNetConfig.svd, SVDVAEConfig.svd
    SVDUNetConfig.svd = classmethod(lambda cls: ucfg)
    SVDVAEConfig.svd = classmethod(lambda cls: vcfg)
    load = {"phase": "depth_tools", "card": card,
            "part": "depth_benchmark_checkpoint_route",
            "what": "the loader's route only: a toy model, its seconds "
                    "are no finding", "sequences": [bt, bh, bw], "steps": 2,
            "checkpoint": "SVDUNetConfig.tiny() widened to (64, 64, 128, "
                          "128), SVDVAEConfig.tiny() to (32, 32, 64, 512)"}
    try:
        res, _ = bench_pass("seq", small, bw, ckpt)
    finally:
        SVDUNetConfig.svd, SVDVAEConfig.svd = saved
        shutil.rmtree(ckpt, ignore_errors=True)
    load.update(res, checkpoint_deleted=not os.path.exists(ckpt))
    load["ok"] = load["max_metric_diff"] <= 1e-6
    emit(load)
    if not load["ok"]:
        raise SystemExit("chip_smoke: depth_benchmark's metrics through a "
                         "checkpoint differ from estimate_depth's")

    # full width: the loader hands over the app's trees, in memory (a
    # full-width checkpoint would write 3.4 GB to a disk the checkpoints
    # phase nearly fills)
    from worldforge_tpu_torch.io import convert_depthcrafter
    loads = []

    def app_trees(checkpoint, device=None, **kw):
        loads.append(str(device))
        return pipe

    ft, fh, fw = DEPTH_APP_FRAMES
    full = sequences("full", DEPTH_APP_FRAMES, 20)
    bench = {"phase": "depth_tools", "card": card, "part": "depth_benchmark",
             "sequences": [ft, fh, fw], "max_res": 512, "steps": 2,
             "weights": "the app's full-width random trees (SVD UNet bf16 "
                        "seed 0, VAE fp32 seed 1), handed to the CLI by "
                        "the loader"}
    saved_load = convert_depthcrafter.load_converted_depthcrafter
    convert_depthcrafter.load_converted_depthcrafter = app_trees
    try:
        res, paths["depth_benchmark"] = bench_pass("full", full, 512,
                                                   "in-memory")
    finally:
        convert_depthcrafter.load_converted_depthcrafter = saved_load
    bench.update(res, loads=loads, launches=dict(paths["depth_benchmark"]))
    bench["ok"] = (bench["max_metric_diff"] <= 1e-6
                   and loads == ["cuda"] * 4)
    emit(bench)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    if not bench["ok"]:
        raise SystemExit("chip_smoke: depth_benchmark's metrics differ from "
                         "estimate_depth's")
    _require_launches(paths["depth_benchmark"], DEPTHCRAFTER_PATH_KERNELS,
                      "depth_benchmark")
    return paths


def main() -> int:
    card = phase_device()
    phase_build()
    decode93 = _measure_decode_alone((AVATAR_CLI_FRAMES - 1) // 4 + 1)
    main_recs = phase_kernels()
    by_path = {"parallel_bodies": phase_parallel_bodies()}
    phase_flf()
    phase_vae(card)
    by_path["vae_strips"] = phase_vae_strips(
        card, os.path.join(HERE, "build", "chip_smoke"))
    by_path["parallel_nccl_wan"], by_path["runtime_streaming"] = phase_dit()
    warp_dir, by_path["warp"] = phase_warp(
        os.path.join(HERE, "build", "chip_smoke"))
    by_path["sfm"] = phase_sfm(os.path.join(HERE, "build", "chip_smoke"),
                               card)
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_depthcrafter(
        os.path.join(HERE, "build", "chip_smoke")))
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_depth_tools(
        os.path.join(HERE, "build", "chip_smoke"), card))
    frames, _ = _frames_480p(warp_dir)
    ctx, by_path["encoders"] = phase_encoders(
        frames[0, :, 0].transpose(1, 2, 0),
        frames[0, :, -1].transpose(1, 2, 0))
    bf16_run = phase_generate(warp_dir, ctx)
    by_path["generate"] = bf16_run["launches"]
    by_path["fused"] = bf16_run["fused"]
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_quant(warp_dir, ctx, bf16_run))
    del bf16_run
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_train())
    gc.collect()
    torch.cuda.empty_cache()
    by_path["checkpoints"] = phase_checkpoints(
        warp_dir, frames[0, :, 0].transpose(1, 2, 0))
    by_path.update(phase_wan_facades(warp_dir, ctx))
    by_path["refine"], longcat_pipe, by_path["parallel_nccl_longcat"] = \
        phase_refine()
    gc.collect()
    torch.cuda.empty_cache()
    by_path["longcat_guided"], by_path["longcat_guided_fused"] = \
        phase_longcat_guided(*longcat_pipe)
    phase_checkpoints_lora(longcat_pipe[0])
    del longcat_pipe
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(phase_avatar(frames, ctx, os.path.join(
        HERE, "build", "chip_smoke"), decode93))
    by_path["runtime_dryrun"] = runtime_dryrun()
    phase_parallel_multi_card()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

    names = set().union(*by_path.values())
    launches = {name: sum(counts.get(name, 0) for counts in by_path.values())
                for name in sorted(names)}
    emit({"phase": "launches", "by_path": by_path, "total": launches})
    rows = [(name, meta, name, None) for name, meta in KERNEL_META.items()]
    rows += [(row, {**KERNEL_META[counter], "launches_counted":
                    "the launches at this row's shape"}, counter, shape)
             for row, counter, shape in DC_ROWS + FACADE_ROWS + WAN_ROWS
             + SFM_ROWS + F32_ROWS]

    def count(counts, counter, shape):
        if shape is None:
            return counts.get(counter, 0)
        return sum(n for k, n in getattr(counts, "by_shape", {}).get(
            counter, {}).items() if shape(k))

    table = []
    for name, meta, counter, shape in rows:
        rec = main_recs[name]
        row = {"name": name, **meta,
               "launches": sum(count(c, counter, shape)
                               for c in by_path.values()),
               "launches_by_path": {path: count(c, counter, shape)
                                    for path, c in by_path.items()},
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"],
               "library_ms": rec["library_ms"]}
        if name == "flash_attention":
            row["launches_by_instantiation"] = {
                k[len("flash_attention "):]: n for k, n in launches.items()
                if k.startswith("flash_attention ")}
            row["instantiations"] = {
                inst: KERNEL1_INSTANTIATIONS[inst]
                for inst in row["launches_by_instantiation"]}
            row["device_launches_by_instantiation"] = {
                inst: sum(getattr(c, "passes", {}).get(inst, 0)
                          for c in by_path.values())
                for inst in row["launches_by_instantiation"]}
        if "grid_checks" in rec:
            row["grid_checks"] = rec["grid_checks"]
        table.append(row)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
