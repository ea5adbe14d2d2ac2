"""Drive the PyTorch port on one NVIDIA card and check every kernel.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device  -- the card's name and power limit (``nvidia-smi``).
2. build   -- compiles the CUDA C++ kernels from ``worldforge_tpu_torch/csrc``.
3. kernels -- each of the four kernels against its plain PyTorch version at
   the main path's shapes: error, kernel time, plain time, the time of one
   PyTorch library call for the same function (a yardstick only, never used
   by the port), and the card's bound for the same work.
4. dit     -- one Wan2.1-I2V-14B DiT forward at full width and depth on
   480x832x49 frames (20,280 tokens).
5. generate -- the guided repaint (CFG + IRR + VAE fuse + DSG + final decode)
   through ``load_wan_pipeline`` and ``WanI2VPipeline.generate`` at full
   width with the cuts listed on its line; every kernel's launch count must
   rise during this phase.

The line before the last holds the kernel table; the last line is the device
summary.
"""

from __future__ import annotations

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

# H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
# tensor cores, and device memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Main-path shapes: 480x832 pixels, 49 frames -> 13 x 60 x 104 latents,
# 13 x 30 x 52 = 20,280 DiT tokens; the generate phase runs 17 frames.
DIT_FRAMES, HEIGHT, WIDTH = 49, 480, 832
GEN_FRAMES = 17
GEN_STEPS = 3
GEN_LAYERS = 40          # DiT depth of the generate phase (of 40)

def emit(obj) -> None:
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
    logs = _build.build(_build.CUDA_SOURCES)
    for name in _build.CUDA_SOURCES:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "sources": list(_build.CUDA_SOURCES),
          "seconds": round(time.time() - t0, 3), "ptxas": ptxas})


def _check_flash(gen, records, b, sq, sk, h, d, dtype, tol_rel, tol_l2,
                 label, iters):
    """Kernel 1 against its plain version. The gates scale with the output:
    the largest error over the largest |ref| (a bf16 output is rounded to
    within 2^-8 of itself on both sides) and the relative L2 error (leaving
    out one 64-key tile of 20,280 moves the self-attention output by about
    8 / sqrt(20280) = 6% in L2)."""
    from worldforge_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel = err / max(float(ref.float().abs().max()), 1e-12)
    rel_l2 = float(diff.norm() / ref.float().norm().clamp_min(1e-12))
    ok = (bool(torch.isfinite(out).all()) and rel <= tol_rel
          and rel_l2 <= tol_l2)
    ms = cuda_ms(lambda: flash_attention(q, k, v), iters)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 1)
    flops = 4.0 * b * h * sq * sk * d
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    bms, by = bound(flops, nbytes(q, k, v) + nbytes(q), peak)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt), iters)
    rec = {"check": label, "shape": [b, sq, sk, h, d], "dtype": str(dtype),
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol_rel,
           "rel_l2_err": rel_l2, "tol_rel_l2": tol_l2,
           "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "library_ms": lib_ms}
    records.append(rec)
    return rec


def _check_flash_masked(gen, records, d, dtype):
    """Kernel 1's kv_lens masking and return_lse outputs at a small shape:
    batch rows with kv_len 0, a ragged length (not a multiple of any kv
    tile) and the full length. o, m and l are held against the plain
    version; the kv_len = 0 row must be exactly zero with m = -1e30, l = 0."""
    from worldforge_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_plain)
    b, sq, sk, h = 3, 200, 300, 2
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
    kv_lens = torch.tensor([0, 77, sk], dtype=torch.int32, device="cuda")
    o, m, l = flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True)
    ro, rm, rl = flash_attention_plain(q, k, v, kv_lens=kv_lens,
                                       return_lse=True)
    torch.cuda.synchronize()
    zero_row = (bool((o[0] == 0).all()) and bool((m[0] == NEG_INF).all())
                and bool((l[0] == 0).all()))
    of, rof = o[1:].float(), ro[1:].float()
    o_rel = float((of - rof).abs().max() / rof.abs().max())
    m_err = float(((m[1:] - rm[1:]).abs() / (1.0 + rm[1:].abs())).max())
    l_rel = float(((l[1:] - rl[1:]).abs() / rl[1:]).max())
    tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
    tol_ml = 1e-4
    ok = (zero_row and bool(torch.isfinite(o).all()) and o_rel <= tol_o
          and m_err <= tol_ml and l_rel <= tol_ml)
    rec = {"check": f"flash_attention kv_lens+lse {dtype} d{d}",
           "shape": [b, sq, sk, h, d], "kv_lens": kv_lens.tolist(),
           "zero_row_exact": zero_row, "o_max_rel_err": o_rel,
           "tol_o_rel": tol_o, "m_err": m_err, "l_rel_err": l_rel,
           "tol_m_l": tol_ml, "ok": ok}
    records.append(rec)
    return rec


def _check_rope(gen, records, s, h, d, iters):
    from worldforge_tpu_torch.ops.rope import (apply_rope_qk,
                                               apply_rope_qk_plain,
                                               rope_cos_sin)
    q = torch.randn((1, s, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, s, h, d), generator=gen, device="cuda").bfloat16()
    cos, sin = rope_cos_sin(DIT_FRAMES // 4 + 1, HEIGHT // 16, WIDTH // 16,
                            d, device="cuda")
    qo, ko = apply_rope_qk(q, k, cos, sin)
    qr, kr = apply_rope_qk_plain(q, k, cos, sin)
    torch.cuda.synchronize()
    ulps = max(bf16_ulps(qo, qr), bf16_ulps(ko, kr))
    err = max(float((qo.float() - qr.float()).abs().max()),
              float((ko.float() - kr.float()).abs().max()))
    ms = cuda_ms(lambda: apply_rope_qk(q, k, cos, sin), iters)
    plain_ms = cuda_ms(lambda: apply_rope_qk_plain(q, k, cos, sin), 3)
    flops = 6.0 * q.numel()    # 4 multiplies + 2 adds per pair, q and k
    bms, by = bound(flops, 2 * nbytes(q, k) + nbytes(cos, sin),
                    PEAK_FP32_FLOPS)
    rec = {"check": "rope_qk", "shape": list(q.shape), "max_abs_err": err,
           "max_ulps_bf16": ulps, "tol_ulps": 1, "ok": ulps <= 1, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": None}
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
    rec = {"check": "modulated_layer_norm", "shape": list(x.shape),
           "max_abs_err": err, "max_ulps_bf16": ulps, "tol_ulps": 1,
           "ok": ulps <= 1, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "library_ms": None}
    records.append(rec)
    return rec


def _check_conv(gen, records, t, hh, ww, cin, cout, iters, label,
                with_library: bool = True):
    from worldforge_tpu_torch.ops.conv3d import (conv3d_causal,
                                                 conv3d_causal_plain)
    x = torch.randn((1, t + 2, hh, ww, cin), generator=gen, device="cuda")
    w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                    device="cuda") / math.sqrt(27 * cin)
    b = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    out = conv3d_causal(x, w, b)
    ref = conv3d_causal_plain(x, w, b)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-12)
    tol = 1e-3
    ms = cuda_ms(lambda: conv3d_causal(x, w, b), iters)
    plain_ms = cuda_ms(lambda: conv3d_causal_plain(x, w, b), 1)
    flops = 2.0 * 27 * cin * cout * t * hh * ww
    bms, by = bound(flops, nbytes(x, w, b) + nbytes(out), PEAK_BF16_FLOPS)
    lib_ms = None
    if with_library:
        xl = x.bfloat16().permute(0, 4, 1, 2, 3).contiguous()
        wl = w.bfloat16().permute(4, 3, 0, 1, 2).contiguous()
        bl = b.bfloat16()
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(
            xl, wl, bl, padding=(0, 1, 1)), iters)
    rec = {"check": label, "shape": [t, hh, ww, cin, cout],
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "ok": bool(torch.isfinite(out).all()) and rel <= tol, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": lib_ms}
    records.append(rec)
    return rec


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
    _check_flash(gen, records, 1, s, 512, 40, 128, torch.bfloat16, 2e-2,
                 1e-2, "flash_attention text cross-attn", 10)
    _check_flash(gen, records, 1, s, 257, 40, 128, torch.bfloat16, 2e-2,
                 1e-2, "flash_attention clip cross-attn", 10)
    _check_flash(gen, records, GEN_FRAMES // 4 + 1, (HEIGHT // 8) *
                 (WIDTH // 8), (HEIGHT // 8) * (WIDTH // 8), 1, 384,
                 torch.float32, 1e-4, 1e-4, "flash_attention vae fp32 d384", 3)
    for dtype, dims in ((torch.bfloat16, (64, 128)),
                        (torch.float32, (64, 128, 384))):
        for d in dims:
            _check_flash_masked(gen, records, d, dtype)
    main["rope_qk"] = _check_rope(gen, records, s, 40, 128, 20)
    main["modulated_layer_norm"] = _check_mod_ln(gen, records, s, 5120, 20)
    main["conv3d_causal"] = _check_conv(
        gen, records, GEN_FRAMES, HEIGHT, WIDTH, 96, 96, 3,
        "conv3d 96->96 full res")
    _check_conv(gen, records, GEN_FRAMES, HEIGHT, WIDTH, 3, 96, 3,
                "conv3d encoder conv_in 3->96", with_library=False)
    _check_conv(gen, records, GEN_FRAMES, HEIGHT, WIDTH, 96, 3, 3,
                "conv3d decoder conv_out 96->3", with_library=False)
    _check_conv(gen, records, GEN_FRAMES // 4 + 1, HEIGHT // 8, WIDTH // 8,
                384, 384, 5, "conv3d 384->384 latent res",
                with_library=False)
    for rec in records:
        emit({"phase": "kernels", **rec})
    bad = [r["check"] for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain "
                         f"versions: {bad}")
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
}


def kernel_counters():
    from worldforge_tpu_torch.ops.conv3d import conv3d_causal
    from worldforge_tpu_torch.ops.flash_attention import flash_attention
    from worldforge_tpu_torch.ops.fused_norm import modulated_layer_norm
    from worldforge_tpu_torch.ops.rope import apply_rope_qk
    return {"flash_attention": flash_attention, "rope_qk": apply_rope_qk,
            "modulated_layer_norm": modulated_layer_norm,
            "conv3d_causal": conv3d_causal}


def _reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def _read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


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
    del params, out
    torch.cuda.empty_cache()


def _small_generate_check():
    """The same small random-init pipeline (the loader's reduced default
    configs, fp32 policy; weights drawn on the CPU and copied to the card)
    generated on the card with the kernels and on the CPU with their plain
    versions, from the same noise stream."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.core.dtypes import FP32_POLICY
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
    rng = np.random.default_rng(0)
    f, hw = 5, 64
    image = rng.uniform(-1, 1, (1, 3, hw, hw)).astype(np.float32)
    ref = rng.uniform(0, 1, (1, 3, f, hw, hw)).astype(np.float32)
    mask = np.zeros((1, 1, f, hw, hw), np.float32)
    mask[..., : hw // 2] = 1.0
    guide = GuidanceConfig(guided=True, guide_steps=2, resample_steps=2,
                           resample_round=2, omega=1.8, use_flf=False)
    pipe, enc_t, enc_i = load_wan_pipeline(random_init=True, device="cpu",
                                           policy=FP32_POLICY)
    on_card = dataclasses.replace(
        pipe, dit_params=P.tree_map(lambda t: t.cuda(), pipe.dit_params),
        vae_params=P.tree_map(lambda t: t.cuda(), pipe.vae_params))
    outs = {}
    for dev, pipe in (("cuda", on_card), ("cpu", pipe)):
        noise = np.random.default_rng(7)
        outs[dev] = pipe.generate(
            None, image, enc_t("a prompt"), enc_t("a negative prompt"),
            enc_i(image), height=hw, width=hw, num_frames=f,
            num_inference_steps=2, guidance_scale=5.0, video_ref=ref,
            mask=mask, guidance=guide, output_type="latent",
            noise_fn=lambda s: noise.standard_normal(s).astype(np.float32)
        ).float().cpu()
    a, b = outs["cuda"], outs["cpu"]
    rel_l2 = float((a - b).norm() / b.norm())
    rel_max = float((a - b).abs().max() / b.abs().max())
    # bf16 rounding of the conv inputs flips on last-bit fp32 differences
    # (see tests/test_torch_pipeline.py): bf16 noise level
    tol = 2e-2
    ok = bool(torch.isfinite(a).all()) and rel_l2 < tol
    emit({"phase": "generate_small_vs_cpu", "shape": list(a.shape),
          "rel_l2": rel_l2, "rel_max": rel_max, "tol_rel_l2": tol,
          "ok": ok})
    if not ok:
        raise SystemExit("chip_smoke: small generate disagrees with the "
                         "CPU run of the plain versions")


def phase_generate():
    """The guided repaint at full width through the user's entry points."""
    import dataclasses

    import numpy as np
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    _small_generate_check()

    dit_cfg = dataclasses.replace(WanDiTConfig.wan_14b_i2v(),
                                  num_layers=GEN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe, encode_text, encode_image = load_wan_pipeline(
        random_init=True, device="cuda", dit_cfg=dit_cfg,
        vae_cfg=WanVAEConfig.wan_2_1())
    torch.cuda.synchronize()
    init_s = time.time() - t0

    rng = np.random.default_rng(0)
    f, h, w = GEN_FRAMES, HEIGHT, WIDTH
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.stack([0.5 + 0.4 * np.sin((xx + 8 * i) / 37.0)[None]
                       * np.cos(yy / 23.0)[None] * np.ones((3, 1, 1))
                       for i in range(f)], axis=1)[None]   # [1,3,F,H,W]
    frames = np.clip(frames + 0.05 * rng.standard_normal(frames.shape), 0, 1
                     ).astype(np.float32)
    mask = np.zeros((1, 1, f, h, w), np.float32)
    mask[..., : w // 2] = 1.0          # the warped half is trusted
    image = (frames[:, :, 0] * 2.0 - 1.0).astype(np.float32)
    guide = GuidanceConfig(guided=True, guide_steps=GEN_STEPS,
                           resample_steps=2, resample_round=GEN_STEPS,
                           omega=1.8, omega_resample=1.0, use_flf=False)
    pe = encode_text("a prompt")
    ne = encode_text("a negative prompt")
    ie = encode_image(frames[0, :, 0])
    gen = torch.Generator(device="cuda").manual_seed(42)

    marks = []

    def on_step(i, lat):
        torch.cuda.synchronize()
        marks.append(time.time())

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    out = pipe.generate(gen, image, pe, ne, ie, height=h, width=w,
                        num_frames=f, num_inference_steps=GEN_STEPS,
                        guidance_scale=5.0, video_ref=frames, mask=mask,
                        guidance=guide, callback=on_step)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = _read_counters()
    step_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    ok_shape = out.shape == (1, 3, f, h, w)
    finite = bool(np.isfinite(out).all())
    emit({"phase": "generate", "config": "wan_14b_i2v + wan_2_1 vae",
          "cuts": {"layers": f"{GEN_LAYERS} of 40", "frames":
                   f"{GEN_FRAMES} of 49", "steps": f"{GEN_STEPS} of 50"},
          "height": h, "width": w, "frames": f, "steps": GEN_STEPS,
          "resample_steps": 2, "guide_steps": GEN_STEPS,
          "guidance_scale": 5.0, "omega": 1.8, "init_s": init_s,
          "total_s": total_s, "step_s": step_s,
          "final_decode_s": total_s - (marks[-1] - t0),
          "launches": launches,
          "launches_per_step": {k: v / GEN_STEPS for k, v in
                                launches.items()},
          "out_shape": list(out.shape), "finite": finite,
          "out_range": [float(out.min()), float(out.max())],
          "max_memory_allocated_gb":
          torch.cuda.max_memory_allocated() / 2 ** 30})
    if not (ok_shape and finite):
        raise SystemExit("chip_smoke: generate output is wrong")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels not launched on the main "
                         f"path: {idle}")
    return launches


def main() -> int:
    phase_device()
    phase_build()
    main_recs = phase_kernels()
    phase_dit()
    launches = phase_generate()

    table = []
    for name, meta in KERNEL_META.items():
        rec = main_recs[name]
        table.append({"name": name, **meta, "launches": launches[name],
                      "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                      "bound_by": rec["bound_by"],
                      "library_ms": rec["library_ms"]})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
