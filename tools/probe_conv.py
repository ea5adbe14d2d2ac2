"""Where kernel 4 (``csrc/conv3d.cu``) spends its time, on the card, at the
shapes its design was not first built for: the SVD UNet's one-tap convs at
its 8 x 13 and 16 x 26 levels (24 frames) and the Wan2.1 VAE's 3-channel
conv_in and conv_out (17 x 480 x 832, fp32 in and out), beside the 32 x 52
level and the VAE's 96 -> 96 at full resolution:

- the call against cuDNN (bf16 ``F.conv2d`` / ``F.conv3d`` with the casts
  inside the timed call, as ``chip_smoke.py`` times it), in turns on the
  same inputs, each output's largest error against the plain version, the
  bound, and the tile plan;
- with ``--variants``, copies of the source that drop the epilogue's
  stores, the products, or the products, the fragment loads and the stores
  (the producer's loads alone), each built and timed in a process of its
  own (their outputs are garbage: timing only).

Run it on a CUDA machine from the repository root (it imports
``chip_smoke``'s timers):

    python -m tools.probe_conv [--variants] [--out FILE]

It prints one JSON object a line, and appends them to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys

import torch

from chip_smoke import PEAK_BF16_FLOPS, bound, cuda_ms, in_turns, nbytes
from worldforge_tpu_torch.ops import _build
from worldforge_tpu_torch.ops import conv3d as cv

# (taps, frames, H, W, Cin, Cout): taps 1 is ``conv2d_3x3`` on that many
# frames, taps 3 ``conv3d_causal`` on frames + 2 input frames
SHAPES = ((1, 24, 8, 13, 2560, 1280), (1, 24, 8, 13, 1280, 1280),
          (1, 24, 16, 26, 2560, 1280), (1, 24, 32, 52, 1280, 1280),
          (3, 17, 480, 832, 3, 96), (3, 17, 480, 832, 96, 3),
          (3, 17, 480, 832, 96, 96))
# (name, [(text, replacement)]) applied to a copy of csrc/conv3d.cu; noop_
# takes its arguments by value and does nothing
_NOOP = ("template <class... A> __device__ __forceinline__ void noop_(A...) "
         "{}\nnamespace {")
_NO_STORES = [("static_cast<__nv_bfloat16*>(a.y)[dst] = __float2bfloat16(v);",
               "noop_(dst, v);"),
              ("static_cast<float*>(a.y)[dst] = v;", "noop_(dst, v);"),
              ("*reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) + "
               "dst) =\n          pack8(v);", "noop_(dst, v[0]);"),
              ("*reinterpret_cast<float4*>(static_cast<float*>(a.y) + dst) "
               "= lo;", "noop_(dst, lo.x);"),
              ("*reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.y) "
               "+\n                                         dst) = "
               "pack_bf16(v0, v1);", "noop_(dst, v0, v1);"),
              ("*reinterpret_cast<float2*>(static_cast<float*>(a.y) + dst) "
               "=\n                make_float2(v0, v1);",
               "noop_(dst, v0, v1);")]
_NO_MMA = [("wgmma_rs<N>(", "noop_(")]
_NO_FRAGS = [("ldmatrix_x4(frag", "noop_(frag")]
VARIANTS = {"no_stores": _NO_STORES, "no_mma": _NO_MMA,
            "loads_only": _NO_STORES + _NO_MMA + _NO_FRAGS}


def _inputs(taps, frames, hh, ww, cin, cout):
    gen = torch.Generator(device="cuda").manual_seed(cin * 7 + cout)
    lead = (1, frames + 2) if taps == 3 else (frames,)
    x = torch.randn((*lead, hh, ww, cin), generator=gen, device="cuda")
    w = torch.randn((3,) * (taps // 3 + 2) + (cin, cout), generator=gen,
                    device="cuda") / math.sqrt(9 * taps * cin)
    b = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return x, w, b


def _calls(taps, x, w, b):
    """The kernel, its plain version and the cuDNN yardstick."""
    if taps == 3:
        wl = w.bfloat16().permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        xv = x.permute(0, 4, 1, 2, 3)
        return (lambda: cv.conv3d_causal(x, w, b),
                lambda: cv.conv3d_causal_plain(x, w, b),
                lambda: torch.nn.functional.conv3d(
                    xv.to(torch.bfloat16), wl, b.bfloat16(),
                    padding=(0, 1, 1)).float())
    wl = w.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xv = x.permute(0, 3, 1, 2)
    return (lambda: cv.conv2d_3x3(x, w, b),
            lambda: cv.conv2d_3x3_plain(x, w, b),
            lambda: torch.nn.functional.conv2d(
                xv.to(torch.bfloat16), wl, b.bfloat16(), padding=1).float())


def _plan(taps, x, cin, cout):
    hh, ww = x.shape[-3], x.shape[-2]
    b, frames = (x.shape[0], x.shape[1] - 2) if taps == 3 else (1, x.shape[0])
    return vars(cv.conv_plan(cin, cout, x.dtype, taps=taps, batch=b,
                             frames=frames, height=hh, width=ww))


def measure(emit):
    for taps, frames, hh, ww, cin, cout in SHAPES:
        x, w, b = _inputs(taps, frames, hh, ww, cin, cout)
        kernel, plain, cudnn = _calls(taps, x, w, b)
        out, ref = kernel(), plain()
        err = float((out - ref).abs().max() / ref.abs().max())
        flops = 2.0 * 9 * taps * cin * cout * frames * hh * ww
        bms, by = bound(flops, nbytes(x, w, b) + nbytes(out),
                        PEAK_BF16_FLOPS)
        emit({"shape": [taps, frames, hh, ww, cin, cout],
              "plan": _plan(taps, x, cin, cout), "max_rel_err": err,
              "turns_ms": in_turns({"kernel": kernel, "cudnn": cudnn}, 5),
              "bound_ms": bms, "bound_by": by})
        del x, w, b, out, ref
        torch.cuda.empty_cache()


def run_variant(emit, name, path):
    """One patched library in place of the package's, alone in this
    process: the call's time at each shape."""
    _build._LIBS["conv3d"] = ctypes.CDLL(path)
    for taps, frames, hh, ww, cin, cout in SHAPES:
        x, w, b = _inputs(taps, frames, hh, ww, cin, cout)
        emit({"variant": name, "shape": [taps, frames, hh, ww, cin, cout],
              "call_ms": cuda_ms(_calls(taps, x, w, b)[0], 5)})
        del x, w, b
        torch.cuda.empty_cache()


def variants(emit, out):
    """Build every patched copy (all compilers started together) and time
    each in a process of its own."""
    root = _build.BUILD_DIR.parent / "probe_conv"
    started = {}
    for name, patches in VARIANTS.items():
        csrc = root / name
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        source = csrc / "conv3d.cu"
        text = source.read_text().replace("namespace {", _NOOP, 1)
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        source.write_text(text)
        so = str(root / f"{name}.so")
        started[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        cmd = [sys.executable, "-m", "tools.probe_conv", "--run-variant",
               name, so]
        if out:
            cmd += ["--out", out]
        subprocess.run(cmd, check=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--run-variant", nargs=2, default=None,
                    metavar=("NAME", "LIBRARY"), help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_conv: no CUDA device")

    def emit(obj):
        line = json.dumps({**obj, "device": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.run_variant:
        run_variant(emit, *args.run_variant)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi})
    _build.build(["conv3d"])
    measure(emit)
    if args.variants:
        variants(emit, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
