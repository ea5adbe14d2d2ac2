"""Where kernel 1's two-pass fp32 route (head dims 384 and 512,
``csrc/attention_f32_wide_sm90.cuh``) spends its time, on the card, at the
Wan2.1 VAE's mid attention [5, 6240, 1, 384] and the SVD VAE's [8, 6656, 1,
512]:

- the call against SDPA and, with ``--baseline-csrc DIR``, against another
  build of the fp32 entry point (the same C interface) from a ``csrc/``
  directory, called with this checkout's plan; in turns on the same inputs
  (A, B, B, A), each output's largest error against
  ``flash_attention_plain`` beside it;
- each pass's device time (``torch.profiler``);
- the call at other chunk sizes than the plan's, in turns;
- with ``--variants``, copies of the source that drop the TMA loads, the
  products, the splitters' work, or both of the latter, each built and
  timed in a process of its own (their outputs are garbage: timing only).

Run it on a CUDA machine from the repository root (it imports
``chip_smoke``'s timers):

    python -m tools.probe_flash_fp32 [--baseline-csrc DIR] [--variants] \\
        [--out FILE]

It prints one JSON object a line, and appends them to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

import torch

from chip_smoke import cuda_ms, in_turns, pass_ms
from worldforge_tpu_torch.ops import _build
from worldforge_tpu_torch.ops import flash_attention as fa

SHAPES = ((5, 6240, 384), (8, 6656, 512))     # (frames, tokens, head dim)
# (name, [(text, replacement)]) applied to a copy of the two-pass header;
# noop_ takes its arguments by value and does nothing
_NOOP = ("template <class... A> __device__ __forceinline__ void noop_(A...) "
         "{}\nnamespace sm90f32w {")
_NO_TMA = [("sm90::mbar_expect_tx(bar, 2 * kTile);", "sm90::mbar_arrive(bar);"),
           ("sm90::tma_load_4d(base + L::q(s)", "noop_(base + L::q(s)"),
           ("sm90::tma_load_4d(base + L::k_hi(s)", "noop_(base + L::k_hi(s)"),
           ("sm90::tma_load_2d(base + L::s_tile(s)",
            "noop_(base + L::s_tile(s)"),
           ("sm90::tma_load_4d(base + L::v_raw(s)",
            "noop_(base + L::v_raw(s)")]
_NO_MMA = [("sm90f32::wgmma_tf32_rs<kScoreKeys>(", "noop_("),
           ("sm90f32::wgmma_tf32_rs<kCols>(", "noop_(")]
_NO_SPLIT = [("sm90f32::split_rows<128>(", "noop_("),
             ("sm90f32::split_transpose_v<kCols, kKeys, false>(", "noop_(")]
VARIANTS = {"no_tma": _NO_TMA, "no_mma": _NO_MMA, "no_split": _NO_SPLIT,
            "loads_only": _NO_MMA + _NO_SPLIT}


def _bind(path):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wf_flash_attention_f32.argtypes = (
        [p] * 7 + [i] * 5 + [ctypes.c_float] + [i] * 2
        + [p, ctypes.c_longlong, p])
    lib.wf_flash_attention_f32.restype = i
    return lib


def _build_lib(csrc, out):
    """nvcc of ``csrc/flash_attention.cu`` into ``out``, started; returns
    the process."""
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(csrc, "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _call_two_pass(lib, q, k, v, plan, scratch):
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    err = lib.wf_flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None,
        None, b, sq, k.shape[1], h, d, 1.0 / math.sqrt(d), plan.variant,
        plan.chunk_tiles, scratch.data_ptr(), plan.scratch_bytes,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")
    return o


def _inputs(b, s, d):
    gen = torch.Generator(device="cuda").manual_seed(d)
    return [torch.randn((b, s, 1, d), generator=gen, device="cuda")
            for _ in range(3)]


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def measure(emit, baseline=None):
    """The call, SDPA and the baseline in turns; the passes; the chunks."""
    sms = fa._num_sms(torch.device("cuda"))
    for b, s, d in SHAPES:
        q, k, v = _inputs(b, s, d)
        ref = fa.flash_attention_plain(q, k, v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        calls = {"kernel": lambda: fa.flash_attention(q, k, v),
                 "sdpa": lambda: torch.nn.functional.
                 scaled_dot_product_attention(qt, kt, vt)}
        errors = {"kernel": _rel(calls["kernel"](), ref)}
        plan = fa._fwd_plan(b, s, s, 1, d, num_sms=sms)
        if baseline is not None:
            scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                                  device="cuda")
            calls = {"baseline": lambda: _call_two_pass(
                baseline, q, k, v, plan, scratch), **calls}
            errors["baseline"] = _rel(calls["baseline"](), ref)
        cap = fa._SCRATCH_CAP // fa._f32_layout(d, 0, s, 1).scratch_bytes
        chunks = {}
        for t in sorted({plan.chunk_tiles, plan.chunk_tiles // 2,
                         plan.chunk_tiles * 3 // 4, cap}):
            cut = fa._fwd_plan(b, s, s, 1, d, num_sms=sms, chunk_tiles=t)
            chunks[str(t)] = (lambda cut=cut: fa._launch(
                q, k, v, None, 1.0 / math.sqrt(d), False, plan=cut))
        emit({"shape": [b, s, 1, d], "plan": plan._asdict(),
              "max_rel_err": errors, "turns_ms": in_turns(calls, 3),
              "pass_device_ms": pass_ms(calls["kernel"]),
              "chunk_turns_ms": in_turns(chunks, 3),
              "bound_ms": 3 * 4.0 * b * s * s * d / 495e12 * 1e3})
        del q, k, v, ref
        torch.cuda.empty_cache()


def run_variant(emit, name, path):
    """One patched library, alone in this process: each pass's device time
    and the call's."""
    lib = _bind(path)
    sms = fa._num_sms(torch.device("cuda"))
    for b, s, d in SHAPES:
        q, k, v = _inputs(b, s, d)
        plan = fa._fwd_plan(b, s, s, 1, d, num_sms=sms)
        scratch = torch.zeros(plan.scratch_bytes, dtype=torch.uint8,
                              device="cuda")
        fn = lambda: _call_two_pass(lib, q, k, v, plan, scratch)  # noqa: E731
        emit({"variant": name, "shape": [b, s, 1, d],
              "pass_device_ms": pass_ms(fn), "call_ms": cuda_ms(fn, 3)})


def variants(emit, out):
    """Build every patched copy (all compilers started together) and time
    each in a process of its own."""
    root = _build.BUILD_DIR.parent / "probe_flash_fp32"
    started = {}
    for name, patches in VARIANTS.items():
        csrc = root / name
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        header = csrc / "attention_f32_wide_sm90.cuh"
        text = header.read_text().replace("namespace sm90f32w {", _NOOP, 1)
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        header.write_text(text)
        so = str(root / f"{name}.so")
        started[name] = (_build_lib(str(csrc), so), so)
    for name, (proc, so) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        cmd = [sys.executable, "-m", "tools.probe_flash_fp32",
               "--run-variant", name, so]
        if out:
            cmd += ["--out", out]
        subprocess.run(cmd, check=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--run-variant", nargs=2, default=None,
                    metavar=("NAME", "LIBRARY"), help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_fp32: no CUDA device")

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
    baseline = None
    if args.baseline_csrc:
        so = str(_build.BUILD_DIR.parent / "probe_flash_fp32_baseline.so")
        proc = _build_lib(args.baseline_csrc, so)
        _build.build(["flash_attention"])
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline failed to build:\n{log}")
        baseline = _bind(so)
    measure(emit, baseline)
    if args.variants:
        variants(emit, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
