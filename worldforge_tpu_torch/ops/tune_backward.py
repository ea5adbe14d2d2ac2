"""The launch choices of the backward kernels beside their neighbours, on the
card: kernel 1's query split (``flash_attention._bwd_plan``) at the DiTs'
cross-attentions that train, and kernel 3's (warps, programs per SM)
(``fused_norm._bwd_launch``) at the DiT widths. Every candidate runs
on the same inputs, in rounds whose order alternates, and is held against a
reference so that a fast but wrong launch shows: kernel 1's split plans
against the unsplit plan (dk and dv to fp32 summation order, each plan's
dk and dv bit-equal run to run), kernel 3's launches against autograd of
``modulated_layer_norm_ref`` (relative L2). Run it on a CUDA machine:

    python -m worldforge_tpu_torch.ops.tune_backward [--out FILE]

It prints one JSON object, and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

WAN_TOKENS = 20280        # Wan2.1-14B 480p, 49 frames: 13 x 30 x 52
WAN_1_3B_TOKENS = 32760   # Wan2.1-1.3B 480p, 81 frames: 21 x 30 x 52
# (queries, keys, heads) of the DiTs' cross-attentions that train: Wan-14B
# text and CLIP, Wan-1.3B text, LongCat-13.6B text
K1_SHAPES = ((WAN_TOKENS, 512, 40), (WAN_TOKENS, 257, 40),
             (WAN_1_3B_TOKENS, 512, 12), (WAN_TOKENS, 512, 32))
ROUNDS, ITERS = 3, 10     # rounds of every candidate; calls timed a round
K3_LAUNCHES = ((16, 1), (16, 2), (16, 4), (8, 1), (8, 2), (8, 4), (8, 8),
               (4, 2), (4, 4))


def _ms(fn, iters):
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


def _rounds(cands, time_one, rounds):
    """{candidate: [ms per round]}, the candidates' order reversed every
    other round."""
    out = {c: [] for c in cands}
    for r in range(rounds):
        for c in (cands if r % 2 == 0 else cands[::-1]):
            out[c].append(time_one(c))
    return out


def _summary(times, chosen):
    rows = {str(c): {"ms": t, "median_ms": sorted(t)[len(t) // 2]}
            for c, t in times.items()}
    best = min(times, key=lambda c: sorted(times[c])[len(times[c]) // 2])
    return {"candidates": rows, "chosen": str(chosen), "fastest": str(best)}


def sweep_flash_bwd(gen, rounds, iters, max_splits=12):
    from worldforge_tpu_torch.ops import flash_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = 128
    scale = 1.0 / math.sqrt(d)
    mk = lambda sh: torch.randn(sh, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {}
    for s, sk, h in K1_SHAPES:
        q, do = mk((1, s, h, d)), mk((1, s, h, d))
        k, v = mk((1, sk, h, d)), mk((1, sk, h, d))
        kl = torch.full((1,), sk, dtype=torch.int32, device="cuda")
        o, m, l = fa._launch(q, k, v, kl, scale, True)
        chosen = fa._bwd_plan(1, s, sk, h, d, sms)
        q_tiles = -(-s // chosen.q_tile)
        plans = {}
        for want in range(1, max_splits + 1):
            per = -(-q_tiles // want)
            plans[want] = fa.BwdPlan(chosen.key_tile, chosen.q_tile,
                                     -(-q_tiles // per), per)
        run = lambda n: fa._launch_backward(q, k, v, o, do, m, l, kl,
                                            scale, plans[n])
        base = run(1)
        checks = {}
        for n in plans:
            a, b2 = run(n), run(n)
            blocks = -(-sk // chosen.key_tile) * h * plans[n].splits
            checks[n] = {
                "splits": plans[n].splits, "blocks": blocks,
                "waves_per_walk": -(-blocks // sms) / plans[n].splits,
                "dk_dv_bit_equal_run_to_run": bool(
                    torch.equal(a[1], b2[1]) and torch.equal(a[2], b2[2])),
                "dk_dv_max_abs_vs_unsplit": max(
                    float((a[i].float() - base[i].float()).abs().max())
                    for i in (1, 2)),
                "dq_max_abs_vs_unsplit": float(
                    (a[0].float() - base[0].float()).abs().max())}
            del a, b2
        times = _rounds(list(plans), lambda n: _ms(lambda: run(n), iters),
                        rounds)
        res = _summary(times, chosen.splits)
        for n, c in checks.items():
            res["candidates"][str(n)].update(c)
        res["ok"] = all(c["dk_dv_bit_equal_run_to_run"] for c in
                        checks.values())
        out[f"[1,{s}->{sk},{h},{d}]"] = res
        del q, k, v, do, o, m, l, base
    return out


def sweep_mod_ln_bwd(gen, rounds, iters):
    from worldforge_tpu_torch.ops import fused_norm as fn
    out = {}
    for s, d in ((WAN_TOKENS, 5120), (WAN_TOKENS, 4096),
                 (WAN_1_3B_TOKENS, 1536)):
        x = torch.randn((1, s, d), generator=gen, device="cuda") * 3.0 + 0.5
        sc = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
        sh = torch.randn((1, 1, d), generator=gen, device="cuda") * 0.1
        dy = torch.randn((1, s, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        plain = [t.clone().requires_grad_(True) for t in (x, sc, sh)]
        fn.modulated_layer_norm_ref(*plain).backward(dy)
        refs = [t.grad for t in plain]
        del plain
        run = lambda c: fn._launch_backward(x, sc, dy, 1e-6, *c)
        rels = {}
        for c in K3_LAUNCHES:
            got = run(c)
            rels[c] = max(float((g.float() - r.float()).norm()
                                / r.float().norm()) for g, r in zip(got, refs))
            del got
        times = _rounds(list(K3_LAUNCHES), lambda c: _ms(lambda: run(c),
                                                         iters), rounds)
        res = _summary(times, fn._bwd_launch(d))
        for c, r in rels.items():
            res["candidates"][str(c)]["max_rel_l2_err"] = r
        res["ok"] = max(rels.values()) <= 1e-5
        out[f"[1,{s},{d}]"] = res
        del x, dy, refs
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_backward: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"device": torch.cuda.get_device_name(0),
           "card": card.strip().splitlines()[:1],
           "rounds": ROUNDS, "iters": ITERS,
           "flash_attention_backward_splits": sweep_flash_bwd(
               gen, ROUNDS, ITERS),
           "modulated_layer_norm_backward_launch": sweep_mod_ln_bwd(
               gen, ROUNDS, 2 * ITERS)}
    res["ok"] = all(r["ok"] for part in (
        "flash_attention_backward_splits",
        "modulated_layer_norm_backward_launch") for r in res[part].values())
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
