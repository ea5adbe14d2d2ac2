"""Multi-rank dry run of the product pipelines on tiny shapes (counterpart
of ``worldforge_tpu/parallel/dryrun.py``).

``run_dryrun(n, device)`` starts ``n`` processes (``device="cuda"``: NCCL,
one card a rank; ``"cpu"``: gloo) and runs each phase through the user's
entry points on a mesh, checking that the output is finite and the same on
every rank:

  1. longcat_refine_bsa -- ``LongCatPipeline.generate_refine`` with BSA:
     the block-sparse ring CP on sp, FSDP-sharded DiT;
  2. longcat_vc -- ``generate_vc``: the sequence-sharded cond cache, FSDP;
  3. avatar -- ``AvatarPipeline.generate_i2v_audio`` on the mesh (3
     tokens a frame: the sp cut is padded);
  4. wan_cp2d -- ``wan_dit_forward`` on a (1, n/4, 2, 2) mesh (sp_h x
     sp_w) and a solver update, CFG-style;
  5. wan_guided -- the unfused guided ``WanI2VPipeline.generate`` (CFG,
     IRR, the VAE fuse, DSG, FLF) on (dp, fsdp, sp), one sample a dp rank;
  6. at n % 8 == 0, the same on (2, 2, n/4) and one ``make_train_step``
     step there (FSDP params and optimizer state, dp batch, sp tokens).

The JAX dry run's fused and chunked-runner phases wait for the runtime
slice of the port. The VAE weights stay whole on every rank (the JAX dry
run FSDP-shards them too).

From a shell: ``python -m worldforge_tpu_torch.parallel.dryrun --n 4
--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _pick_mesh_dims(n: int) -> Tuple[int, int, int]:
    """(dp, fsdp, sp): sp the largest of 4 and 2 that divides n, then fsdp
    2 if it divides the rest, dp the rest (JAX's factoring)."""
    sp = next((c for c in (4, 2) if n % c == 0), 1)
    rem = n // sp
    fsdp = 2 if rem % 2 == 0 else 1
    return rem // fsdp, fsdp, sp


def _same_everywhere(name: str, out) -> tuple:
    """Fails unless ``out`` is finite and equal on every rank."""
    t = torch.as_tensor(np.asarray(out) if not isinstance(out, torch.Tensor)
                        else out.detach()).float()
    if not torch.isfinite(t).all():
        raise RuntimeError(f"dryrun {name}: non-finite output")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    ref = t.to(dev).clone()
    dist.broadcast(ref, 0)
    if not torch.equal(ref, t.to(dev)):
        raise RuntimeError(f"dryrun {name}: ranks disagree")
    return tuple(t.shape)


def _tiny_wan(dev, seed, model_type="i2v"):
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     init_wan_dit)
    from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
    vae_cfg = WanVAEConfig.tiny()
    in_dim = 4 + 2 * vae_cfg.z_dim if model_type == "i2v" else vae_cfg.z_dim
    cfg = WanDiTConfig(model_type=model_type, in_dim=in_dim,
                       out_dim=vae_cfg.z_dim, dim=64, ffn_dim=128,
                       num_heads=4, num_layers=2, text_len=16, text_dim=32,
                       freq_dim=16, clip_dim=64)
    gen = P.make_generator(seed, dev)
    params = init_wan_dit(gen, cfg, dtype=torch.float32 if model_type ==
                          "t2v" else torch.bfloat16)
    head = params["head"]["head"]
    head["w"] = (0.02 * P.normal(gen, tuple(head["w"].shape))).to(
        head["w"].dtype)
    return cfg, params, vae_cfg, init_wan_vae(gen, vae_cfg)


def _wan_guided(mesh, dev, name):
    from worldforge_tpu_torch.core.mesh import AXIS_DP
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
    cfg, params, vae_cfg, vae = _tiny_wan(dev, 0)
    pipe = WanI2VPipeline(dit_params=shard_params_fsdp(params, mesh),
                          dit_cfg=cfg, vae_params=vae, vae_cfg=vae_cfg,
                          mesh=mesh)
    b, hpx, nf = mesh.shape[AXIS_DP], 64, 9
    gen = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s: torch.rand(s, generator=gen, device=dev)
    n = lambda *s: torch.randn(s, generator=gen, device=dev)
    out = pipe.generate(
        torch.Generator(device=dev).manual_seed(7), r(b, 3, hpx, hpx) * 2 - 1,
        n(b, cfg.text_len, cfg.text_dim), n(b, cfg.text_len, cfg.text_dim),
        n(b, 257, cfg.clip_dim), height=hpx, width=hpx, num_frames=nf,
        num_inference_steps=4, guidance_scale=4.0,
        video_ref=r(b, 3, nf, hpx, hpx),
        mask=torch.ones((b, 1, nf, hpx, hpx), device=dev),
        guidance=GuidanceConfig(guided=True, guide_steps=2, resample_steps=2,
                                resample_round=2, use_flf=True),
        output_type="latent")
    return _same_everywhere(name, out)


def _wan_cp2d(n, dev):
    from worldforge_tpu_torch.models.wan.dit import wan_dit_forward
    from worldforge_tpu_torch.parallel.cp2d import make_mesh_2d
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.sampling.unipc import (flow_pred_x0,
                                                     make_flow_unipc_schedule,
                                                     unip_update)
    mesh = make_mesh_2d(1, n // 4, 2, 2, device=dev.type)
    cfg, params, vae_cfg, _ = _tiny_wan(dev, 1)
    params = shard_params_fsdp(params, mesh)
    gen = torch.Generator(device=dev).manual_seed(12)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    x, cond = r(1, vae_cfg.z_dim, 3, 8, 8), r(1, 4 + vae_cfg.z_dim, 3, 8, 8)
    ctx, clip = r(1, cfg.text_len, cfg.text_dim), r(1, 257, cfg.clip_dim)
    sched = make_flow_unipc_schedule(4)
    t = torch.full((1,), float(sched.timesteps[0]), device=dev)
    with torch.inference_mode():
        v_c = wan_dit_forward(params, cfg, x, t, ctx, clip_fea=clip, y=cond,
                              mesh=mesh)
        v_u = wan_dit_forward(params, cfg, x, t, ctx * 0.9, clip_fea=clip,
                              y=cond, mesh=mesh)
        v = v_c + 4.0 * (v_c - v_u)
        out = unip_update(sched, 0, 1, x, flow_pred_x0(sched, 0, v, x))
    return _same_everywhere("wan_cp2d", out)


def _longcat_pipe(mesh, dev, seed, **cfg_kw):
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                         init_longcat_dit)
    from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.pipelines.longcat import LongCatPipeline
    vae_cfg = WanVAEConfig.tiny()
    cfg = dataclasses.replace(LongCatDiTConfig.tiny(),
                              in_channels=vae_cfg.z_dim,
                              out_channels=vae_cfg.z_dim, **cfg_kw)
    gen = P.make_generator(seed, dev)
    return LongCatPipeline(
        dit_params=shard_params_fsdp(init_longcat_dit(gen, cfg), mesh),
        dit_cfg=cfg, vae_params=init_wan_vae(gen, vae_cfg), vae_cfg=vae_cfg,
        mesh=mesh, vc_cache_dtype="bfloat16")


def _longcat_refine_bsa(mesh, dev):
    pipe = _longcat_pipe(mesh, dev, 8)
    # 32 stage-1 frames -> 64 after the 2x temporal upscale -> 16 latent
    # frames; 64 x 128 px -> a (16, 4, 8) token grid = 4 BSA chunks
    stage1 = np.random.default_rng(0).uniform(
        0, 1, (32, 32, 64, 3)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(10)
    pe = torch.randn((1, 6, pipe.dit_cfg.caption_channels), generator=gen,
                     device=dev)
    out = pipe.generate_refine(
        torch.Generator(device=dev).manual_seed(11), stage1, pe, None,
        height=64, width=128, num_inference_steps=4, t_thresh=0.5,
        use_bsa=True, bsa_sparsity=0.5, output_type="latent")
    return _same_everywhere("longcat_refine_bsa", out)


def _longcat_vc(mesh, dev):
    pipe = _longcat_pipe(mesh, dev, 40, num_heads=4)
    gen = torch.Generator(device=dev).manual_seed(42)
    video = torch.rand((1, 3, 5, 32, 32), generator=gen, device=dev) * 2 - 1
    pe = torch.randn((1, 6, pipe.dit_cfg.caption_channels), generator=gen,
                     device=dev)
    out = pipe.generate_vc(
        torch.Generator(device=dev).manual_seed(44), video, pe,
        torch.ones((1, 6), dtype=torch.int32, device=dev), height=32,
        width=32, num_frames=13, num_cond_frames=5, num_inference_steps=3,
        enhance_hf=False, output_type="latent")
    return _same_everywhere("longcat_vc", out)


def _avatar(mesh, dev):
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.longcat.avatar import (AvatarConfig,
                                                            init_avatar_dit)
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig,
                                                     init_wan_vae)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.pipelines.avatar import AvatarPipeline
    vae_cfg = WanVAEConfig.tiny()
    base = LongCatDiTConfig(in_channels=vae_cfg.z_dim,
                            out_channels=vae_cfg.z_dim, hidden_size=64,
                            depth=2, num_heads=4, caption_channels=32,
                            adaln_tembed_dim=32, frequency_embedding_size=16)
    cfg = AvatarConfig(base=base, audio_blocks=2, audio_channels=8,
                       intermediate_dim=16, output_dim=8, context_tokens=4)
    gen = P.make_generator(50, dev)
    pipe = AvatarPipeline(
        dit_params=shard_params_fsdp(init_avatar_dit(gen, cfg), mesh),
        dit_cfg=cfg, vae_params=init_wan_vae(gen, vae_cfg), vae_cfg=vae_cfg,
        mesh=mesh)
    nf, hpx = 9, 16
    g = torch.Generator(device=dev).manual_seed(52)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    out = pipe.generate_i2v_audio(
        torch.Generator(device=dev).manual_seed(56),
        torch.rand((1, 3, hpx, hpx), generator=g, device=dev) * 2 - 1,
        r(1, nf, cfg.audio_window, cfg.audio_blocks, cfg.audio_channels),
        r(1, 6, 32), None, r(1, 6, 32), None, height=hpx, width=hpx,
        num_frames=nf, num_inference_steps=2, guidance_scale=3.0)
    return _same_everywhere("avatar", out)


def _train_step(mesh, dev):
    from worldforge_tpu_torch.core.mesh import AXIS_DP
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.training.step import (make_train_step,
                                                    trainable_leaves)
    cfg, params, _, _ = _tiny_wan(dev, 20, model_type="t2v")
    params = shard_params_fsdp(params, mesh)
    opt = torch.optim.AdamW(trainable_leaves(params), lr=1e-4,
                            weight_decay=1e-4)
    dp = mesh.shape[AXIS_DP]
    gen = torch.Generator(device=dev).manual_seed(21)
    batch = {"x0": torch.randn((dp, 4, 3, 8, 8), generator=gen, device=dev),
             "context": torch.randn((dp, cfg.text_len, cfg.text_dim),
                                    generator=gen, device=dev)}
    loss = make_train_step(cfg, opt, mesh=mesh)(
        params, batch, torch.Generator(device=dev).manual_seed(23))
    return _same_everywhere("train_step", loss)


def _phases(n: int, dev: torch.device) -> List[Tuple[str, tuple, float]]:
    from worldforge_tpu_torch.core.mesh import make_mesh
    dp, fsdp, sp = _pick_mesh_dims(n)
    mesh = make_mesh(dp, fsdp, sp, device=dev.type)
    done = []

    def run(name, fn, *args):
        t0 = time.time()
        shape = fn(*args)
        done.append((name, shape, time.time() - t0))

    run("longcat_refine_bsa", _longcat_refine_bsa, mesh, dev)
    run("longcat_vc", _longcat_vc, mesh, dev)
    run("avatar", _avatar, mesh, dev)
    if n % 4 == 0:
        run("wan_cp2d", _wan_cp2d, n, dev)
    run("wan_guided", _wan_guided, mesh, dev, "wan_guided")
    if n % 8 == 0:
        mesh222 = make_mesh(2, 2, n // 4, device=dev.type)
        run("wan_guided_dp2", _wan_guided, mesh222, dev, "wan_guided_dp2")
        run("train_step", _train_step, mesh222, dev)
    return done


def _rank_main(rank: int, n: int, device: str, port: int, out_dir: str):
    from worldforge_tpu_torch.core.mesh import init_process_group
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    dev = init_process_group(device, rank=rank, world_size=n,
                             init_method=f"tcp://127.0.0.1:{port}")
    try:
        done = _phases(n, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "phases.json"), "w") as f:
            json.dump([{"phase": p, "out": list(s), "s": t}
                       for p, s, t in done], f)


def run_dryrun(n: int, device: str = "cuda") -> List[str]:
    """Run the phases in ``n`` processes on ``device`` ("cuda": NCCL, one
    card a rank, ``n`` at most the cards there are; "cpu": gloo); prints
    each phase's line and returns the phases run. Any failed phase raises
    here."""
    import torch.multiprocessing as mp
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"run_dryrun({n}, 'cuda'): "
                           f"{torch.cuda.device_count()} cards")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dims = _pick_mesh_dims(n)
    print(f"dryrun mesh: dp={dims[0]} fsdp={dims[1]} sp={dims[2]} on "
          f"{n} x {device}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(n, device, port, d), nprocs=n,
                           join=True, start_method="spawn")
        with open(os.path.join(d, "phases.json")) as f:
            done = json.load(f)
    for rec in done:
        print(f"  {rec['phase']}: ok, out {tuple(rec['out'])}, "
              f"{rec['s']:.1f} s", flush=True)
    return [rec["phase"] for rec in done]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run_dryrun(args.n, args.device)
    print(f"dryrun({args.n}, {args.device}): ok", flush=True)


if __name__ == "__main__":
    main()
