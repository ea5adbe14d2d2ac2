"""The rank side of the parallel layer's CPU tests.

``run_spawn(world, checks)`` starts ``world`` processes (spawn), joins
them into one gloo group and runs every check on every rank; a check is
``(name, function name, inputs)`` and returns this rank's results as numpy
(with the batch rows and token indices the rank held, so the test can cut
the same rows from the global reference). The module imports torch and the
port only: the JAX references run in the test process.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from worldforge_tpu_torch.core.dtypes import FP32_POLICY
from worldforge_tpu_torch.core.mesh import (AXIS_SP, TokenSplit,
                                            init_process_group, make_mesh,
                                            split_batch)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, checks, out_dir):
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"tcp://127.0.0.1:{port}")
    results = {}
    try:
        for name, fn, inputs in checks:
            results[name] = globals()[fn](inputs)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_spawn(world: int, checks, timeout: float = 600.0):
    """Every check on ``world`` gloo ranks; returns one results dict per
    rank. Fails if a rank raises or the run outlasts ``timeout``."""
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_entry, args=(world, _free_port(), checks,
                                               d), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.time() + timeout
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"run_spawn({world}) outlasted "
                                   f"{timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


class _Counted:
    """Counts the collectives called inside the block (to show that a
    mesh run took its exchanges)."""
    NAMES = {"all_to_all_single": "all_to_all",
             "all_gather_into_tensor": "all_gather",
             "reduce_scatter_tensor": "reduce_scatter",
             "batch_isend_irecv": "p2p", "all_reduce": "all_reduce"}

    def __enter__(self):
        self.counts = {v: 0 for v in self.NAMES.values()}
        self._orig = {}
        for fn, key in self.NAMES.items():
            orig = self._orig[fn] = getattr(dist, fn)

            def wrapped(*a, _o=orig, _k=key, **kw):
                self.counts[_k] += 1
                return _o(*a, **kw)
            setattr(dist, fn, wrapped)
        return self.counts

    def __exit__(self, *exc):
        for fn, orig in self._orig.items():
            setattr(dist, fn, orig)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t


def _rows(mesh, batch, split):
    """What a rank holds: (first batch row, batch rows, token index,
    real rows)."""
    from worldforge_tpu_torch.core.mesh import AXIS_DP, dp_split_ok
    nb = batch
    b0 = 0
    if dp_split_ok(mesh, batch):
        nb = batch // mesh.shape[AXIS_DP]
        b0 = mesh.coord(AXIS_DP) * nb
    return {"b0": b0, "nb": nb, "index": split.index.numpy(),
            "n_real": split.n_real}


# ------------------------------------------------------------ modules


def ulysses(inp):
    from worldforge_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = make_mesh(*inp["mesh"], device="cpu")
    q, k, v = (_t(inp[n]) for n in "qkv")
    b, s = q.shape[:2]
    split = TokenSplit(s, mesh, (AXIS_SP,))
    loc = lambda x: split.split(split_batch(x, mesh, b))
    kv = split_batch(_t(inp.get("kv_lens")), mesh, b)
    out = ulysses_attention(loc(q), loc(k), loc(v), mesh=mesh, kv_lens=kv,
                            split=split)
    return {"out": _np(out), **_rows(mesh, b, split)}


def cross(inp):
    from worldforge_tpu_torch.parallel.ulysses import (
        sequence_local_cross_attention)
    mesh = make_mesh(*inp["mesh"], device="cpu")
    q, k, v = (_t(inp[n]) for n in "qkv")
    split = TokenSplit(q.shape[1], mesh, (AXIS_SP,))
    out = sequence_local_cross_attention(split.split(q), k, v, mesh=mesh)
    return {"out": _np(out), **_rows(mesh, q.shape[0], split)}


def ring(inp):
    from worldforge_tpu_torch.parallel.ring import ring_attention
    mesh = make_mesh(*inp["mesh"], device="cpu")
    q, k, v = (_t(inp[n]) for n in "qkv")
    split = TokenSplit(q.shape[1], mesh, (AXIS_SP,))
    out = ring_attention(split.split(q), split.split(k), split.split(v),
                         mesh=mesh)
    res = {"out": _np(out), **_rows(mesh, q.shape[0], split)}
    q.requires_grad_(True)
    try:
        ring_attention(split.split(q), split.split(k), split.split(v),
                       mesh=mesh)
        res["grad_refused"] = False
    except RuntimeError:
        res["grad_refused"] = True
    return res


def merge(inp):
    from worldforge_tpu_torch.parallel.bsa_cp import _merge_flat
    from worldforge_tpu_torch.parallel.ring import _merge
    a = [_t(inp[n]) for n in ("o_a", "m_a", "l_a", "o_b", "m_b", "l_b")]
    out, m, l = _merge(*a)
    fa = [_t(inp[n]) for n in ("fo_a", "fm_a", "fl_a", "fo_b", "fm_b",
                               "fl_b")]
    fo, fm, fl = _merge_flat(*fa)
    return {"out": _np(out), "m": _np(m), "l": _np(l), "fo": _np(fo),
            "fm": _np(fm), "fl": _np(fl)}


def bsa_cp(inp):
    from worldforge_tpu_torch.parallel.bsa_cp import (block_order,
                                                      bsa_attention_3d_cp)
    mesh = make_mesh(*inp["mesh"], device="cpu")
    q, k, v = (_t(inp[n]) for n in "qkv")
    grid = tuple(inp["grid"])
    split = TokenSplit(q.shape[1], mesh, (AXIS_SP,),
                       order=block_order(grid, (4, 4, 8)))
    stats = {}
    out = bsa_attention_3d_cp(split.split(q), split.split(k), split.split(v),
                              mesh=mesh, sparsity=inp["sparsity"],
                              cdf_threshold=inp["cdf"], stats=stats)
    return {"out": _np(out), "empty_rows": stats["empty_rows"],
            **_rows(mesh, q.shape[0], split)}


def cp2d(inp):
    from worldforge_tpu_torch.ops.rope import rope_cos_sin
    from worldforge_tpu_torch.parallel import cp2d as C
    mesh = C.make_mesh_2d(1, 1, *inp["sp_hw"], device="cpu")
    q, k, v = (_t(inp[n]) for n in "qkv")
    kc, vc = _t(inp["kc"]), _t(inp["vc"])
    loc = lambda x: C.split_cp_2d(x, mesh)
    b, t, hh, ww = q.shape[:4]
    split = C.grid_split(mesh, (t, hh, ww))
    cos, sin = C.rope_rows_2d(mesh, (t, hh, ww), q.shape[-1])
    gcos, gsin = rope_cos_sin(t, hh, ww, q.shape[-1])
    return {
        "self": _np(C.ulysses_attention_2d(loc(q), loc(k), loc(v),
                                           mesh=mesh)),
        "cross": _np(C.cross_attention_2d(loc(q), kc, vc, mesh=mesh)),
        "roundtrip": bool(torch.equal(C.gather_cp_2d(loc(q[..., 0, :]),
                                                     mesh), q[..., 0, :])),
        "rope_rows_equal": bool(torch.equal(cos, gcos[split.index])
                                and torch.equal(sin, gsin[split.index])),
        "h0": mesh.coord(C.AXIS_SP_H) * (hh // mesh.shape[C.AXIS_SP_H]),
        "w0": mesh.coord(C.AXIS_SP_W) * (ww // mesh.shape[C.AXIS_SP_W]),
    }


def fsdp(inp):
    """The tiny Wan tree sharded on fsdp: each leaf's chunk and axis, the
    gathered tree, and the gather's gradient (reduce-scatter, averaged)."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    from worldforge_tpu_torch.parallel.sharding import (gather_params,
                                                        shard_params_fsdp)
    mesh = make_mesh(*inp["mesh"], device="cpu")
    full = dit_params_from_jax(inp["params"])
    sh = shard_params_fsdp(full, mesh)
    chunks, axes = [], []
    P.tree_map(lambda t: (chunks.append(_np(t)),
                          axes.append(getattr(t, "fsdp_axis", None))), sh)
    leaves = []
    P.tree_map(lambda t: leaves.append(t.requires_grad_(True)), sh)
    got = gather_params(sh, mesh)
    flat_full, flat_got = [], []
    P.tree_map(flat_full.append, full)
    P.tree_map(flat_got.append, got)
    gen = torch.Generator().manual_seed(5)
    weights = [torch.randn(t.shape, generator=gen) for t in flat_got]
    sum(((g * w).sum() for g, w in zip(flat_got, weights))).backward()
    want_grads = [_np(w.chunk(mesh.shape["fsdp"], dim=a)[
        mesh.coord("fsdp")] if a is not None else w)
        for w, a in zip(weights, axes)]
    return {"chunks": chunks, "axes": axes,
            "gathered_equal": all(torch.equal(a, b) for a, b in zip(
                flat_full, flat_got)),
            "grads": [_np(t.grad) for t in leaves], "want_grads": want_grads}


def exchanges(inp):
    """TokenSplit's exchanges with an order and pad rows: split + gather
    and to_heads + from_heads give x back; to_heads gives the global
    order; the gradients of gather (this rank's part) and to_heads."""
    mesh = make_mesh(*inp["mesh"], device="cpu")
    x = _t(inp["x"])
    order = _t(inp["order"])
    split = TokenSplit(x.shape[1], mesh, (AXIS_SP,), order=order)
    loc = split.split(x).requires_grad_(True)
    back = split.gather(loc)
    heads = split.to_heads(loc)
    r = mesh.coord(AXIS_SP)
    hl = x.shape[2] // split.size
    (back.sum() + (heads * heads).sum()).backward()
    want_grad = 1.0 + 2.0 * split.split(x)
    return {
        "gather": bool(torch.equal(back, x)),
        "heads": bool(torch.equal(heads, x[:, :, r * hl:(r + 1) * hl])),
        "roundtrip": bool(torch.equal(split.from_heads(heads)[:, :split.n_real],
                                      loc[:, :split.n_real])),
        # pad rows get no gradient from either exchange
        "grad": bool(torch.allclose(loc.grad[:, :split.n_real],
                                    want_grad[:, :split.n_real])
                     and not loc.grad[:, split.n_real:].any()),
    }


# ------------------------------------------------------------- models


def _mesh_of(inp):
    from worldforge_tpu_torch.parallel.cp2d import make_mesh_2d
    m = inp["mesh"]
    if len(m) == 4:
        return make_mesh_2d(*m, device="cpu")
    return make_mesh(*m, device="cpu")


def wan_forward(inp):
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     wan_dit_forward)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    mesh = _mesh_of(inp)
    cfg = WanDiTConfig(**inp["cfg"])
    params = dit_params_from_jax(inp["params"])
    a = {k: _t(inp[k]) for k in ("x", "t", "ctx", "clip", "y")}
    with _Counted() as counts:
        out = wan_dit_forward(shard_params_fsdp(params, mesh), cfg, a["x"],
                              a["t"], a["ctx"], clip_fea=a["clip"], y=a["y"],
                              policy=FP32_POLICY, mesh=mesh)
    res = {"out": _np(out), "counts": counts}
    if dist.get_rank() == 0:
        res["single"] = _np(wan_dit_forward(
            params, cfg, a["x"], a["t"], a["ctx"], clip_fea=a["clip"],
            y=a["y"], policy=FP32_POLICY))
    return res


def _lc_cfg(kw):
    from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig
    return LongCatDiTConfig(**kw)


def longcat_forward(inp):
    from worldforge_tpu_torch.io.from_jax import longcat_dit_params_from_jax
    from worldforge_tpu_torch.models.longcat.dit import longcat_dit_forward
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    mesh = _mesh_of(inp)
    cfg = _lc_cfg(inp["cfg"])
    params = longcat_dit_params_from_jax(inp["params"])
    a = {k: _t(inp[k]) for k in ("x", "t", "ctx", "mask")}
    kw = dict(encoder_attention_mask=a["mask"], policy=FP32_POLICY,
              num_cond_latents=inp["num_cond"], bsa_params=inp["bsa"])
    with _Counted() as counts:
        out = longcat_dit_forward(shard_params_fsdp(params, mesh), cfg,
                                  a["x"], a["t"], a["ctx"], mesh=mesh, **kw)
    res = {"out": _np(out), "counts": counts}
    if dist.get_rank() == 0:
        res["single"] = _np(longcat_dit_forward(params, cfg, a["x"], a["t"],
                                                a["ctx"], **kw))
    return res


def longcat_vc(inp):
    from worldforge_tpu_torch.io.from_jax import longcat_dit_params_from_jax
    from worldforge_tpu_torch.models.longcat.dit import (
        longcat_dit_cache_cond, longcat_dit_forward_with_cache)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    mesh = _mesh_of(inp)
    cfg = _lc_cfg(inp["cfg"])
    params = longcat_dit_params_from_jax(inp["params"])
    a = {k: _t(inp[k]) for k in ("cond", "x", "t", "ctx", "mask")}
    tc = (a["cond"].shape[2],)

    def run(p, m):
        kv = longcat_dit_cache_cond(p, cfg, a["cond"], policy=FP32_POLICY,
                                    mesh=m)
        out = longcat_dit_forward_with_cache(
            p, cfg, a["x"], a["t"], a["ctx"], kv, tc,
            encoder_attention_mask=a["mask"], policy=FP32_POLICY, mesh=m)
        return kv, out

    with _Counted() as counts:
        kv, out = run(shard_params_fsdp(params, mesh), mesh)
    res = {"out": _np(out), "cache_rows": kv[0].shape[2], "counts": counts}
    if dist.get_rank() == 0:
        res["single"] = _np(run(params, None)[1])
    return res


def avatar_forward(inp):
    from worldforge_tpu_torch.io.from_jax import avatar_params_from_jax
    from worldforge_tpu_torch.models.longcat.avatar import (
        AvatarConfig, avatar_dit_forward)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    mesh = _mesh_of(inp)
    cfg = AvatarConfig(base=_lc_cfg(inp["base"]), **inp["audio_kw"])
    params = avatar_params_from_jax(inp["params"])
    a = {k: _t(inp[k]) for k in ("x", "t", "ctx", "mask", "audio")}
    kw = dict(encoder_attention_mask=a["mask"], policy=FP32_POLICY,
              num_cond_latents=inp["num_cond"])
    with _Counted() as counts:
        out = avatar_dit_forward(shard_params_fsdp(params, mesh), cfg,
                                 a["x"], a["t"], a["ctx"], a["audio"],
                                 mesh=mesh, **kw)
    res = {"out": _np(out), "counts": counts}
    if dist.get_rank() == 0:
        res["single"] = _np(avatar_dit_forward(params, cfg, a["x"], a["t"],
                                               a["ctx"], a["audio"], **kw))
    return res


def _noise(seed):
    from worldforge_tpu_torch.utils.torch_rng import TorchCompatibleRNG
    rng = TorchCompatibleRNG(seed)
    return lambda shape: rng.randn(*shape)


def _replay(draws):
    """``noise_fn`` giving ``draws`` in order (JAX's key draws, made in the
    test process)."""
    it = iter(draws)
    return lambda shape: next(it)


def wan_generate(inp):
    """The guided generate through ``WanI2VPipeline(mesh=...)`` with fp32
    convs: unfused, fed the numpy noise stream both sides use; or, with
    ``inp["run"]`` (``fused`` / ``exec_chunk``) and ``inp["draws"]``, the
    fused runner fed JAX's draws in order."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.from_jax import (dit_params_from_jax,
                                                  tree_from_numpy)
    from worldforge_tpu_torch.models.wan import vae as tvae
    from worldforge_tpu_torch.models.wan.dit import WanDiTConfig
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    def fp32_conv3d(x, w, b=None, *, out_dtype=None):
        p = {"w": w} if b is None else {"w": w, "b": b}
        return P.conv(p, x, padding=(0, 1, 1))

    tvae.conv3d_causal = fp32_conv3d
    mesh = _mesh_of(inp)
    params = dit_params_from_jax(inp["params"])
    pipe = WanI2VPipeline(
        dit_params=params, dit_cfg=WanDiTConfig(**inp["cfg"]),
        vae_params=tree_from_numpy(inp["vae"]),
        vae_cfg=tvae.WanVAEConfig.tiny(), policy=FP32_POLICY)
    x = inp["inputs"]
    kw = dict(video_ref=x["ref"], mask=x["mask"],
              guidance=GuidanceConfig(**inp["guide"]), **inp["kw"],
              **inp.get("run", {}))
    noise = ((lambda: _replay(inp["draws"])) if "draws" in inp
             else (lambda: _noise(7)))
    on_mesh = dataclasses.replace(
        pipe, dit_params=shard_params_fsdp(params, mesh), mesh=mesh)
    chunks = []
    if kw.get("exec_chunk"):
        orig = on_mesh.run_fused_chunked

        def counting(*a, **k):
            k["on_chunk"] = lambda i, n, sf, si, lat: chunks.append(n)
            return orig(*a, **k)
        on_mesh.run_fused_chunked = counting
    with _Counted() as counts:
        out = on_mesh.generate(None, x["image"], x["pe"], x["ne"], x["ie"],
                               noise_fn=noise(), **kw)
    res = {"out": _np(out), "counts": counts, "chunks": list(chunks)}
    if dist.get_rank() == 0:
        res["single"] = _np(pipe.generate(None, x["image"], x["pe"], x["ne"],
                                          x["ie"], noise_fn=noise(), **kw))
    return res


def train_step(inp):
    """One AdamW step of ``make_train_step(mesh=...)`` on FSDP-sharded fp32
    params, fed JAX's sigma and noise; returns the loss, this rank's
    updated chunks (with their axes) and their gradients, and on rank 0
    the same of the mesh-free step."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    from worldforge_tpu_torch.models.wan.dit import (WanDiTConfig,
                                                     wan_dit_forward)
    from worldforge_tpu_torch.parallel.sharding import shard_params_fsdp
    from worldforge_tpu_torch.training.step import (make_train_step,
                                                    trainable_leaves)
    mesh = _mesh_of(inp)
    cfg = WanDiTConfig(**inp["cfg"])

    def fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
            remat=True):
        return wan_dit_forward(params, cfg, x, t, ctx, y=y,
                               clip_fea=clip_fea, policy=FP32_POLICY,
                               remat=remat, mesh=mesh)

    batch = {k: _t(v) for k, v in inp["batch"].items()}
    res = {}
    for name, m in (("mesh", mesh), ("single", None)):
        if m is None and dist.get_rank() != 0:
            continue
        params = dit_params_from_jax(inp["params"])
        if m is not None:
            params = shard_params_fsdp(params, m)
        opt = torch.optim.AdamW(trainable_leaves(params), lr=inp["lr"],
                                weight_decay=inp["wd"])
        step = make_train_step(cfg, opt, mesh=m, forward_fn=fwd)
        with _Counted() as counts:
            loss = step(params, batch, sigma=_t(inp["sigma"]),
                        noise=_t(inp["noise"]))
        leaves, axes, grads = [], [], []
        P.tree_map(lambda t: (leaves.append(_np(t)), grads.append(_np(t.grad)),
                              axes.append(getattr(t, "fsdp_axis", None))),
                   params)
        res[name] = {"loss": float(loss), "leaves": leaves, "axes": axes,
                     "grads": grads, "counts": counts}
    res["fsdp_coord"] = mesh.coord("fsdp")
    return res
