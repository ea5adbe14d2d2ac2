"""The port's DiTs, the guided Wan generate and the train step under a mesh
against the JAX package's, on the CPU (gloo processes; the JAX side on the
8 virtual CPU devices).

Tiny configs (2 layers, width 64), JAX inits with every all-zero leaf
randomised (the heads would otherwise hide the blocks), carried over by
``io/from_jax.py``; fp32 policy. Every rank gets the global output; it is
held against JAX's forward under the same mesh at 1e-4 relative (the DiT
gate of ``docs/COMPONENTS.md``) and against the port's own mesh-free run:
  - Wan: Ulysses on sp (and with FSDP), the 2-D sp_h x sp_w split, and 27
    tokens that no sp divides (JAX's shard_map refuses them: held against
    JAX's unsharded forward; the port pads);
  - LongCat: Ulysses with a cond frame, the key all-gather when the heads
    do not divide over sp, BSA ring CP (sparsity 0.5), the vc cache pair
    (sequence-sharded cache; padded at world size 4);
  - the avatar (singletalk, a cond frame);
  - the unfused guided Wan generate (CFG, IRR, the VAE fuse with fp32
    convs, DSG, FLF over 8 steps) on (dp, fsdp, sp) = (2, 1, 2), a batch of
    2, at 1e-4 relative;
  - one AdamW step of ``make_train_step`` on (1, 2, 2): the loss within
    1e-5 and every updated FSDP chunk within 1e-4 relative L2 of JAX's,
    and each chunk's gradient against the mesh-free step's (1e-4 of the
    leaf's norm plus 1e-7 of the whole gradient's); the same step on
    (2, 1, 2) with a batch of 1 and on the 2-D (1, 1, 2, 2) mesh against
    the mesh-free step's loss, gradients and update.
``run_dryrun(4, "cpu")`` runs every phase it ports.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.torch_parallel_workers import run_spawn
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.core.mesh import make_mesh as jmake_mesh
from worldforge_tpu.models.longcat import avatar as javt
from worldforge_tpu.models.longcat import dit as jlc
from worldforge_tpu.models.wan import dit as jwan
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.parallel.cp2d import make_mesh_2d as jmake_mesh_2d
from worldforge_tpu.parallel.sharding import shard_params_fsdp
from worldforge_tpu.pipelines.wan_i2v import WanI2VPipeline as JPipe
from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
from worldforge_tpu.training import step as jstep

TOL = 1e-4
KEY = functools.partial(jax.random.key, impl="rbg")
WAN_KW = dict(model_type="i2v", in_dim=12, out_dim=4, dim=64, ffn_dim=128,
              num_heads=4, num_layers=2, text_len=8, text_dim=32,
              freq_dim=16, clip_dim=64)
LC_KW = dict(in_channels=4, out_channels=4, hidden_size=64, depth=2,
             num_heads=4, caption_channels=32, adaln_tembed_dim=32,
             frequency_embedding_size=16)
AUDIO_KW = dict(audio_blocks=2, audio_channels=8, intermediate_dim=16,
                output_dim=8, context_tokens=4)
GUIDE = dict(guided=True, guide_steps=8, resample_steps=2, resample_round=8,
             omega=4.0, use_flf=True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _randomize_zero_leaves(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, tree)


def _init(fn, cfg, seed):
    return _randomize_zero_leaves(jax.tree_util.tree_map(
        np.asarray, fn(KEY(seed), cfg, dtype=jnp.float32)), seed + 100)


def _jmesh(world, shape):
    devs = jax.devices()[:world]
    if len(shape) == 4:
        return jmake_mesh_2d(*shape, devices=devs)
    return jmake_mesh(*shape, devices=devs)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _text(rng, m=6, valid=4):
    mask = np.zeros((1, m), np.int32)
    mask[:, :valid] = 1
    return _f32(rng, 1, m, 32), mask


# ------------------------------------------------------------- inputs


def _wan_inputs(world):
    rng = np.random.default_rng(10 + world)
    cfg = jwan.WanDiTConfig(**WAN_KW)
    params = _init(jwan.init_wan_dit, cfg, 1)
    base = dict(cfg=WAN_KW, params=params, t=np.array([700.0], np.float32),
                ctx=_f32(rng, 1, 8, 32), clip=_f32(rng, 1, 257, 64))
    out = {}
    for name, shape, hw in (
            ("wan_sp", (1, 1, world), 8),
            ("wan_cp2d", (1, 1) + (((1, 2)) if world == 2 else (2, 2)), 8),
            ("wan_pad", (1, 1, world), 6)):
        out[name] = dict(base, x=_f32(rng, 1, 4, 3, hw, hw),
                         y=_f32(rng, 1, 8, 3, hw, hw), mesh=shape)
    out["wan_fsdp_sp"] = dict(out["wan_sp"], mesh=(1, 2, world // 2))
    return out


def _lc_inputs(world):
    rng = np.random.default_rng(20 + world)
    out = {}
    fb_heads = 2 if world == 4 else 1     # heads that sp does not divide
    for name, heads in (("lc_sp", 4), ("lc_fallback", fb_heads)):
        kw = dict(LC_KW, num_heads=heads)
        ctx, mask = _text(rng)
        out[name] = dict(cfg=kw, params=_init(jlc.init_longcat_dit,
                                              jlc.LongCatDiTConfig(**kw), 2),
                         x=_f32(rng, 1, 4, 3, 8, 8),
                         t=np.array([[0.0, 600.0, 600.0]], np.float32),
                         ctx=ctx, mask=mask, num_cond=1, bsa=None,
                         mesh=(1, 1, world))
    ctx, mask = _text(rng)
    out["lc_bsa"] = dict(out["lc_sp"], x=_f32(rng, 1, 4, 4, 16, 32),
                         t=np.full((1, 4), 500.0, np.float32), ctx=ctx,
                         mask=mask, num_cond=0, bsa={"sparsity": 0.5})
    # world 2: 16 cond and 32 noise tokens (JAX's Ulysses path); world 4:
    # 15 and 30, which the port pads (JAX runs them unsharded)
    hw = (4, 8) if world == 2 else (6, 10)
    ctx, mask = _text(rng)
    out["lc_vc"] = dict(cfg=LC_KW, params=out["lc_sp"]["params"],
                        cond=_f32(rng, 1, 4, 1, *hw),
                        x=_f32(rng, 1, 4, 2, *hw),
                        t=np.array([400.0], np.float32), ctx=ctx, mask=mask,
                        mesh=(1, 1, world))
    return out


def _avatar_inputs(world):
    rng = np.random.default_rng(30 + world)
    cfg = javt.AvatarConfig(base=jlc.LongCatDiTConfig(**LC_KW), **AUDIO_KW)
    ctx, mask = _text(rng)
    return {"avatar": dict(
        base=LC_KW, audio_kw=AUDIO_KW,
        params=_init(javt.init_avatar_dit, cfg, 3),
        x=_f32(rng, 1, 4, 3, 8, 8),
        t=np.array([[0.0, 500.0, 500.0]], np.float32), ctx=ctx, mask=mask,
        audio=_f32(rng, 1, 9, 5, 2, 8), num_cond=1, mesh=(1, 1, world))}


def _generate_inputs():
    rng = np.random.default_rng(40)
    f32 = lambda a: a.astype(np.float32)
    b, frames, hw = 2, 9, 64
    from worldforge_tpu_torch.models.wan import vae as tvae
    import torch
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    vae = jax.tree_util.tree_map(lambda t: t.numpy(), tvp)
    return {"generate": dict(
        cfg=WAN_KW, params=_init(jwan.init_wan_dit,
                                 jwan.WanDiTConfig(**WAN_KW), 4),
        vae=vae, guide=GUIDE, mesh=(2, 1, 2),
        kw=dict(height=hw, width=hw, num_frames=frames,
                num_inference_steps=8, guidance_scale=4.0,
                output_type="latent"),
        inputs=dict(
            image=f32(rng.uniform(-1, 1, (b, 3, hw, hw))),
            pe=f32(rng.standard_normal((b, 8, 32))),
            ne=f32(rng.standard_normal((b, 8, 32))),
            ie=f32(rng.standard_normal((b, 257, 64))),
            ref=f32(rng.uniform(0, 1, (b, 3, frames, hw, hw))),
            mask=f32(rng.uniform(0, 1, (b, 1, frames, hw, hw)) > 0.5)))}


TRAIN_KW = dict(WAN_KW, model_type="t2v", in_dim=4)
LR, WD = 1e-3, 1e-4


def _jax_draws(key, shape):
    k_sig, k_eps = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), jnp.float32, minval=1e-3,
                               maxval=1.0)
    return np.asarray(sigma), np.asarray(
        jax.random.normal(k_eps, shape, jnp.float32))


def _train_inputs():
    rng = np.random.default_rng(50)
    batch = {"x0": _f32(rng, 1, 4, 3, 8, 8), "context": _f32(rng, 1, 8, 32)}
    sigma, noise = _jax_draws(KEY(60), batch["x0"].shape)
    return {"train": dict(
        cfg=TRAIN_KW, params=_init(jwan.init_wan_dit,
                                   jwan.WanDiTConfig(**TRAIN_KW), 5),
        batch=batch, sigma=sigma, noise=noise, lr=LR, wd=WD,
        mesh=(1, 2, 2))}


# the train step on meshes whose axes the forward does not all cut: a batch
# of 1 that dp = 2 does not divide (run whole on each dp rank, tokens on
# sp = 2), and the 2-D split sp_h x sp_w = 2 x 2
TRAIN_MESHES = {"train_dp_uneven": (2, 1, 2), "train_cp2d": (1, 1, 2, 2)}


def _train_mesh_inputs(train):
    return {name: dict(train, mesh=m) for name, m in TRAIN_MESHES.items()}


FN = {"wan_sp": "wan_forward", "wan_cp2d": "wan_forward",
      "wan_pad": "wan_forward", "wan_fsdp_sp": "wan_forward",
      "lc_sp": "longcat_forward", "lc_fallback": "longcat_forward",
      "lc_bsa": "longcat_forward", "lc_vc": "longcat_vc",
      "avatar": "avatar_forward", "generate": "wan_generate",
      "train": "train_step", "train_dp_uneven": "train_step",
      "train_cp2d": "train_step"}


@pytest.fixture(scope="module")
def runs():
    """One spawn per world size, made when a test first asks for it; the
    world-4 spawn also runs the generate and the train step."""
    cache = {}

    def get(world):
        if world not in cache:
            inp = {**_wan_inputs(world), **_lc_inputs(world),
                   **_avatar_inputs(world)}
            if world == 4:
                inp.update(_generate_inputs())
                inp.update(_train_inputs())
                inp.update(_train_mesh_inputs(inp["train"]))
            cache[world] = (inp, run_spawn(
                world, [(n, FN[n], a) for n, a in inp.items()],
                timeout=900.0))
        return cache[world]
    return get


# the exchanges each run must take (counted on every rank)
EXCHANGES = {"wan_sp": "all_to_all", "wan_cp2d": "all_to_all",
             "wan_pad": "all_to_all", "wan_fsdp_sp": "all_gather",
             "lc_sp": "all_to_all", "lc_fallback": "all_gather",
             "lc_bsa": "p2p", "lc_vc": "all_to_all", "avatar": "all_to_all",
             "generate": "all_to_all"}


def _check(ranks, name, want, tol=TOL):
    for r in ranks:
        assert r[name]["counts"][EXCHANGES[name]] > 0, (name,
                                                        r[name]["counts"])
    outs = [r[name]["out"] for r in ranks]
    for o in outs:
        assert _rel(o, want) < tol, (name, _rel(o, want))
        np.testing.assert_array_equal(o, outs[0])   # every rank: one output
    assert _rel(outs[0], ranks[0][name]["single"]) < tol


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------- tests


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", ["wan_sp", "wan_cp2d", "wan_fsdp_sp"])
def test_wan_forward_matches_jax_mesh(runs, world, name):
    inp, ranks = runs(world)
    a = inp[name]
    mesh = _jmesh(world, a["mesh"])
    cfg = jwan.WanDiTConfig(**WAN_KW)
    params = shard_params_fsdp(jax.tree_util.tree_map(jnp.asarray,
                                                      a["params"]), mesh)
    with mesh:
        want = jax.jit(lambda p, x, y: jwan.wan_dit_forward(
            p, cfg, x, _j(a["t"]), _j(a["ctx"]), clip_fea=_j(a["clip"]),
            y=y, policy=J_FP32, mesh=mesh))(params, _j(a["x"]), _j(a["y"]))
    _check(ranks, name, np.asarray(want))


@pytest.mark.parametrize("world", (2, 4))
def test_wan_forward_pads_uneven_tokens(runs, world):
    """27 tokens (3 x 3 x 3): JAX's Ulysses shard_map refuses the cut, the
    port pads the last rank; held against JAX's unsharded forward."""
    inp, ranks = runs(world)
    a = inp["wan_pad"]
    want = jwan.wan_dit_forward(
        jax.tree_util.tree_map(jnp.asarray, a["params"]),
        jwan.WanDiTConfig(**WAN_KW), _j(a["x"]), _j(a["t"]), _j(a["ctx"]),
        clip_fea=_j(a["clip"]), y=_j(a["y"]), policy=J_FP32)
    _check(ranks, "wan_pad", np.asarray(want))


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", ["lc_sp", "lc_fallback", "lc_bsa"])
def test_longcat_forward_matches_jax_mesh(runs, world, name):
    inp, ranks = runs(world)
    a = inp[name]
    mesh = _jmesh(world, a["mesh"])
    cfg = jlc.LongCatDiTConfig(**a["cfg"])
    with mesh:
        want = jax.jit(lambda p, x: jlc.longcat_dit_forward(
            p, cfg, x, _j(a["t"]), _j(a["ctx"]),
            encoder_attention_mask=_j(a["mask"]),
            num_cond_latents=a["num_cond"], policy=J_FP32, mesh=mesh,
            bsa_params=a["bsa"]))(jax.tree_util.tree_map(
                jnp.asarray, a["params"]), _j(a["x"]))
    _check(ranks, name, np.asarray(want))


@pytest.mark.parametrize("world", (2, 4))
def test_longcat_vc_cache_matches_jax_mesh(runs, world):
    inp, ranks = runs(world)
    a = inp["lc_vc"]
    mesh = _jmesh(world, a["mesh"])
    cfg = jlc.LongCatDiTConfig(**a["cfg"])
    p = jax.tree_util.tree_map(jnp.asarray, a["params"])
    with mesh:
        kv = jax.jit(lambda p, c: jlc.longcat_dit_cache_cond(
            p, cfg, c, policy=J_FP32, mesh=mesh))(p, _j(a["cond"]))
        want = jax.jit(lambda p, x, kv: jlc.longcat_dit_forward_with_cache(
            p, cfg, x, _j(a["t"]), _j(a["ctx"]), kv,
            (a["cond"].shape[2],), encoder_attention_mask=_j(a["mask"]),
            policy=J_FP32, mesh=mesh))(p, _j(a["x"]), kv)
    _check(ranks, "lc_vc", np.asarray(want))
    # the cache is sequence-sharded: each rank keeps ceil(Sc / sp) rows
    sc = a["cond"].shape[3] * a["cond"].shape[4] // 4
    assert all(r["lc_vc"]["cache_rows"] == -(-sc // world) for r in ranks)


@pytest.mark.parametrize("world", (2, 4))
def test_avatar_forward_matches_jax_mesh(runs, world):
    inp, ranks = runs(world)
    a = inp["avatar"]
    mesh = _jmesh(world, a["mesh"])
    cfg = javt.AvatarConfig(base=jlc.LongCatDiTConfig(**LC_KW), **AUDIO_KW)
    with mesh:
        want = jax.jit(lambda p, x: javt.avatar_dit_forward(
            p, cfg, x, _j(a["t"]), _j(a["ctx"]), _j(a["audio"]),
            encoder_attention_mask=_j(a["mask"]),
            num_cond_latents=a["num_cond"], policy=J_FP32, mesh=mesh))(
                jax.tree_util.tree_map(jnp.asarray, a["params"]), _j(a["x"]))
    _check(ranks, "avatar", np.asarray(want))


def _noise(seed):
    from worldforge_tpu_torch.utils.torch_rng import TorchCompatibleRNG
    rng = TorchCompatibleRNG(seed)
    return lambda shape: rng.randn(*shape)


def test_guided_generate_matches_jax_mesh(runs):
    """(dp, fsdp, sp) = (2, 1, 2): each dp rank's DiT runs one sample, the
    tokens on sp; FLF's statistics are the global batch's on both sides
    (JAX's global view)."""
    world = 4
    inp, ranks = runs(world)
    a = inp["generate"]
    mesh = _jmesh(world, a["mesh"])
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    try:
        pipe = JPipe(dit_params=shard_params_fsdp(jax.tree_util.tree_map(
            jnp.asarray, a["params"]), mesh),
            dit_cfg=jwan.WanDiTConfig(**WAN_KW),
            vae_params=jax.tree_util.tree_map(jnp.asarray, a["vae"]),
            vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32, mesh=mesh)
        x = {k: jnp.asarray(v) for k, v in a["inputs"].items()}
        with mesh:
            want = np.asarray(pipe.generate(
                KEY(0), x["image"], x["pe"], x["ne"], x["ie"],
                video_ref=x["ref"], mask=x["mask"],
                guidance=JGuide(**a["guide"]), noise_fn=_noise(7),
                **a["kw"]))
    finally:
        jvae._CONV3D_MODE = old
    assert want.shape == (2, 4, 3, 8, 8)
    _check(ranks, "generate", want)


def test_train_step_matches_jax_mesh(runs):
    """One AdamW step on (dp, fsdp, sp) = (1, 2, 2) with FSDP-sharded fp32
    params and optimizer state, fed JAX's sigma and noise."""
    from worldforge_tpu_torch.core import params as TP
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    world = 4
    inp, ranks = runs(world)
    a = inp["train"]
    mesh = _jmesh(world, a["mesh"])
    cfg = jwan.WanDiTConfig(**TRAIN_KW)

    def fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
            remat=True):
        return jwan.wan_dit_forward(params, cfg, x, t, ctx, y=y,
                                    clip_fea=clip_fea, policy=J_FP32,
                                    remat=remat, mesh=mesh)

    opt = optax.adamw(LR, weight_decay=WD)
    params = shard_params_fsdp(jax.tree_util.tree_map(jnp.asarray,
                                                      a["params"]), mesh)
    with mesh:
        new, _, loss = jax.jit(jstep.make_train_step(
            cfg, opt, mesh=mesh, forward_fn=fwd))(
                params, opt.init(params),
                {k: jnp.asarray(v) for k, v in a["batch"].items()}, KEY(60))
    want = []
    TP.tree_map(want.append, dit_params_from_jax(
        jax.tree_util.tree_map(np.asarray, new)))
    for r in ranks:
        got = r["train"]
        assert abs(got["mesh"]["loss"] - float(loss)) <= 1e-5 * abs(
            float(loss))
        fc = got["fsdp_coord"]
        assert any(ax is not None for ax in got["mesh"]["axes"])
        for g, ax, w in zip(got["mesh"]["leaves"], got["mesh"]["axes"],
                            want):
            w = w.numpy()
            if ax is not None:
                w = np.split(w, 2, axis=ax)[fc]
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 1e-4, (err, g.shape)
    # the gather's backward reduce-scatters, the step all-reduces over sp
    assert all(r["train"]["mesh"]["counts"]["reduce_scatter"] > 0
               and r["train"]["mesh"]["counts"]["all_reduce"] > 0
               for r in ranks)
    _check_grads_single(ranks, "train")


def _check_grads_single(ranks, name):
    """The mesh step's loss and gradients against the mesh-free step's.
    The gradients themselves (AdamW's update hides their scale): each
    rank's chunk of each leaf's gradient, summed over the axes the forward
    cut after the fsdp reduce-scatter, within 1e-4 of the leaf's norm plus
    1e-7 of the whole gradient's."""
    single = ranks[0][name]["single"]
    total = np.sqrt(sum(np.linalg.norm(g) ** 2 for g in single["grads"]))
    for r in ranks:
        got = r[name]
        assert abs(single["loss"] - got["mesh"]["loss"]) <= (
            1e-6 * abs(single["loss"]))
        for g, ax, w in zip(got["mesh"]["grads"], got["mesh"]["axes"],
                            single["grads"]):
            if ax is not None:
                w = np.split(w, 2, axis=ax)[got["fsdp_coord"]]
            err = np.linalg.norm(g - w)
            assert err <= 1e-4 * np.linalg.norm(w) + 1e-7 * total, (
                err, g.shape)


@pytest.mark.parametrize("name", sorted(TRAIN_MESHES))
def test_train_step_mesh_grads_match_single(runs, name):
    """The step sums the gradients over the axes the forward cut and no
    other: on (2, 1, 2) with a batch of 1 (dp does not cut it, sp does) and
    on the 2-D (1, 1, 2, 2) mesh (sp_h x sp_w cut the tokens), the loss,
    the gradients and the updated parameters equal the mesh-free step's."""
    inp, ranks = runs(4)
    _check_grads_single(ranks, name)
    single = ranks[0][name]["single"]
    for r in ranks:
        got = r[name]["mesh"]
        assert got["counts"]["all_reduce"] > 0, got["counts"]
        assert all(ax is None for ax in got["axes"])
        for g, w in zip(got["leaves"], single["leaves"]):
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 1e-4, (err, g.shape)


def test_dryrun_cpu():
    """``run_dryrun(4, "cpu")``: every phase it ports, on 4 gloo ranks."""
    from worldforge_tpu_torch.parallel.dryrun import run_dryrun
    phases = run_dryrun(4, "cpu")
    assert set(phases) == {"longcat_refine_bsa", "longcat_vc", "avatar",
                           "wan_cp2d", "wan_guided_fused", "wan_chunked"}, \
        phases
