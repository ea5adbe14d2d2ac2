"""The port's LongCat guided i2v (IRR + FLF + DSG), t2v and video
continuation against the JAX package's, on the CPU.

The tiny configs of ``tests/test_torch_refine.py`` (LongCat tiny DiT with 4
latent channels, the tiny Wan VAE), the DiT weights made with the JAX init
and carried over by ``io/from_jax.py``, the VAE weights made with the
port's init and carried to JAX, the fp32 policy and fp32 3x3x3 convs on
both sides (the conv kernel's bf16 input rounding would flip on last-bit
differences, see ``test_torch_vae.py``). The port's ``noise_fn`` feeds both
the initial latents and the IRR re-noise; the JAX pipelines draw their
initial latents from the key and take only the re-noise from
``noise_fn``, so the port's stream starts with the JAX draw.

Tolerances: the stub-model loop 1e-6 relative (the same arithmetic);
generate_i2v / t2v / vc with the fp32 cache 1e-4 relative max of the
latents; the bf16 vc cache at the JAX package's own drift gate, 2e-2
(``tests/test_longcat_vc.py``). Selected FLF channel sets must be equal at
every guided step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.longcat.dit import LongCatDiTConfig as JCfg
from worldforge_tpu.models.longcat.dit import init_longcat_dit
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines import longcat as jlc
from worldforge_tpu.sampling import engine as jeng
from worldforge_tpu.sampling.flow_match import \
    make_flow_match_schedule as j_sched
from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import longcat_dit_params_from_jax
from worldforge_tpu_torch.models.longcat import dit as tdit
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.pipelines import longcat as tlc
from worldforge_tpu_torch.sampling import engine as teng
from worldforge_tpu_torch.sampling import guidance as tgd
from worldforge_tpu_torch.sampling.flow_match import \
    make_flow_match_schedule as t_sched
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig as TGuide
from worldforge_tpu_torch.utils.torch_rng import TorchCompatibleRNG

torch.set_num_threads(2)

TOL = 1e-4
CFG_KW = dict(JCfg.tiny().__dict__, in_channels=4, out_channels=4)
M = 6
HW, FRAMES = 64, 9                       # 3 x 8 x 8 latents, 48 tokens
GUIDE = dict(guided=True, guide_steps=4, resample_steps=2, resample_round=4,
             omega=1.8, omega_resample=1.0, use_flf=True)


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.fixture(scope="module")
def pipes():
    jdp = jax.tree_util.tree_map(np.asarray, init_longcat_dit(
        jax.random.key(0), JCfg(**CFG_KW), dtype=jnp.float32))
    # a non-zero output head, so the velocity is not the trivial zero field
    lin = jdp["final"]["linear"]
    lin["w"] = 0.05 * np.random.default_rng(9).standard_normal(
        lin["w"].shape).astype(np.float32)
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    jp = jlc.LongCatPipeline(
        dit_params=jax.tree_util.tree_map(jnp.asarray, jdp),
        dit_cfg=JCfg(**CFG_KW),
        vae_params=jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                          tvp),
        vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32)
    tp = tlc.LongCatPipeline(
        dit_params=longcat_dit_params_from_jax(jdp),
        dit_cfg=tdit.LongCatDiTConfig(**CFG_KW), vae_params=tvp,
        vae_cfg=tvae.WanVAEConfig.tiny(), policy=T_FP32)
    return jp, tp


@pytest.fixture
def fp32_convs(monkeypatch):
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    try:
        yield
    finally:
        jvae._CONV3D_MODE = old


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    pe = f32(rng.standard_normal((1, M, CFG_KW["caption_channels"])))
    ne = f32(rng.standard_normal((1, M, CFG_KW["caption_channels"])))
    pmask = np.zeros((1, M), np.int32)
    pmask[:, :4] = 1                      # kv_lens 4 of 6
    nmask = np.ones((1, M), np.int32)
    yy, xx = np.mgrid[0:HW, 0:HW].astype(np.float32)
    ref = np.stack([0.5 + 0.4 * np.sin((xx + 3 * i) / 7.0) * np.cos(yy / 5.0)
                    for i in range(FRAMES)])[None, None].repeat(3, axis=1)
    ref = f32(np.clip(ref + 0.05 * rng.standard_normal(ref.shape), 0, 1))
    mask = np.zeros((1, 1, FRAMES, HW, HW), np.float32)
    mask[..., : HW // 2] = 1.0
    image = f32(ref[:, :, 0] * 2.0 - 1.0)
    return dict(image=image, pe=pe, pmask=pmask, ne=ne, nmask=nmask,
                ref=ref, mask=mask)


def _jax_first(key_seed, then=None):
    """The port's noise stream: the draw the JAX pipeline makes from
    ``key(key_seed)`` first, then ``then``'s stream (the IRR re-noise)."""
    calls = []

    def draw(s):
        calls.append(s)
        if len(calls) == 1:
            _, k = jax.random.split(jax.random.key(key_seed))
            return np.asarray(jax.random.normal(k, s, jnp.float32))
        return then(s)
    return draw


def _torch_stream(seed):
    rng = TorchCompatibleRNG(seed)
    return lambda shape: rng.randn(*shape)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ the loop


@pytest.mark.parametrize("guided", [True, False])
def test_longcat_denoise_loop_stub_matches_jax(guided):
    """A stub model and fuse through both loops: the frame-0 handling, the
    fuse at r = 0 only, IRR from the fused x0, DSG on the sliced history."""
    shape = (1, 4, 3, 4, 4)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((4, 1, 1, 1)).astype(
        np.float32)
    g = dict(guided=True, guide_steps=3, resample_steps=3, resample_round=4,
             omega=2.5, omega_resample=1.2, use_flf=False)
    calls = {"jax": [], "torch": []}

    def stubs(xp, w, side):
        def model(lat, t, i, r):
            return xp.tanh(lat * w) * (t / 1000.0) - 0.1 * lat

        def fuse(x0, i, r):
            calls[side].append((i, r))
            return 0.5 * x0 + 0.25 * xp.sin(x0)
        return model, (fuse if guided else None)

    jm, jf = stubs(jnp, jnp.asarray(w), "jax")
    tm, tf = stubs(torch, torch.from_numpy(w), "torch")
    want = jeng.longcat_denoise_loop(jm, jnp.asarray(x), j_sched(5),
                                     JGuide(**g), noise_fn=_torch_stream(4),
                                     fuse_fn=jf)
    got = teng.longcat_denoise_loop(tm, torch.from_numpy(x), t_sched(5),
                                    TGuide(**g), noise_fn=_torch_stream(4),
                                    fuse_fn=tf)
    assert _rel(got, want) < 1e-6
    np.testing.assert_array_equal(got[:, :, :1].numpy(), x[:, :, :1])
    assert calls["torch"] == calls["jax"]
    assert calls["torch"] == ([(i, 0) for i in range(3)] if guided else [])


# ------------------------------------------------------- generate_i2v


def _record_selections(monkeypatch, module, sink):
    orig = module.flf_select

    def wrapped(pred, ref, step, cfg):
        sel = orig(pred, ref, step, cfg)
        sink.append((step, list(sel)))
        return sel
    monkeypatch.setattr(module, "flf_select", wrapped)


@pytest.mark.parametrize("use_distill", [True, False],
                         ids=["distill", "standard-cfg"])
def test_generate_i2v_guided_flf_matches_jax(pipes, fp32_convs, monkeypatch,
                                             use_distill):
    jp, tp = pipes
    x = _inputs()
    steps = 4 if use_distill else 5
    g = dict(GUIDE, guide_steps=steps, resample_round=steps)
    kw = dict(height=HW, width=HW, num_frames=FRAMES,
              num_inference_steps=steps, guidance_scale=4.0,
              use_distill=use_distill, output_type="latent")
    sel = {"jax": [], "torch": []}
    _record_selections(monkeypatch, jlc, sel["jax"])
    _record_selections(monkeypatch, tgd, sel["torch"])
    want = jp.generate_i2v(
        jax.random.key(3), jnp.asarray(x["image"]), jnp.asarray(x["pe"]),
        jnp.asarray(x["pmask"]), jnp.asarray(x["ne"]),
        jnp.asarray(x["nmask"]), video_ref=jnp.asarray(x["ref"]),
        mask=jnp.asarray(x["mask"]), guidance=JGuide(**g),
        noise_fn=_torch_stream(5), **kw)
    got = tp.generate_i2v(
        None, x["image"], x["pe"], x["pmask"], x["ne"], x["nmask"],
        video_ref=x["ref"], mask=x["mask"], guidance=TGuide(**g),
        noise_fn=_jax_first(3, _torch_stream(5)), **kw)
    assert got.shape == (1, 4, 3, 8, 8)
    assert _rel(got, want) < TOL
    assert sel["torch"] == sel["jax"]
    # FLF ran at r = 0 of every guided step and handed channels back from
    # step 2 on (the LongCat schedule's warm-up takes the worst channel)
    assert [s for s, _ in sel["torch"]] == list(range(steps))
    assert all(len(c) == 1 for s, c in sel["torch"] if s >= 2)


def test_generate_i2v_pixels_and_unguided(pipes, fp32_convs):
    """Pixels out in [0, 1]; without a reference there is no fuse, no IRR
    and no DSG, and the run matches JAX's."""
    jp, tp = pipes
    x = _inputs(1)
    kw = dict(height=HW, width=HW, num_frames=FRAMES, num_inference_steps=2,
              use_distill=True)
    want = jp.generate_i2v(jax.random.key(8), jnp.asarray(x["image"]),
                           jnp.asarray(x["pe"]), jnp.asarray(x["pmask"]),
                           None, None, **kw)
    got = tp.generate_i2v(None, x["image"], x["pe"], x["pmask"],
                          noise_fn=_jax_first(8), **kw)
    assert isinstance(got, np.ndarray) and got.shape == (1, 3, FRAMES, HW, HW)
    assert got.min() >= 0 and got.max() <= 1
    assert _rel(got, want) < TOL


def test_generate_i2v_runners_raise(pipes):
    _, tp = pipes
    x = _inputs()
    for kw in (dict(fused=True), dict(exec_chunk=2)):
        with pytest.raises(NotImplementedError, match="scan runners"):
            tp.generate_i2v(None, x["image"], x["pe"], x["pmask"],
                            height=HW, width=HW, num_frames=FRAMES,
                            num_inference_steps=1, **kw)


# ---------------------------------------------------------------- t2v


@pytest.mark.parametrize("use_distill", [True, False],
                         ids=["distill", "standard-cfg"])
def test_generate_t2v_matches_jax(pipes, fp32_convs, use_distill):
    jp, tp = pipes
    x = _inputs(2)
    kw = dict(height=32, width=48, num_frames=5, num_inference_steps=3,
              guidance_scale=4.0, use_distill=use_distill,
              output_type="latent")
    want = jp.generate_t2v(jax.random.key(4), jnp.asarray(x["pe"]),
                           jnp.asarray(x["pmask"]), jnp.asarray(x["ne"]),
                           jnp.asarray(x["nmask"]), **kw)
    got = tp.generate_t2v(None, x["pe"], x["pmask"], x["ne"], x["nmask"],
                          noise_fn=_jax_first(4), **kw)
    assert got.shape == (1, 4, 2, 4, 6)
    assert _rel(got, want) < TOL


# ----------------------------------------------------------------- vc


def test_kv_cache_forward_matches_jax(pipes):
    """The cache pass and the cached step against the JAX functions, and
    the cached step against the joint forward's noise tokens."""
    from worldforge_tpu.models.longcat import dit as jdit
    jp, tp = pipes
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    x = _inputs(3)
    tb = np.full((1, 3), 700.0, np.float32)
    kv_j = jdit.longcat_dit_cache_cond(jp.dit_params, jp.dit_cfg,
                                       jnp.asarray(cond), policy=J_FP32)
    kv_t = tdit.longcat_dit_cache_cond(tp.dit_params, tp.dit_cfg,
                                       torch.from_numpy(cond), policy=T_FP32)
    assert len(kv_t) == tp.dit_cfg.depth
    for lj, lt in zip(np.asarray(kv_j), kv_t):
        assert _rel(lt, lj) < TOL
    want = jdit.longcat_dit_forward_with_cache(
        jp.dit_params, jp.dit_cfg, jnp.asarray(noise), jnp.asarray(tb),
        jnp.asarray(x["pe"]), kv_j, (2,),
        encoder_attention_mask=jnp.asarray(x["pmask"]), policy=J_FP32)
    got = tdit.longcat_dit_forward_with_cache(
        tp.dit_params, tp.dit_cfg, torch.from_numpy(noise),
        torch.from_numpy(tb), torch.from_numpy(x["pe"]), kv_t, (2,),
        encoder_attention_mask=torch.from_numpy(x["pmask"]), policy=T_FP32)
    assert _rel(got, want) < TOL
    joint_t = np.concatenate([np.zeros((1, 2), np.float32), tb], axis=1)
    joint = tdit.longcat_dit_forward(
        tp.dit_params, tp.dit_cfg,
        torch.from_numpy(np.concatenate([cond, noise], axis=2)),
        torch.from_numpy(joint_t), torch.from_numpy(x["pe"]),
        encoder_attention_mask=torch.from_numpy(x["pmask"]),
        num_cond_latents=2, policy=T_FP32)
    # the joint forward's zero cond cross-attention rows and the cached
    # step's absent cond tokens give the same noise-token outputs
    assert _rel(got, joint[:, :, 2:]) < TOL


VC_KW = dict(height=16, width=16, num_frames=13, num_cond_frames=5,
             num_inference_steps=3)


@pytest.mark.parametrize("enhance_hf", [False, True])
def test_generate_vc_matches_jax(pipes, fp32_convs, enhance_hf):
    jp, tp = pipes
    x = _inputs(4)
    video = np.random.default_rng(7).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(
        np.float32)
    kw = dict(VC_KW, enhance_hf=enhance_hf, output_type="latent")
    if enhance_hf:
        kw["num_inference_steps"] = 4
    want = jp.generate_vc(jax.random.key(5), jnp.asarray(video),
                          jnp.asarray(x["pe"]), jnp.asarray(x["pmask"]), **kw)
    got = tp.generate_vc(None, video, x["pe"], x["pmask"],
                         noise_fn=_jax_first(5), **kw)
    assert got.shape == (1, 4, 4, 2, 2)
    assert _rel(got, want) < TOL


def test_generate_vc_bf16_cache(pipes, fp32_convs):
    """The bf16 cond cache against the JAX package's bf16 cache and the
    port's fp32 cache, at the JAX package's drift gate; the rounding must
    be real (a drift of 0 would mean the dtype was not threaded)."""
    jp, tp = pipes
    x = _inputs(4)
    video = np.random.default_rng(7).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(
        np.float32)
    kw = dict(VC_KW, enhance_hf=False, output_type="latent")
    jb = dataclasses.replace(jp, vc_cache_dtype="bfloat16")
    tb = dataclasses.replace(tp, vc_cache_dtype="bfloat16")
    want = jb.generate_vc(jax.random.key(5), jnp.asarray(video),
                          jnp.asarray(x["pe"]), jnp.asarray(x["pmask"]), **kw)
    got = tb.generate_vc(None, video, x["pe"], x["pmask"],
                         noise_fn=_jax_first(5), **kw)
    fp32 = tp.generate_vc(None, video, x["pe"], x["pmask"],
                          noise_fn=_jax_first(5), **kw)
    assert _rel(got, want) < 2e-2
    drift = _rel(got, fp32)
    assert 0.0 < drift < 2e-2, drift


def test_generate_vc_pixels_and_distill_check(pipes, fp32_convs):
    _, tp = pipes
    x = _inputs(4)
    video = np.random.default_rng(7).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(
        np.float32)
    gen = torch.Generator().manual_seed(0)
    out = tp.generate_vc(gen, video, x["pe"], x["pmask"], enhance_hf=False,
                         **VC_KW)
    assert out.shape == (1, 3, 13, 16, 16) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="enhance_hf"):
        tp.generate_vc(gen, video, x["pe"], x["pmask"], use_distill=True,
                       enhance_hf=True, **VC_KW)
