"""The port's DepthCrafter stack against the JAX package's, on the CPU.

The EDM Euler schedule and step, the tiny SVD UNet (three frames, so the
temporal convs and attention mix frames) with and without ``attn_chunks``,
the tiny SVD VAE, ``DepthCrafterPipeline`` with the JAX package's two draws
fed through ``noise_fn`` (windowed, single window, CFG) and
``normalize_depth``. One set of JAX ``init_*`` parameters goes to both
sides through ``io/from_jax.py``; inputs come from a seeded numpy
generator. Everything is fp32 (the JAX CPU tests run at "highest" matmul
precision, and the port's CPU convs are full fp32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.models.depthcrafter import unet as junet
from worldforge_tpu.models.depthcrafter import vae as jvae
from worldforge_tpu.pipelines import depthcrafter as jpipe
from worldforge_tpu.sampling import euler_edm as jedm
from worldforge_tpu_torch.io.from_jax import (svd_unet_params_from_jax,
                                              svd_vae_params_from_jax)
from worldforge_tpu_torch.models.depthcrafter import unet as tunet
from worldforge_tpu_torch.models.depthcrafter import vae as tvae
from worldforge_tpu_torch.pipelines import depthcrafter as tpipe
from worldforge_tpu_torch.sampling import euler_edm as tedm

torch.set_num_threads(2)

IDS = np.array([[7.0, 127.0, 0.02]], np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np_tree_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


_j_encode = jax.jit(jvae.svd_vae_encode, static_argnums=(1,),
                    static_argnames=("scale",))
_j_decode = jax.jit(jvae.svd_vae_decode, static_argnums=(1,))


@functools.partial(jax.jit, static_argnums=(1,),
                   static_argnames=("attn_chunks",))
def _j_unet(params, cfg, x, t, ctx, ids, attn_chunks=1):
    return junet.svd_unet_forward(params, cfg, x, t, ctx, ids,
                                  attn_chunks=attn_chunks)


@pytest.fixture(scope="module")
def models():
    """Tiny UNet and VAE params from the JAX package's init, in both
    packages' form, and one JAX pipeline whose jitted UNet the UNet and
    pipeline tests share. The keys are "rbg" keys: with the default
    threefry keys the init takes half a minute here. The JAX pipeline's VAE
    calls run jitted for the module's tests (the same functions; op by op
    they take seconds a call here)."""
    ucfg, vcfg = junet.SVDUNetConfig.tiny(), jvae.SVDVAEConfig.tiny()
    ju = junet.init_svd_unet(jax.random.key(0, impl="rbg"), ucfg)
    jv = jvae.init_svd_vae(jax.random.key(1, impl="rbg"), vcfg)
    saved = jpipe.svd_vae_encode, jpipe.svd_vae_decode
    jpipe.svd_vae_encode, jpipe.svd_vae_decode = _j_encode, _j_decode
    yield {"ucfg": ucfg, "vcfg": vcfg, "ju": ju, "jv": jv,
           "tucfg": tunet.SVDUNetConfig.tiny(),
           "tvcfg": tvae.SVDVAEConfig.tiny(),
           "tu": svd_unet_params_from_jax(_np_tree(ju)),
           "tv": svd_vae_params_from_jax(_np_tree(jv)),
           "jpipe": jpipe.DepthCrafterPipeline(ju, ucfg, jv, vcfg)}
    jpipe.svd_vae_encode, jpipe.svd_vae_decode = saved


# ------------------------------------------------------------ EDM Euler


@pytest.mark.parametrize("steps", [1, 5, 25])
def test_edm_schedule_equals_jax(steps):
    j = jedm.make_edm_euler_schedule(steps)
    t = tedm.make_edm_euler_schedule(steps)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert t.sigmas.dtype == np.float64 and t.num_steps == j.num_steps
    assert t.init_noise_sigma == j.init_noise_sigma


def test_edm_step_matches_jax(rng):
    sched_j = jedm.make_edm_euler_schedule(5)
    sched_t = tedm.make_edm_euler_schedule(5)
    x = (rng.standard_normal((1, 3, 4, 6, 8)) * 50).astype(np.float32)
    v = rng.standard_normal(x.shape).astype(np.float32)
    for i in range(5):
        want_in = jedm.edm_scale_model_input(sched_j, i, jnp.asarray(x))
        got_in = tedm.edm_scale_model_input(sched_t, i, torch.from_numpy(x))
        assert _rel(got_in.numpy(), want_in) <= 1e-6
        want = jedm.edm_euler_step(sched_j, i, jnp.asarray(x), jnp.asarray(v))
        got = tedm.edm_euler_step(sched_t, i, torch.from_numpy(x),
                                  torch.from_numpy(v))
        assert _rel(got.numpy(), want) <= 1e-6, i


# ------------------------------------------------------------ UNet


def _unet_inputs(rng, cfg, f=3, hh=16, ww=16):
    x = rng.standard_normal((1, f, 8, hh, ww)).astype(np.float32)
    ctx = rng.standard_normal((1, f, 1, cfg.cross_attention_dim)
                              ).astype(np.float32)
    return x, ctx


def test_timestep_embedding_matches_jax(rng):
    """The pipeline's arguments: EDM timesteps 0.25 log(sigma) in [-1.6,
    1.7] and the added ids 7, 127, 0.02 (the frame positions are 0 .. F-1).
    sin and cos of an argument near 127 differ between the two libraries
    by about one fp32 ulp of the argument (8e-6)."""
    t = np.concatenate([rng.uniform(-1.6, 1.7, 6), [7.0, 127.0, 0.02]]
                       ).astype(np.float32)
    for dim in (8, 256, 320):
        want = junet.sinusoidal_timestep_embedding(jnp.asarray(t), dim)
        got = tunet.sinusoidal_timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)


def test_svd_unet_forward_matches_jax(models, rng):
    """Three frames: the temporal res blocks, the temporal transformer
    (its frame-position embedding and first-frame context) and the alpha
    blends all mix frames. (8 x 8 latents: the JAX pipeline's compiled
    UNet of the three-frame window.)"""
    x, ctx = _unet_inputs(rng, models["ucfg"], hh=8, ww=8)
    want = models["jpipe"]._unet(models["ju"], jnp.asarray(x), 1.5,
                                 jnp.asarray(ctx), jnp.asarray(IDS))
    got = tunet.svd_unet_forward(models["tu"], models["tucfg"],
                                 torch.from_numpy(x), 1.5,
                                 torch.from_numpy(ctx), torch.from_numpy(IDS))
    assert got.shape == (1, 3, 4, 8, 8)
    assert _rel(got.numpy(), want) < 1e-4
    # the frames mix: changing frame 2 changes frame 0
    x2 = x.copy()
    x2[:, 2] += 5.0
    got2 = tunet.svd_unet_forward(models["tu"], models["tucfg"],
                                  torch.from_numpy(x2), 1.5,
                                  torch.from_numpy(ctx),
                                  torch.from_numpy(IDS))
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("chunks", [2, 3])
def test_svd_unet_attn_chunks_exact(models, rng, chunks):
    """Three frames at 16 x 16 latents: the spatial blocks chunk over B*F
    = 3 rows (2 rounds up to 3, a divisor; 3 divides), the temporal blocks
    over B*H*W = 256, 64, 16 and 4 rows (2 divides; 3 rounds up to 4).
    Equal to one pass, and to JAX with the same knob."""
    x, ctx = _unet_inputs(rng, models["ucfg"])
    args = (torch.from_numpy(x), 1.5, torch.from_numpy(ctx),
            torch.from_numpy(IDS))
    ref = tunet.svd_unet_forward(models["tu"], models["tucfg"], *args)
    got = tunet.svd_unet_forward(models["tu"], models["tucfg"], *args,
                                 attn_chunks=chunks)
    assert _rel(got.numpy(), ref.numpy()) <= 1e-6
    want = _j_unet(models["ju"], models["ucfg"], jnp.asarray(x), 1.5,
                   jnp.asarray(ctx), jnp.asarray(IDS), attn_chunks=chunks)
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("lead,n,sizes", [
    (12, 3, [4, 4, 4]),          # a divisor
    (12, 5, [2] * 6),            # rounds up to the divisor 6 (<= 4n)
    (7, 2, [1] * 7),             # the divisor 7 is within 4n = 8
    (11, 2, [11]),               # no divisor <= 4n: one pass
    (13, 3, [13]),
    (5, 1, [5]),
])
def test_map_chunked_rule(lead, n, sizes):
    """``_map_chunked``'s chunk sizes follow the JAX rule, and the result
    is the unchunked one."""
    seen = []

    def fn(a, b):
        seen.append(a.shape[0])
        return a * 2 + b

    a = torch.arange(lead * 3, dtype=torch.float32).reshape(lead, 3)
    out = tunet._map_chunked(fn, n, a, a + 1)
    assert seen == sizes
    torch.testing.assert_close(out, a * 3 + 1, rtol=0, atol=0)
    want = junet._map_chunked(lambda x, y: x * 2 + y, n, jnp.asarray(a),
                              jnp.asarray(a + 1))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# ------------------------------------------------------------ VAE


@pytest.mark.parametrize("scale", [True, False])
def test_svd_vae_encode_matches_jax(models, rng, scale):
    frames = rng.uniform(-1, 1, (2, 3, 32, 48)).astype(np.float32)
    want = _j_encode(models["jv"], models["vcfg"], jnp.asarray(frames),
                     scale=scale)
    got = tvae.svd_vae_encode(models["tv"], models["tvcfg"],
                              torch.from_numpy(frames), scale=scale)
    assert got.shape == (2, 4, 4, 6)
    assert _rel(got.numpy(), want) < 1e-4


def test_svd_vae_decode_matches_jax(models, rng):
    """Three latent frames: the temporal decoder's res blocks and its final
    temporal conv mix them."""
    z = rng.standard_normal((3, 4, 4, 6)).astype(np.float32) * 0.2
    want = _j_decode(models["jv"], models["vcfg"], jnp.asarray(z))
    got = tvae.svd_vae_decode(models["tv"], models["tvcfg"],
                              torch.from_numpy(z))
    assert got.shape == (3, 3, 32, 48)
    assert _rel(got.numpy(), want) < 1e-4


# ------------------------------------------------------------ pipeline


def _jax_draws(key, t_frames, h, w, window):
    """The JAX pipeline's two draws: the frame noise (k_aug), then the
    initial latents (k_lat)."""
    key, k_aug = jax.random.split(key)
    frames = np.asarray(jax.random.normal(k_aug, (t_frames, 3, h, w),
                                          jnp.float32))
    key, k_lat = jax.random.split(key)
    lat = np.asarray(jax.random.normal(k_lat, (1, window, 4, h // 8, w // 8),
                                       jnp.float32))
    draws = [frames, lat]

    def noise_fn(shape):
        out = draws.pop(0)
        assert out.shape == shape
        return out

    return noise_fn


@pytest.mark.parametrize("t_frames,window,overlap,chunk,cfg_scale", [
    (7, 4, 2, 4, 1.0),     # three windows: re-init and blend twice
    (3, 8, 3, 2, 1.0),     # t <= window: one window, overlap 0
    (5, 4, 1, 8, 2.0),     # CFG with zeroed conditioning, two windows
])
def test_pipeline_matches_jax(models, rng, t_frames, window, overlap, chunk,
                              cfg_scale):
    video = rng.uniform(0, 1, (t_frames, 64, 64, 3)).astype(np.float32)
    kw = dict(num_inference_steps=2, guidance_scale=cfg_scale,
              window_size=window, overlap=overlap, decode_chunk_size=chunk)
    want = models["jpipe"](jax.random.key(2), video, **kw)
    tp = tpipe.DepthCrafterPipeline(models["tu"], models["tucfg"],
                                    models["tv"], models["tvcfg"])
    got = tp(None, video, noise_fn=_jax_draws(
        jax.random.key(2), t_frames, 64, 64, min(window, t_frames)), **kw)
    assert got.shape == want.shape == (t_frames, 64, 64, 3)
    assert _rel(got, want) < 1e-4
    d_want, d_got = jpipe.normalize_depth(want), tpipe.normalize_depth(got)
    assert d_got.shape == (t_frames, 64, 64)
    np.testing.assert_allclose(d_got, d_want, atol=1e-4)


def test_pipeline_clip_embeds_and_generator(models, rng):
    """``encode_frames_clip`` feeds the per-frame context: the port's
    ``clip_frame_encoder`` (``preprocess_clip`` + ``clip_vision_image_embeds``
    of a tiny CLIP and its projection to the UNet's context width) against
    the same encoder built from the JAX package's functions, as its
    converter builds it. A torch generator drives the draws when no
    ``noise_fn`` is given (reproducible from its seed)."""
    from worldforge_tpu.models.encoders import clip_vision as jclip
    from worldforge_tpu_torch.io.from_jax import clip_params_from_jax
    from worldforge_tpu_torch.models.encoders import clip_vision as tclip
    ccfg = jclip.CLIPVisionConfig.tiny()
    jc = jclip.init_clip_vision(jax.random.key(5, impl="rbg"), ccfg)
    jproj = jclip.init_clip_projection(jax.random.key(6, impl="rbg"), ccfg,
                                       models["ucfg"].cross_attention_dim)

    def j_clip(frames):  # as worldforge_tpu/io/convert_depthcrafter.py
        arr = np.asarray((frames + 1.0) / 2.0).transpose(0, 2, 3, 1)
        px = np.concatenate([jclip.preprocess_clip(f, ccfg.image_size)
                             for f in arr], axis=0)
        return jclip.clip_vision_image_embeds(jc, jproj, ccfg,
                                              jnp.asarray(px))

    t_clip = tpipe.clip_frame_encoder(
        clip_params_from_jax(_np_tree(jc)), _np_tree_torch(jproj),
        tclip.CLIPVisionConfig.tiny())
    video = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    kw = dict(num_inference_steps=2, window_size=8, overlap=0)
    jp = jpipe.DepthCrafterPipeline(models["ju"], models["ucfg"],
                                    models["jv"], models["vcfg"],
                                    encode_frames_clip=j_clip)
    tp = tpipe.DepthCrafterPipeline(models["tu"], models["tucfg"],
                                    models["tv"], models["tvcfg"],
                                    encode_frames_clip=t_clip)
    frames = video.transpose(0, 3, 1, 2) * 2.0 - 1.0
    got_e = t_clip(torch.from_numpy(frames))
    assert got_e.shape == (3, models["ucfg"].cross_attention_dim)
    assert _rel(got_e.numpy(), j_clip(jnp.asarray(frames))) < 1e-4
    jp._unet = models["jpipe"]._unet      # the shared compiled UNet
    want = jp(jax.random.key(4), video, **kw)
    got = tp(None, video, noise_fn=_jax_draws(jax.random.key(4), 3, 64, 64,
                                              3), **kw)
    assert _rel(got, want) < 1e-4
    a = tp(torch.Generator().manual_seed(9), video, **kw)
    b = tp(torch.Generator().manual_seed(9), video, **kw)
    np.testing.assert_array_equal(a, b)


def test_estimate_depth_needs_weights(rng):
    """Without a checkpoint the entry point stops with the JAX package's
    message, after the 64-multiple resize (as JAX's, PIL bicubic)."""
    from worldforge_tpu.models.depthcrafter import inference as jinf
    from worldforge_tpu_torch.models.depthcrafter import inference as tinf
    frames = rng.uniform(0, 1, (2, 70, 100, 3)).astype(np.float32)
    with pytest.raises(SystemExit, match="DepthCrafter weights required"):
        tinf.estimate_depth(frames)
    with pytest.raises(SystemExit, match="DepthCrafter weights required"):
        jinf.estimate_depth(frames)
    out = tinf.resize_to_64(frames, max_res=1024)
    assert out.shape == (2, 64, 128, 3)
    assert tinf.resize_to_64(out) is out


def test_card_conv_route(models, rng, monkeypatch):
    """Where ``unet._bf16_convs`` says yes (the card), the 3x3 stride-1
    convs go through ``conv2d_3x3`` (kernel 4; its plain version here) and
    the others take bf16-rounded operands; on the CPU, fp32 convs and no
    ``conv2d_3x3``. The two differ at bf16 noise."""
    calls = []
    orig = tunet.conv2d_3x3

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(tunet, "conv2d_3x3", counted)
    x, ctx = _unet_inputs(rng, models["ucfg"], hh=8, ww=8)
    args = (torch.from_numpy(x), 1.5, torch.from_numpy(ctx),
            torch.from_numpy(IDS))
    ref = tunet.svd_unet_forward(models["tu"], models["tucfg"], *args)
    assert not calls
    monkeypatch.setattr(tunet, "_bf16_convs", lambda x: True)
    got = tunet.svd_unet_forward(models["tu"], models["tucfg"], *args)
    assert len(calls) > 10
    assert 0 < _rel(got.numpy(), ref.numpy()) < 5e-2
