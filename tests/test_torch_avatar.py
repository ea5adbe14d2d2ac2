"""The port's LongCat avatar (wav2vec2, the audio-conditioned DiT, the
pipeline, the loader and ``run_avatar``) against the JAX package's, on the
CPU.

Tiny configs, fp32 policy on both sides. The wav2vec2 and avatar DiT
weights come from the JAX ``init_*`` functions with every all-zero leaf
(the biases, the LayerNorm shifts) replaced by seeded random values, and
are carried over by ``io/from_jax.py``; the tiny VAE is made with the
port's init and carried to JAX, and both run fp32 3x3x3 convs. The JAX
pipeline draws its initial latents from the key; the port's ``noise_fn`` is
fed that draw.

Tolerances: the window regrouping and gathers exact; the audio projection
1e-5 relative; wav2vec2 (the JAX gate of its own tests) and every DiT
forward and generate 1e-4 relative max; the k/v-cache forward against the
joint forward 1e-5; the WAV readers equal to the JAX CLI's.
"""

import dataclasses
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.cli import run_avatar as jcli
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.encoders import wav2vec2 as jw2v
from worldforge_tpu.models.longcat import avatar as javt
from worldforge_tpu.models.longcat.dit import LongCatDiTConfig as JBase
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines import avatar as jpipe
from worldforge_tpu_torch.cli import run_avatar as tcli
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import (avatar_params_from_jax,
                                              wav2vec2_params_from_jax)
from worldforge_tpu_torch.models.encoders import wav2vec2 as tw2v
from worldforge_tpu_torch.models.longcat import avatar as tavt
from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig as TBase
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.pipelines import avatar as tpipe

torch.set_num_threads(2)

TOL = 1e-4
BASE_KW = dict(in_channels=4, out_channels=4, hidden_size=64, depth=2,
               num_heads=2, caption_channels=32, adaln_tembed_dim=32,
               frequency_embedding_size=16)
AUDIO_KW = dict(audio_blocks=2, audio_channels=8, intermediate_dim=16,
                output_dim=8, context_tokens=4)
M = 6                                     # text tokens


def randomize_zero_leaves(tree, seed, scale=0.1):
    """Every all-zero leaf -> seeded N(0, scale^2) values."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, tree)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.fixture
def fp32_convs(monkeypatch):
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    try:
        yield
    finally:
        jvae._CONV3D_MODE = old


@pytest.fixture(scope="module")
def avatar():
    jcfg = javt.AvatarConfig(base=JBase(**BASE_KW), **AUDIO_KW)
    tcfg = tavt.AvatarConfig(base=TBase(**BASE_KW), **AUDIO_KW)
    jp = randomize_zero_leaves(jax.tree_util.tree_map(
        np.asarray, javt.init_avatar_dit(jax.random.key(0, impl="rbg"), jcfg,
                                         dtype=jnp.float32)), 1)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, jp), tcfg,
            avatar_params_from_jax(jp))


def _inputs(b, t_lat, h_lat, w_lat, seed, audio_batch=None):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    t_video = 1 + 4 * (t_lat - 1)
    kv = np.zeros((b, M), np.int32)
    kv[:, :4] = 1
    return dict(
        x=f32(rng.standard_normal((b, 4, t_lat, h_lat, w_lat))),
        ctx=f32(rng.standard_normal((b, M, 32))), mask=kv,
        audio=f32(rng.standard_normal((audio_batch or b, t_video, 5, 2, 8))))


# -------------------------------------------------------------- wav2vec2


def test_wav2vec2_forward_and_windows_match_jax():
    cfg_kw = dict(jw2v.Wav2Vec2Config.tiny().__dict__)
    jcfg, tcfg = jw2v.Wav2Vec2Config(**cfg_kw), tw2v.Wav2Vec2Config(**cfg_kw)
    jp = randomize_zero_leaves(jax.tree_util.tree_map(
        np.asarray, jw2v.init_wav2vec2(jax.random.key(3, impl="rbg"), jcfg)), 4)
    tp = wav2vec2_params_from_jax(jp)
    wav = np.random.default_rng(5).standard_normal((2, 3200)).astype(
        np.float32)
    want = jax.jit(lambda p_, w_: jw2v.wav2vec2_forward(p_, jcfg, w_, 9))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(wav))
    got = tw2v.wav2vec2_forward(tp, tcfg, _t(wav), seq_len=9)
    assert got.shape == (2, 9, jcfg.num_layers, jcfg.hidden_size)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(
        tw2v.get_audio_windows(got, 5).numpy(),
        np.asarray(jw2v.get_audio_windows(jnp.asarray(got.numpy()), 5)))


# ------------------------------------------------------------ audio proj


def test_regroup_and_audio_proj_match_jax(avatar):
    jcfg, jp, tcfg, tp = avatar
    audio = _inputs(2, 3, 4, 4, 6)["audio"]
    jf, jl = javt.regroup_audio_windows(jcfg, jnp.asarray(audio))
    tf, tl = tavt.regroup_audio_windows(tcfg, _t(audio))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.shape[2] == tcfg.window_vf
    want = javt.audio_proj_forward(jp["audio_proj"], jcfg, jf, jl)
    got = tavt.audio_proj_forward(tp["audio_proj"], tcfg, tf, tl)
    assert _rel(got, want) < 1e-5


# ------------------------------------------------------------ DiT forward


def _forward_pair(avatar, inp, t, **kw):
    jcfg, jp, tcfg, tp = avatar
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = javt.avatar_dit_forward(
        jp, jcfg, jnp.asarray(inp["x"]), jnp.asarray(t),
        jnp.asarray(inp["ctx"]), jnp.asarray(inp["audio"]),
        encoder_attention_mask=jnp.asarray(inp["mask"]), policy=J_FP32,
        **jkw)
    got = tavt.avatar_dit_forward(
        tp, tcfg, _t(inp["x"]), _t(t), _t(inp["ctx"]), _t(inp["audio"]),
        encoder_attention_mask=_t(inp["mask"]), policy=T_FP32, **tkw)
    return got, want


def test_avatar_dit_forward_singletalk_matches_jax(avatar):
    """i2v: a cond frame at t = 0, per-frame timesteps, kv_lens 4 of 6."""
    inp = _inputs(1, 3, 4, 4, 7)
    t = np.array([[0.0, 600.0, 600.0]], np.float32)
    got, want = _forward_pair(avatar, inp, t, num_cond_latents=1)
    assert _rel(got, want) < TOL
    got0, want0 = _forward_pair(avatar, inp, np.array([300.0], np.float32))
    assert _rel(got0, want0) < TOL


def test_avatar_dit_forward_token_chunk_matches_jax(avatar):
    """``token_chunk=2``: the FFN over two token chunks, as JAX's
    ``swiglu_ffn`` runs it (singletalk, a cond frame)."""
    inp = _inputs(1, 3, 4, 4, 11)
    t = np.array([[0.0, 600.0, 600.0]], np.float32)
    got, want = _forward_pair(avatar, inp, t, num_cond_latents=1,
                              token_chunk=2)
    assert _rel(got, want) < TOL


def test_avatar_dit_forward_multitalk_matches_jax(avatar):
    """Two speakers: the audio batch holds both, [2, H, W] pixel masks
    (nearest to the token grid), the attention map's argmax bands and the
    1-D RoPE of queries and audio keys."""
    inp = _inputs(1, 3, 8, 8, 8, audio_batch=2)
    masks = np.zeros((2, 8, 8), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, 4:] = 1.0
    t = np.array([[0.0, 500.0, 500.0]], np.float32)
    got, want = _forward_pair(avatar, inp, t, num_cond_latents=1,
                              ref_target_masks=masks)
    assert _rel(got, want) < TOL
    # the positions themselves, with a tie resolved to the first speaker
    amap = np.random.default_rng(9).random((2, 40)).astype(np.float32)
    amap[1, :5] = amap[0, :5]
    np.testing.assert_allclose(
        tavt.multitalk_positions(_t(amap)).numpy(),
        np.asarray(javt.multitalk_positions(jnp.asarray(amap))), atol=1e-6)


def test_avatar_dit_forward_ref_mode_matches_jax(avatar):
    """A ref frame at temporal position 3, two cond frames and
    ``mask_frame_range`` 1: the ref / cond / noise partitions and the
    masked noise band (which changes the output)."""
    inp = _inputs(1, 6, 4, 4, 10)
    t = np.array([[0.0, 0.0, 400.0, 400.0, 400.0, 400.0]], np.float32)
    kw = dict(num_cond_latents=2, num_ref_latents=1, ref_img_index=3)
    got, want = _forward_pair(avatar, inp, t, mask_frame_range=1, **kw)
    assert _rel(got, want) < TOL
    unmasked, _ = _forward_pair(avatar, inp, t, **kw)
    assert _rel(unmasked, want) > 1e-3


def test_avatar_kv_cache_pair_matches_joint_and_jax(avatar):
    """The cond frames' cache, then the noise frames against it: equal to
    the joint forward's noise frames (cond at t = 0), and to JAX's."""
    jcfg, jp, tcfg, tp = avatar
    inp = _inputs(1, 4, 4, 4, 11)
    nc = 2
    cond, noise = inp["x"][:, :, :nc], inp["x"][:, :, nc:]
    tn = np.array([700.0], np.float32)
    cache = tavt.avatar_dit_cache_cond(tp, tcfg, _t(cond), policy=T_FP32)
    got = tavt.avatar_dit_forward_with_cache(
        tp, tcfg, _t(noise), _t(tn), _t(inp["ctx"]), _t(inp["audio"]), cache,
        (nc,), encoder_attention_mask=_t(inp["mask"]), policy=T_FP32)
    joint = tavt.avatar_dit_forward(
        tp, tcfg, _t(inp["x"]), _t(np.array([[0, 0, 700, 700]], np.float32)),
        _t(inp["ctx"]), _t(inp["audio"]),
        encoder_attention_mask=_t(inp["mask"]), num_cond_latents=nc,
        policy=T_FP32)
    assert _rel(got, joint[:, :, nc:]) < 1e-5
    jcache = javt.avatar_dit_cache_cond(jp, jcfg, jnp.asarray(cond),
                                        policy=J_FP32)
    want = javt.avatar_dit_forward_with_cache(
        jp, jcfg, jnp.asarray(noise), jnp.asarray(tn),
        jnp.asarray(inp["ctx"]), jnp.asarray(inp["audio"]), jcache, (nc,),
        encoder_attention_mask=jnp.asarray(inp["mask"]), policy=J_FP32)
    assert _rel(got, want) < TOL


# -------------------------------------------------------------- pipeline


@pytest.mark.parametrize("use_distill", [False, True],
                         ids=["cfg", "distill"])
def test_generate_i2v_audio_matches_jax(avatar, fp32_convs, use_distill):
    """The reference image's latent in frame 0 with t = 0, CFG-zero (or the
    distill table without CFG), the negated velocity and Euler on the noise
    frames, 9 frames at 32 x 32 over 3 steps."""
    jcfg, jp, tcfg, tp = avatar
    tv = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                           tvae.WanVAEConfig.tiny())
    jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tv)
    jpp = jpipe.AvatarPipeline(dit_params=jp, dit_cfg=jcfg, vae_params=jv,
                               vae_cfg=jvae.WanVAEConfig.tiny(),
                               policy=J_FP32)
    tpp = tpipe.AvatarPipeline(dit_params=tp, dit_cfg=tcfg, vae_params=tv,
                               vae_cfg=tvae.WanVAEConfig.tiny(),
                               policy=T_FP32)
    rng = np.random.default_rng(12)
    f32 = lambda a: a.astype(np.float32)
    image = f32(rng.uniform(-1, 1, (1, 3, 32, 32)))
    audio = _inputs(1, 3, 4, 4, 13)["audio"]
    pe, ne = (f32(rng.standard_normal((1, M, 32))) for _ in range(2))
    pm = np.zeros((1, M), np.int32)
    pm[:, :3] = 1
    nm = np.ones((1, M), np.int32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=3,
              guidance_scale=4.0, use_distill=use_distill,
              output_type="latent")
    want = jpp.generate_i2v_audio(jax.random.key(4), *map(
        jnp.asarray, (image, audio, pe, pm, ne, nm)), **kw)

    def draw(shape):
        _, k = jax.random.split(jax.random.key(4))
        return np.asarray(jax.random.normal(k, shape, jnp.float32))
    got = tpp.generate_i2v_audio(None, image, audio, pe, pm, ne, nm,
                                 noise_fn=draw, **kw)
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------- loader


def test_load_avatar_pipeline_random_init_matches_jax(monkeypatch):
    """The random-init branch builds JAX's configs and parameter trees
    (keys, shapes, dtypes; the weights come from other generators) and the
    same text masks. The JAX inits run abstractly (``jax.eval_shape``)."""
    from worldforge_tpu.io import checkpoints as jck
    from worldforge_tpu_torch.io.checkpoints import load_avatar_pipeline
    seen = {}

    def abstract(name, fn):
        def run(key, cfg, *a, **k):
            seen[name] = cfg
            return jax.eval_shape(lambda kk: fn(kk, cfg, *a, **k), key)
        return run
    monkeypatch.setattr(javt, "init_avatar_dit",
                        abstract("dit", javt.init_avatar_dit))
    monkeypatch.setattr(jw2v, "init_wav2vec2",
                        abstract("w2v", jw2v.init_wav2vec2))
    monkeypatch.setattr(jck, "init_wan_vae",
                        abstract("vae", jck.init_wan_vae))
    jp, jenc_t, _ = jck.load_avatar_pipeline(None, random_init=True)
    tp, tenc_t, tenc_a = load_avatar_pipeline(random_init=True,
                                              device="cpu")
    assert dataclasses.asdict(tp.dit_cfg) == dataclasses.asdict(jp.dit_cfg)
    assert dataclasses.asdict(tp.vae_cfg) == dataclasses.asdict(jp.vae_cfg)

    def spec(tree):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in leaves}

    def tspec(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(tspec(v, f"{path}['{k}']"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(tspec(v, f"{path}[{i}]"))
            return out
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}

    tblocks = tp.dit_params["blocks"]
    stacked = {f"['blocks']{k}": ((len(tblocks),) + s, d)
               for k, (s, d) in tspec(tblocks[0]).items()}
    tdit = {**tspec({k: v for k, v in tp.dit_params.items()
                     if k != "blocks"}), **stacked}
    assert tdit == spec(jp.dit_params)
    assert tspec(tp.vae_params) == spec(jp.vae_params)
    emb, mask = tenc_t("a person talking")
    jemb, jmask = jenc_t("a person talking")
    assert tuple(emb.shape) == jemb.shape
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    w2v_cfg = seen["w2v"]
    wins = tenc_a(np.zeros((1, 3200), np.float32), 9)
    assert tuple(wins.shape) == (1, 9, 5, w2v_cfg.num_layers,
                                 w2v_cfg.hidden_size)
    assert w2v_cfg.intermediate_size == 1536
    from worldforge_tpu_torch.io.checkpoints import DEFAULT_RANDOM_WAV2VEC2
    assert dataclasses.asdict(DEFAULT_RANDOM_WAV2VEC2) == \
        dataclasses.asdict(w2v_cfg)
    # the converted branch on a missing directory fails as the JAX
    # loader's does (its reader cannot open <dir>/dit)
    with pytest.raises(FileNotFoundError):
        jck.load_avatar_pipeline("/nonexistent")
    with pytest.raises(FileNotFoundError):
        load_avatar_pipeline("/nonexistent", device="cpu")


# ------------------------------------------------------------------- CLI


def _write_wav(path, x, width, sr=16000, channels=1):
    if width == 2:
        raw = (x * 32767).astype("<i2").tobytes()
    else:                                  # 24-bit little-endian
        v = (x * (2 ** 23 - 1)).astype("<i4")
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                       axis=-1).astype(np.uint8).tobytes()
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw)


@pytest.mark.parametrize("kind", ["npy", "wav16", "wav24"])
def test_run_avatar_on_cpu(tmp_path, kind):
    """``run_avatar --random-init --device cpu`` on a .npy waveform and on
    16- and 24-bit WAVs (stereo at 22.05 kHz for 24 bits: downmixed and
    resampled); the WAV readers equal the JAX CLI's."""
    from PIL import Image
    rng = np.random.default_rng(14)
    img = str(tmp_path / "face.png")
    Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
        img)
    x = (0.5 * np.sin(np.arange(6400) / 7.0)).astype(np.float32)
    if kind == "npy":
        audio = str(tmp_path / "a.npy")
        np.save(audio, x)
    elif kind == "wav16":
        audio = str(tmp_path / "a.wav")
        _write_wav(audio, x, 2)
    else:
        audio = str(tmp_path / "a.wav")
        _write_wav(audio, np.repeat(x, 2), 3, sr=22050, channels=2)
    wav = tcli._load_waveform(audio)
    np.testing.assert_array_equal(wav, jcli._load_waveform(audio))
    if kind != "wav24":
        np.testing.assert_allclose(wav[0], x, atol=1e-4)
    out = str(tmp_path / "avatar.mp4")
    tcli.main(["--image", img, "--audio", audio, "--random-init",
               "--device", "cpu", "--resize", "32", "32", "--num-frames",
               "5", "--num-inference-steps", "2", "--output", out])
    assert os.path.getsize(out) > 0
    import cv2
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()


def test_run_avatar_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(str(tmp_path / "a.npy"), np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--image", "unused.png", "--audio",
                   str(tmp_path / "a.npy"), "--random-init"])
