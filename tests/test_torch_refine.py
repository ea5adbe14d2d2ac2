"""The port's LongCat refine (``generate_refine``, the SDEdit upscale)
against the JAX package's, on the CPU.

The tiny configs of ``tests/test_refine.py`` (LongCat tiny DiT with 4
latent channels, the tiny Wan VAE), the DiT weights made with the JAX init
and carried over by ``io/from_jax.py``, the VAE weights made with the
port's init and carried to JAX, the fp32 policy on both sides, and the
port's ``noise_fn`` fed the noise that the JAX pipeline draws from
``jax.random.split(key)``. The latents (``output_type="latent"``) are
compared, and the pixels where the case decodes.

Two conv modes, as in ``test_torch_vae.py``: 'fp32' runs both VAEs with
fp32 3x3x3 convs and holds the results to 1e-4 relative (the same fp32
arithmetic in another order); 'kernel' runs the JAX Pallas conv in
interpret mode against the port's conv3d kernel path, whose bf16 rounding
of the conv inputs flips on last-bit fp32 differences, and holds them at
bf16 noise level (1e-2 relative max). The interpret conv is slow, so the
kernel mode runs the smallest case only.
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
from worldforge_tpu.pipelines.longcat import LongCatPipeline as JPipe
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import longcat_dit_params_from_jax
from worldforge_tpu_torch.models.longcat.dit import LongCatDiTConfig as TCfg
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.pipelines.longcat import LongCatPipeline as TPipe

torch.set_num_threads(2)

TOL = {"fp32": 1e-4, "kernel": 1e-2}     # relative max, by conv mode
CFG_KW = dict(JCfg.tiny().__dict__, in_channels=4, out_channels=4)
M = 6

# stage-1 video (T, H, W), target (H, W), generate_refine keywords
CASES = {
    # latent (4, 16, 32) -> token grid (4, 8, 16) = 512 tokens, 4 chunks
    "bsa_grid": ((13, 64, 128), (128, 256), dict(
        num_inference_steps=2, t_thresh=0.5, spatial_refine_only=True,
        use_bsa=True, bsa_sparsity=0.5)),
    "spatial": ((5, 16, 16), (32, 32), dict(
        num_inference_steps=6, t_thresh=0.5, spatial_refine_only=True,
        use_bsa=False)),
    "temporal_2x": ((4, 16, 16), (32, 32), dict(
        num_inference_steps=4, t_thresh=0.6, spatial_refine_only=False,
        use_bsa=False)),
}


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipelines by conv mode, the port's pipeline). The JAX pipeline
    caches its jitted VAE, traced under the conv mode of its first call,
    so each mode has its own."""
    jdp = jax.tree_util.tree_map(np.asarray, init_longcat_dit(
        jax.random.key(0), JCfg(**CFG_KW), dtype=jnp.float32))
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    jps = {mode: JPipe(dit_params=jax.tree_util.tree_map(jnp.asarray, jdp),
                       dit_cfg=JCfg(**CFG_KW),
                       vae_params=jax.tree_util.tree_map(
                           lambda t: jnp.asarray(t.numpy()), tvp),
                       vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32)
           for mode in TOL}
    tp = TPipe(dit_params=longcat_dit_params_from_jax(jdp),
               dit_cfg=TCfg(**CFG_KW), vae_params=tvp,
               vae_cfg=tvae.WanVAEConfig.tiny(), policy=T_FP32)
    return jps, tp


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.fixture
def conv_mode(request, monkeypatch):
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = ("pallas_interpret" if request.param == "kernel"
                         else "3d")
    if request.param == "fp32":
        monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    try:
        yield request.param
    finally:
        jvae._CONV3D_MODE = old


def _inputs(video_shape, seed=0):
    rng = np.random.default_rng(seed)
    stage1 = rng.uniform(0, 1, video_shape + (3,)).astype(np.float32)
    pe = rng.standard_normal((1, M, CFG_KW["caption_channels"])).astype(
        np.float32)
    pmask = np.zeros((1, M), np.int32)
    pmask[:, :4] = 1                      # kv_lens 4 of 6: keys are masked
    return stage1, pe, pmask


def _jax_noise(seed):
    """The noise the JAX generate_refine draws from ``key(seed)``."""
    def draw(shape):
        _, k_n = jax.random.split(jax.random.key(seed))
        return np.asarray(jax.random.normal(k_n, shape, jnp.float32))
    return draw


def _run_both(jp, tp, video_shape, hw, kw, seed=2, **extra):
    stage1, pe, pmask = _inputs(video_shape)
    kw = dict(kw, height=hw[0], width=hw[1], **extra)
    want = np.asarray(jp.generate_refine(
        jax.random.key(seed), stage1, jnp.asarray(pe), jnp.asarray(pmask),
        **kw))
    got = tp.generate_refine(None, stage1, pe, pmask,
                             noise_fn=_jax_noise(seed), **kw)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return got, want


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case,conv_mode", [
    ("bsa_grid", "fp32"), ("spatial", "fp32"), ("temporal_2x", "fp32"),
    ("spatial", "kernel")], indirect=["conv_mode"])
def test_refine_latents_match_jax(pipes, case, conv_mode):
    jps, tp = pipes
    jp = jps[conv_mode]
    video_shape, hw, kw = CASES[case]
    got, want = _run_both(jp, tp, video_shape, hw, kw, output_type="latent")
    t_lat = -(-video_shape[0] * (1 if kw["spatial_refine_only"] else 2)
              // 16) * 4                  # padded to 4 latent frames
    assert got.shape == want.shape == (1, 4, t_lat, hw[0] // 8, hw[1] // 8)
    assert _rel(got, want) < TOL[conv_mode]


@pytest.mark.parametrize("conv_mode", ["fp32"], indirect=True)
def test_stage1_latents_path_matches_jax(pipes, conv_mode):
    """``prepare_refine_latents`` then ``generate_refine(stage1_latents=)``
    is the inline path exactly, and both match the JAX package's."""
    jps, tp = pipes
    jp = jps[conv_mode]
    video_shape, hw, kw = CASES["spatial"]
    stage1, pe, pmask = _inputs(video_shape)
    lat_t = tp.prepare_refine_latents(stage1, height=hw[0], width=hw[1],
                                      spatial_refine_only=True)
    lat_j = jp.prepare_refine_latents(stage1, height=hw[0], width=hw[1],
                                      spatial_refine_only=True)
    assert _rel(lat_t.numpy(), np.asarray(lat_j)) < TOL[conv_mode]
    kw = dict(kw, height=hw[0], width=hw[1], output_type="latent")
    pre = tp.generate_refine(None, stage1, pe, pmask, stage1_latents=lat_t,
                             noise_fn=_jax_noise(7), **kw)
    inl = tp.generate_refine(None, stage1, pe, pmask, noise_fn=_jax_noise(7),
                             **kw)
    np.testing.assert_array_equal(pre.numpy(), inl.numpy())
    want = np.asarray(jp.generate_refine(
        jax.random.key(7), stage1, jnp.asarray(pe), jnp.asarray(pmask),
        stage1_latents=lat_j, **kw))
    assert _rel(pre.numpy(), want) < TOL[conv_mode]


@pytest.mark.parametrize("conv_mode", ["fp32"], indirect=True)
def test_streaming_refine_pixels_match_jax(pipes, conv_mode):
    """Streaming VAE on (encode and decode, chunk 2), pixels out with the
    granularity padding dropped: against the JAX streaming pipeline and the
    port's single-pass pipeline."""
    jps, tp = pipes
    jp = jps[conv_mode]
    video_shape, hw, kw = CASES["spatial"]
    js = dataclasses.replace(jp, streaming_vae=True, streaming_vae_chunk=2)
    ts = dataclasses.replace(tp, streaming_vae=True, streaming_vae_chunk=2)
    got, want = _run_both(js, ts, video_shape, hw, kw)
    single, _ = _run_both(jp, tp, video_shape, hw, kw)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape == (1, 3, 5, 32, 32)
    assert _rel(got, want) < TOL[conv_mode]
    assert _rel(got, single) < TOL[conv_mode]


def test_grid_check_and_later_slices(pipes, capsys):
    """A grid that does not factor into (4, 4, 8) chunks runs dense with
    the JAX package's message; ``token_chunk`` > 1 (ported with the
    parallel layer, as meshes are) gives the same refine; ``auto_layout``
    (XLA entry layouts, no counterpart) raises on every generate path."""
    _, tp = pipes
    video_shape, hw, kw = CASES["spatial"]
    stage1, pe, pmask = _inputs(video_shape)
    out = tp.generate_refine(torch.Generator().manual_seed(0), stage1, pe,
                             pmask, height=hw[0], width=hw[1],
                             num_inference_steps=2, spatial_refine_only=True,
                             use_bsa=True)
    assert out.shape == (1, 3, 5, 32, 32) and np.isfinite(out).all()
    assert "BSA disabled" in capsys.readouterr().out
    chunked = dataclasses.replace(tp, token_chunk=2).generate_refine(
        torch.Generator().manual_seed(0), stage1, pe, pmask, height=hw[0],
        width=hw[1], num_inference_steps=2, spatial_refine_only=True,
        use_bsa=True)
    np.testing.assert_allclose(chunked, out, rtol=0, atol=1e-5)
    for field, value in (("auto_layout", True),):
        bad = dataclasses.replace(tp, **{field: value})
        with pytest.raises(NotImplementedError):
            bad.generate_refine(None, stage1, pe, pmask, height=hw[0],
                                width=hw[1], num_inference_steps=2,
                                spatial_refine_only=True, use_bsa=False)
        # the guided i2v, t2v and vc paths run (tests/
        # test_torch_longcat_guided.py) and refuse the same fields
        calls = (
            lambda: bad.generate_i2v(None, np.zeros((1, 3, 16, 16),
                                                    np.float32), pe, pmask,
                                     height=16, width=16, num_frames=5,
                                     num_inference_steps=1),
            lambda: bad.generate_t2v(None, pe, pmask, height=16, width=16,
                                     num_frames=5, num_inference_steps=1),
            lambda: bad.generate_vc(None, np.zeros((1, 3, 5, 16, 16),
                                                   np.float32), pe, pmask,
                                    height=16, width=16, num_frames=9,
                                    num_cond_frames=5,
                                    num_inference_steps=1,
                                    enhance_hf=False))
        for call in calls:
            with pytest.raises(NotImplementedError):
                call()


def test_loader_defaults_match_jax(monkeypatch):
    """``load_longcat_pipeline(random_init=True)`` builds the JAX loader's
    reduced configs, and its ``encode_text`` gives the JAX mask (the
    embeddings are hash draws of two generators). The JAX inits are stubbed
    out: only the configs are compared."""
    import dataclasses as dc

    from worldforge_tpu.io import checkpoints as jck
    from worldforge_tpu.models.longcat import dit as jdit
    from worldforge_tpu_torch.io.checkpoints import load_longcat_pipeline
    monkeypatch.setattr(jdit, "init_longcat_dit", lambda key, cfg: {})
    monkeypatch.setattr(jck, "init_wan_vae", lambda key, cfg: {})
    jpipe, jenc = jck.load_longcat_pipeline(None, random_init=True)
    tpipe, tenc = load_longcat_pipeline(random_init=True, device="cpu")
    assert dc.asdict(tpipe.dit_cfg) == dc.asdict(jpipe.dit_cfg)
    assert dc.asdict(tpipe.vae_cfg) == dc.asdict(jpipe.vae_cfg)
    for text in ("", "a street at night", "x" * 4000):
        (te, tm), (je, jm) = tenc(text), jenc(text)
        assert te.shape == je.shape == (1, 512, 4096)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
