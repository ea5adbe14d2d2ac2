"""The port's guided Wan I2V generate against the JAX package's (CPU).

Tiny configs, weights made with the port's init and carried to JAX, fp32
policy, the same numpy noise stream (``noise_fn``) on both sides, guided
with CFG 4.0, IRR (``resample_steps=2``) and the VAE fuse on every step,
DSG, and FLF off (on in ``test_guided_generate_with_flf_matches_jax``).

Two conv modes, as in ``test_torch_vae.py``: 'fp32' runs both VAEs with
fp32 convs and holds the latents to 1e-4 relative (measured 4e-7); 'kernel'
runs the JAX Pallas conv (interpret) against the port's conv3d kernel path,
whose bf16 rounding of the conv inputs flips on last-bit fp32 differences,
and holds the latents at bf16 noise level (measured 7e-4 max relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines.wan_i2v import WanI2VPipeline as JPipe
from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.models.wan import dit as tdit
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.models.wan.vae_stream import vae_decode_streaming
from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline as TPipe
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig as TGuide
from worldforge_tpu_torch.utils.torch_rng import TorchCompatibleRNG

torch.set_num_threads(2)

DIT_KW = dict(model_type="i2v", in_dim=12, out_dim=4, dim=64, ffn_dim=128,
              num_heads=2, num_layers=2, text_len=8, text_dim=32,
              freq_dim=16)
GUIDE = dict(guided=True, guide_steps=4, resample_steps=2,
             resample_round=4, omega=4.0, use_flf=False)
# relative max / relative L2 error of the latents, by conv mode
TOL = {"fp32": (1e-4, 1e-4), "kernel": (1e-2, 5e-3)}


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def pipes():
    tdp = tdit.init_wan_dit(torch.Generator().manual_seed(0),
                            tdit.WanDiTConfig(**DIT_KW), dtype=torch.float32)
    head = tdp["head"]["head"]
    head["w"] = 0.02 * torch.randn(head["w"].shape,
                                   generator=torch.Generator().manual_seed(9))
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    jdp = {k: _to_jax(v) for k, v in tdp.items() if k != "blocks"}
    jdp["blocks"] = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_to_jax(b) for b in tdp["blocks"]])
    tp = TPipe(dit_params=tdp, dit_cfg=tdit.WanDiTConfig(**DIT_KW),
               vae_params=tvp, vae_cfg=tvae.WanVAEConfig.tiny(),
               policy=T_FP32)
    jp_by_mode = {
        mode: JPipe(dit_params=jdp, dit_cfg=jdit.WanDiTConfig(**DIT_KW),
                    vae_params=_to_jax(tvp), vae_cfg=jvae.WanVAEConfig.tiny(),
                    policy=J_FP32)
        for mode in ("fp32", "kernel")}
    return tp, jp_by_mode


def _inputs(frames=5, hw=16):
    rng = np.random.default_rng(2)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        image=f32(rng.uniform(-1, 1, (1, 3, hw, hw))),
        pe=f32(rng.standard_normal((1, 8, 32))),
        ne=f32(rng.standard_normal((1, 8, 32))),
        ie=f32(rng.standard_normal((1, 257, 1280))),
        ref=f32(rng.uniform(0, 1, (1, 3, frames, hw, hw))),
        mask=f32(rng.uniform(0, 1, (1, 1, frames, hw, hw)) > 0.5))


def _noise(seed):
    """A torch.Generator stream as numpy arrays; two calls with one seed
    give the two sides the same noise."""
    rng = TorchCompatibleRNG(seed)
    return lambda shape: rng.randn(*shape)


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.mark.parametrize("mode", ["fp32", "kernel"])
def test_guided_generate_matches_jax(pipes, mode, monkeypatch):
    tp, jp_by_mode = pipes
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d" if mode == "fp32" else "pallas_interpret"
    if mode == "fp32":
        monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    x = _inputs()
    kw = dict(height=16, width=16, num_frames=5, num_inference_steps=4,
              guidance_scale=4.0, output_type="latent")
    try:
        want = np.asarray(jp_by_mode[mode].generate(
            jax.random.key(0), jnp.asarray(x["image"]), jnp.asarray(x["pe"]),
            jnp.asarray(x["ne"]), jnp.asarray(x["ie"]),
            video_ref=jnp.asarray(x["ref"]), mask=jnp.asarray(x["mask"]),
            guidance=JGuide(**GUIDE), noise_fn=_noise(7), **kw))
    finally:
        jvae._CONV3D_MODE = old
    got = tp.generate(None, x["image"], x["pe"], x["ne"], x["ie"],
                      video_ref=x["ref"], mask=x["mask"],
                      guidance=TGuide(**GUIDE), noise_fn=_noise(7),
                      **kw).numpy()
    assert got.shape == want.shape == (1, 4, 2, 2, 2)
    rel_max = np.abs(got - want).max() / np.abs(want).max()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_max < TOL[mode][0] and rel_l2 < TOL[mode][1], (rel_max,
                                                              rel_l2)


def test_generate_pixels_and_unguided(pipes):
    tp, _ = pipes
    x = _inputs()
    gen = torch.Generator().manual_seed(3)
    out = tp.generate(gen, x["image"], x["pe"], x["ne"], x["ie"],
                      height=16, width=16, num_frames=5,
                      num_inference_steps=3, guidance_scale=4.0,
                      guidance=TGuide(guided=False, resample_steps=1))
    assert isinstance(out, np.ndarray) and out.shape == (1, 3, 5, 16, 16)
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1


@pytest.mark.parametrize("what", ["flf", "fused", "streaming"])
def test_later_slices_raise(pipes, what, monkeypatch):
    """'streaming': the streaming VAE and its H-strip tiling are ported:
    ``spatial_chunks=2`` decodes the pipeline's VAE as the untiled
    streaming decode does (1e-5). 'fused': the whole-loop
    runner is ported: ``fused=True`` holds the host loop's latents (fp32
    convs, the same noise stream) at the fp32 gate, and ``exec_chunk=2``
    equals ``fused=True`` bit for bit. 'flf': FLF is ported, and the guided
    generate with the default ``GuidanceConfig()`` (FLF on) runs."""
    tp, _ = pipes
    if what == "streaming":
        z = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, tp.vae_cfg.z_dim, 2, 2, 2)).astype(np.float32))
        whole = vae_decode_streaming(tp.vae_params, tp.vae_cfg, z).numpy()
        tiled = vae_decode_streaming(tp.vae_params, tp.vae_cfg, z,
                                     spatial_chunks=2).numpy()
        assert np.abs(tiled - whole).max() <= 1e-5 * np.abs(whole).max()
        return
    x = _inputs()
    kw = dict(height=16, width=16, num_frames=5, num_inference_steps=2,
              video_ref=x["ref"], mask=x["mask"])
    if what == "flf":
        out = tp.generate(torch.Generator().manual_seed(0), x["image"],
                          x["pe"], x["ne"], x["ie"], guidance=TGuide(), **kw)
        assert out.shape == (1, 3, 5, 16, 16) and np.isfinite(out).all()
        return
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    run = lambda **k: tp.generate(
        None, x["image"], x["pe"], x["ne"], x["ie"], guidance=TGuide(**GUIDE),
        noise_fn=_noise(3), output_type="latent", **kw, **k).numpy()
    loop, fused = run(), run(fused=True)
    rel_max = np.abs(fused - loop).max() / np.abs(loop).max()
    assert rel_max < TOL["fp32"][0], rel_max
    np.testing.assert_array_equal(run(fused=True, exec_chunk=2), fused)


def test_guided_generate_with_flf_matches_jax(pipes, monkeypatch):
    """FLF on (the Wan schedule) through 8 guided steps, with fp32 convs:
    the latents to 1e-4 relative, and the channel sets handed back at every
    step equal to the JAX package's; steps 6 and 7 hand one back."""
    from worldforge_tpu.pipelines import wan_i2v as jwan
    from worldforge_tpu_torch.sampling import guidance as tguidance
    tp, jp_by_mode = pipes
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    sel = {"jax": [], "torch": []}
    for mod, side in ((jwan, "jax"), (tguidance, "torch")):
        def wrapped(pred, ref, step, cfg, _orig=mod.flf_select, _s=side):
            out = _orig(pred, ref, step, cfg)
            sel[_s].append((step, list(out)))
            return out
        monkeypatch.setattr(mod, "flf_select", wrapped)
    x = _inputs(frames=9, hw=64)
    g = dict(GUIDE, guide_steps=8, resample_round=8, use_flf=True)
    kw = dict(height=64, width=64, num_frames=9, num_inference_steps=8,
              guidance_scale=4.0, output_type="latent")
    try:
        want = np.asarray(jp_by_mode["fp32"].generate(
            jax.random.key(0), jnp.asarray(x["image"]), jnp.asarray(x["pe"]),
            jnp.asarray(x["ne"]), jnp.asarray(x["ie"]),
            video_ref=jnp.asarray(x["ref"]), mask=jnp.asarray(x["mask"]),
            guidance=JGuide(**g), noise_fn=_noise(11), **kw))
    finally:
        jvae._CONV3D_MODE = old
    got = tp.generate(None, x["image"], x["pe"], x["ne"], x["ie"],
                      video_ref=x["ref"], mask=x["mask"],
                      guidance=TGuide(**g), noise_fn=_noise(11),
                      **kw).numpy()
    assert got.shape == want.shape == (1, 4, 3, 8, 8)
    rel_max = np.abs(got - want).max() / np.abs(want).max()
    assert rel_max < TOL["fp32"][0], rel_max
    assert sel["torch"] == sel["jax"]
    assert [s for s, _ in sel["torch"]] == list(range(8))
    handed = {s: c for s, c in sel["torch"] if c}
    assert sorted(handed) == [6, 7] and all(len(c) == 1
                                            for c in handed.values())


def test_streaming_vae_generate_matches_single_pass(pipes):
    """The guided generate with the streaming VAE against the single-pass
    VAE: the same per-frame arithmetic, with bf16 rounding flips of the conv
    inputs between the two passes (see ``test_torch_vae_stream.py``, which
    also covers the decoder's ``chunk``); held at 1e-2 relative max."""
    tp, _ = pipes
    x = _inputs(frames=9)
    kw = dict(height=16, width=16, num_frames=9, num_inference_steps=3,
              guidance_scale=4.0, video_ref=x["ref"], mask=x["mask"],
              guidance=TGuide(**GUIDE), output_type="latent")
    args = (None, x["image"], x["pe"], x["ne"], x["ie"])
    want = tp.generate(*args, noise_fn=_noise(3), **kw).numpy()
    tp.streaming_vae = True
    try:
        got = tp.generate(*args, noise_fn=_noise(3), **kw).numpy()
    finally:
        tp.streaming_vae = False
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert got.shape == want.shape == (1, 4, 3, 2, 2) and rel < 1e-2, rel
