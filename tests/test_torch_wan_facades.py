"""The port's Wan facades (t2v, flf2v, VACE) and the flow DPM-Solver++
against the JAX package's, on the CPU.

Tiny configs, fp32 policy on both sides. The DiT and VACE weights come from
the JAX ``init_*`` functions with every all-zero leaf (the biases, the Wan
head, FLF2V's ``emb_pos``, VACE's ``before_proj`` / ``after_proj``) replaced
by seeded random values, so no branch hides behind a zero, and are carried
over by ``io/from_jax.py``. The tiny VAE is made with the port's init and
carried to JAX; both VAEs run fp32 3x3x3 convs (the conv kernel's bf16
input rounding would flip on last-bit differences, see
``test_torch_vae.py``). The JAX pipelines draw their initial latents from
the key; the port's ``noise_fn`` is fed that draw.

Tolerances: DPM tables exact, DPM updates 1e-6 relative; forwards and
generates 1e-4 relative max; ``encode_vace_masks`` exact,
``prepare_vace_context`` 1e-5; the processors' resizes 1e-5 absolute on
[-1, 1] values, their frame ids and sizes equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.io import vace_processor as jvp
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu.models.wan import vace as jvace
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines import wan_t2v as jt2v
from worldforge_tpu.pipelines import wan_vace as jwv
from worldforge_tpu.sampling import dpm as jdpm
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io import vace_processor as tvp
from worldforge_tpu_torch.io.from_jax import (dit_params_from_jax,
                                              vace_params_from_jax)
from worldforge_tpu_torch.models.wan import dit as tdit
from worldforge_tpu_torch.models.wan import vace as tvace
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.pipelines import wan_t2v as tt2v
from worldforge_tpu_torch.pipelines import wan_vace as twv
from worldforge_tpu_torch.sampling import dpm as tdpm

torch.set_num_threads(2)

TOL = 1e-4
Z = 4                                     # the tiny VAE's latent channels
DIT_KW = dict(out_dim=Z, dim=64, ffn_dim=128, num_heads=2, num_layers=2,
              text_len=8, text_dim=32, freq_dim=16, clip_dim=32)
VACE_IN = 2 * Z + 64                      # inactive + reactive + mask
HW, FRAMES = 16, 5                        # 2 x 2 x 2 latents


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
def vae():
    tvp_ = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                             tvae.WanVAEConfig.tiny())
    jvp_ = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tvp_)
    return tvp_, jvp_


def _jax_draw(key_seed):
    """The JAX pipelines' initial draw: normal(split(key)[1], shape)."""
    def draw(shape):
        _, k = jax.random.split(jax.random.key(key_seed))
        return np.asarray(jax.random.normal(k, shape, jnp.float32))
    return draw


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------------ DPM


@pytest.mark.parametrize("n,shift,order,solver,grid", [
    (6, 5.0, 2, "midpoint", None), (6, 3.0, 3, "midpoint", None),
    (20, 5.0, 3, "heun", None), (8, 1.0, 2, "heun", "sampling"),
    (16, 5.0, 3, "midpoint", "sampling"), (4, 5.0, 1, "midpoint", None)])
def test_dpm_tables_and_updates_match_jax(n, shift, order, solver, grid):
    """The host tables exactly, and a run of dpm_update over seeded model
    outputs (orders 1-3 as the warm-up allows) to 1e-6."""
    sig = jdpm.get_sampling_sigmas(n, shift) if grid else None
    np.testing.assert_array_equal(
        tdpm.get_sampling_sigmas(n, shift), jdpm.get_sampling_sigmas(n, shift))
    kw = dict(shift=1.0 if grid else shift, sigmas=sig, solver_order=order,
              solver_type=solver)
    js = jdpm.make_flow_dpm_schedule(n, **kw)
    ts = tdpm.make_flow_dpm_schedule(n, **kw)
    for f in ("sigmas", "timesteps", "order", "c_x", "c_m0", "c_m1",
              "c_m2"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    assert ts.num_steps == js.num_steps
    assert ts.c_m0[-1] == 1.0 and ts.c_x[-1] == 0.0  # the sigma -> 0 limit
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    hj, ht = [], []
    for i in range(ts.num_steps):
        v = rng.standard_normal(x.shape).astype(np.float32)
        hj.insert(0, jdpm.dpm_pred_x0(js, i, jnp.asarray(v), xj))
        ht.insert(0, tdpm.dpm_pred_x0(ts, i, torch.from_numpy(v), xt))
        xj = jdpm.dpm_update(js, i, xj, *hj[:3])
        xt = tdpm.dpm_update(ts, i, xt, *ht[:3])
        assert _rel(xt, xj) < 1e-6, i
    eps = rng.standard_normal(x.shape).astype(np.float32)
    assert _rel(tdpm.dpm_add_noise(ts, 1, xt, torch.from_numpy(eps)),
                jdpm.dpm_add_noise(js, 1, xj, jnp.asarray(eps))) < 1e-6
    assert set(ts.order.tolist()) <= set(range(1, order + 1))


# ------------------------------------------------------------ T2V / FLF2V


def _wan_pair(model_type, seed):
    in_dim = Z if model_type == "t2v" else 4 + 2 * Z
    jcfg = jdit.WanDiTConfig(model_type=model_type, in_dim=in_dim, **DIT_KW)
    tcfg = tdit.WanDiTConfig(model_type=model_type, in_dim=in_dim, **DIT_KW)
    jp = randomize_zero_leaves(jax.tree_util.tree_map(
        np.asarray, jdit.init_wan_dit(jax.random.key(seed, impl="rbg"), jcfg,
                                      dtype=jnp.float32)), seed + 100)
    return jcfg, _jtree(jp), tcfg, dit_params_from_jax(jp)


@pytest.mark.parametrize("model_type", ["t2v", "flf2v"])
def test_t2v_flf2v_generate_matches_jax(vae, fp32_convs, model_type):
    """``WanT2VPipeline.generate`` with CFG 5.0 over 3 UniPC steps; FLF2V
    adds the [first, zeros, last] condition and 2 x 257 CLIP tokens through
    a random ``emb_pos``."""
    tv, jv = vae
    jcfg, jp, tcfg, tp = _wan_pair(model_type, 3)
    if model_type == "flf2v":
        assert float(np.abs(np.asarray(jp["img_emb"]["emb_pos"])).max()) > 0
    cfgv = tvae.WanVAEConfig.tiny()
    jpipe = jt2v.WanT2VPipeline(dit_params=jp, dit_cfg=jcfg, vae_params=jv,
                                vae_cfg=jvae.WanVAEConfig.tiny(),
                                policy=J_FP32)
    tpipe = tt2v.WanT2VPipeline(dit_params=tp, dit_cfg=tcfg, vae_params=tv,
                                vae_cfg=cfgv, policy=T_FP32)
    rng = np.random.default_rng(4)
    f32 = lambda a: a.astype(np.float32)
    pe = f32(rng.standard_normal((1, 8, 32)))
    ne = f32(rng.standard_normal((1, 8, 32)))
    kw = dict(height=HW, width=HW, num_frames=FRAMES, num_inference_steps=3,
              guidance_scale=5.0, output_type="latent")
    if model_type == "flf2v":
        kw.update(first_frame=f32(rng.uniform(-1, 1, (1, 3, HW, HW))),
                  last_frame=f32(rng.uniform(-1, 1, (1, 3, HW, HW))),
                  image_embeds=f32(rng.standard_normal((1, 514, 32))))
    want = jpipe.generate(jax.random.key(2), jnp.asarray(pe), jnp.asarray(ne),
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
    got = tpipe.generate(None, pe, ne, noise_fn=_jax_draw(2), **kw)
    assert _rel(got, want) < TOL
    # the decode: numpy frames in [0, 1]
    kw["output_type"] = "np"
    kw["num_inference_steps"] = 1
    video = tpipe.generate(None, pe, ne, noise_fn=_jax_draw(2), **kw)
    assert video.shape == (1, 3, FRAMES, HW, HW)
    assert video.min() >= 0.0 and video.max() <= 1.0


def test_flf2v_condition_is_the_i2v_layout_with_the_last_frame(vae,
                                                               fp32_convs):
    """The shared ``frame_condition``: frames 0 (x4) and the last latent
    frame's last slot masked; the VAE latents of [first, zeros, last]."""
    from worldforge_tpu_torch.pipelines.wan_i2v import frame_condition
    tv, _ = vae
    rng = np.random.default_rng(5)
    first = torch.from_numpy(rng.uniform(-1, 1, (1, 3, HW, HW)).astype(
        np.float32))
    last = torch.from_numpy(rng.uniform(-1, 1, (1, 3, HW, HW)).astype(
        np.float32))
    enc = lambda v: tvae.vae_encode(tv, tvae.WanVAEConfig.tiny(), v)
    cond = frame_condition(enc, first, last, FRAMES, 2, 2, 4)
    assert cond.shape == (1, 4 + Z, 2, 2, 2)
    mask = cond[:, :4].numpy()
    np.testing.assert_array_equal(mask[0, :, 0], 1.0)
    np.testing.assert_array_equal(mask[0, :3, 1], 0.0)
    np.testing.assert_array_equal(mask[0, 3, 1], 1.0)
    video = torch.cat([first[:, :, None], torch.zeros(1, 3, FRAMES - 2, HW,
                                                      HW), last[:, :, None]],
                      dim=2)
    np.testing.assert_array_equal(cond[:, 4:].numpy(), enc(video).numpy())
    i2v = frame_condition(enc, first, None, FRAMES, 2, 2, 4)
    np.testing.assert_array_equal(i2v[0, :4, 1].numpy(), 0.0)


# ------------------------------------------------------------------ VACE


@pytest.fixture(scope="module")
def vace_pair():
    jcfg = jvace.VaceConfig(
        base=jdit.WanDiTConfig(model_type="t2v", in_dim=Z, **DIT_KW),
        vace_layers=(0, 1), vace_in_dim=VACE_IN)
    tcfg = tvace.VaceConfig(
        base=tdit.WanDiTConfig(model_type="t2v", in_dim=Z, **DIT_KW),
        vace_layers=(0, 1), vace_in_dim=VACE_IN)
    jp = randomize_zero_leaves(jax.tree_util.tree_map(
        np.asarray, jvace.init_vace(jax.random.key(7, impl="rbg"), jcfg,
                                    dtype=jnp.float32)), 11)
    return jcfg, _jtree(jp), tcfg, vace_params_from_jax(jp)


def test_vace_forward_matches_jax_with_live_hints(vace_pair):
    """``vace_forward`` at ``vace_context_scale`` 0.7 to 1e-4; the
    randomised before/after_proj make the hints move the output."""
    jcfg, jp, tcfg, tp = vace_pair
    for blk in tp["vace_blocks"]:
        assert blk["after_proj"]["w"].abs().max() > 0
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, Z, 2, 4, 4)).astype(np.float32)
    vc = rng.standard_normal((1, VACE_IN, 2, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    t = np.array([700.0], np.float32)
    want = jax.jit(lambda *a: jvace.vace_forward(
        jp, jcfg, *a, vace_context_scale=0.7, policy=J_FP32))(
        *map(jnp.asarray, (x, t, vc, ctx)))
    args = [torch.from_numpy(a) for a in (x, t, vc, ctx)]
    got = tvace.vace_forward(tp, tcfg, *args, vace_context_scale=0.7,
                             policy=T_FP32)
    assert _rel(got, want) < TOL
    off = tvace.vace_forward(tp, tcfg, *args, vace_context_scale=0.0,
                             policy=T_FP32)
    assert _rel(off, want) > 1e-2


def test_encode_vace_masks_and_context_with_refs_match_jax(vae, fp32_convs):
    """The 8 x 8 shuffle and the nearest temporal resize exactly (T = 9 ->
    3 frames), the context with two reference images to 1e-5 (T = 5,
    truncated to the latent count); no mask is an all-ones mask."""
    tv, jv = vae
    rng = np.random.default_rng(9)
    m9 = (rng.random((1, 1, 9, HW, HW)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        twv.encode_vace_masks(torch.from_numpy(m9)).numpy(),
        np.asarray(jwv.encode_vace_masks(jnp.asarray(m9))))
    m = m9[:, :, :FRAMES]
    frames = rng.uniform(-1, 1, (1, 3, FRAMES, HW, HW)).astype(np.float32)
    refs = [rng.uniform(-1, 1, (1, 3, 1, HW, HW)).astype(np.float32)
            for _ in range(2)]
    want = jax.jit(lambda f, mk, r0, r1: jwv.prepare_vace_context(
        f, mk, jv, jvae.WanVAEConfig.tiny(), ref_images=[r0, r1]))(
        jnp.asarray(frames), jnp.asarray(m), *map(jnp.asarray, refs))
    got = twv.prepare_vace_context(
        torch.from_numpy(frames), torch.from_numpy(m), tv,
        tvae.WanVAEConfig.tiny(),
        ref_images=[torch.from_numpy(r) for r in refs])
    assert got.shape == (1, VACE_IN, 2 + 2, 2, 2)
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(got[:, Z:, :2].numpy(), 0.0)
    ctx = lambda mask: twv.prepare_vace_context(
        torch.from_numpy(frames), mask, tv, tvae.WanVAEConfig.tiny())
    np.testing.assert_array_equal(
        ctx(None).numpy(), ctx(torch.ones((1, 1, FRAMES, HW, HW))).numpy())


def test_vace_generate_matches_jax(vace_pair, vae, fp32_convs, monkeypatch):
    """``WanVacePipeline.generate`` with CFG over 2 steps and
    ``context_scale`` 0.8; the JAX pipeline's forward runs under the fp32
    policy here."""
    jcfg, jp, tcfg, tp = vace_pair
    tv, jv = vae
    monkeypatch.setattr(jwv, "vace_forward",
                        functools.partial(jvace.vace_forward,
                                          policy=J_FP32))
    rng = np.random.default_rng(10)
    src = rng.uniform(-1, 1, (1, 3, FRAMES, HW, HW)).astype(np.float32)
    mask = np.zeros((1, 1, FRAMES, HW, HW), np.float32)
    mask[..., HW // 2:] = 1.0
    pe = rng.standard_normal((1, 8, 32)).astype(np.float32)
    ne = rng.standard_normal((1, 8, 32)).astype(np.float32)
    jpipe = jwv.WanVacePipeline(vace_params=jp, vace_cfg=jcfg, vae_params=jv,
                                vae_cfg=jvae.WanVAEConfig.tiny())
    tpipe = twv.WanVacePipeline(vace_params=tp, vace_cfg=tcfg, vae_params=tv,
                                vae_cfg=tvae.WanVAEConfig.tiny(),
                                policy=T_FP32)
    kw = dict(num_inference_steps=2, guidance_scale=4.0, context_scale=0.8,
              output_type="latent")
    want = jpipe.generate(jax.random.key(3), jnp.asarray(src),
                          jnp.asarray(mask), jnp.asarray(pe),
                          jnp.asarray(ne), **kw)
    got = tpipe.generate(None, src, mask, pe, ne, noise_fn=_jax_draw(3),
                         **kw)
    assert _rel(got, want) < TOL


# ------------------------------------------------------------ processors


def _video(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


def test_vace_image_processor_matches_jax():
    img = _video(1, 36, 50, 0)[0]
    img2 = _video(1, 36, 50, 1)[0]
    jproc, tproc = jvp.VaceImageProcessor(seq_len=12), \
        tvp.VaceImageProcessor(seq_len=12)
    assert tproc.output_size(36, 50) == jproc.output_size(36, 50)
    *jo, jsize = jproc.load_image_batch(img, img2)
    *to, tsize = tproc.load_image_batch(img, img2)
    assert tsize == jsize and tsize != (36, 50)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("keep_last,zero_start", [(True, True),
                                                  (False, True),
                                                  (False, False)])
def test_vace_video_processor_matches_jax(keep_last, zero_start):
    """Both frame-id samplers (the random start through the numpy RNG), the
    sizing and the antialiased cubic resize + crop of a video and its
    mask."""
    video = _video(40, 30, 44, 2)
    mask = (_video(40, 30, 44, 3) > 127).astype(np.uint8) * 255
    kw = dict(seq_len=60, max_area=24 * 32, keep_last=keep_last,
              zero_start=zero_start, max_fps=8.0)
    jv, tv_ = jvp.VaceVideoProcessor(**kw), tvp.VaceVideoProcessor(**kw)
    jo = jv.load_video_pair(video, mask, fps=16.0, seed=5)
    to = tv_.load_video_pair(video, mask, fps=16.0, seed=5)
    assert to[2:] == jo[2:]                  # ids, size, fps
    assert to[0].shape[1] == len(to[2]) > 1
    for a, b in zip(to[:2], jo[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_prepare_source_matches_jax():
    """Empty slots filled; reference images letterboxed (bilinear, a
    shrink and an enlargement) onto the white canvas; one already at the
    size kept."""
    rng = np.random.default_rng(6)
    refs = [rng.uniform(-1, 1, s).astype(np.float32)
            for s in ((3, 1, 40, 20), (3, 1, 6, 9), (3, 1, 16, 24))]
    out_t = tvp.prepare_source([None], [None],
                               [[torch.from_numpy(r) for r in refs]], 5,
                               (16, 24))
    out_j = jvp.prepare_source([None], [None],
                               [[jnp.asarray(r) for r in refs]], 5, (16, 24))
    for got, want in zip(out_t, out_j):
        for g, w in zip(got, want):
            gs = g if isinstance(g, list) else [g]
            ws = w if isinstance(w, list) else [w]
            for a, b in zip(gs, ws):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5)
    assert out_t[2][0][0][:, 0, :, :4].eq(1.0).all()   # the white margin
