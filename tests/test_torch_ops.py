"""The port's ops against the JAX package's, on the CPU.

Each CUDA/Triton kernel of ``worldforge_tpu_torch`` has a plain PyTorch
version that the wrapper takes for CPU tensors; here it meets the Pallas
kernel it replaces, run in interpret mode as the JAX package's own tests run
it. Inputs come from a seeded numpy generator and go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core import params as JP
from worldforge_tpu.ops import conv3d as jconv
from worldforge_tpu.ops import flash_attention as jfa
from worldforge_tpu.ops import fused_norm as jnorm
from worldforge_tpu.ops import rope as jrope
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.io.from_jax import tensor_from_numpy
from worldforge_tpu_torch.ops import attention as tattn
from worldforge_tpu_torch.ops import conv3d as tconv
from worldforge_tpu_torch.ops import flash_attention as tfa
from worldforge_tpu_torch.ops import fused_norm as tnorm
from worldforge_tpu_torch.ops import rope as trope
from worldforge_tpu_torch.sampling.guidance import resize_video_like

torch.set_num_threads(2)


def _qkv(rng, b, sq, sk, h, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]


# ------------------------------------------------------------ kernel 1


@pytest.mark.parametrize("b,sq,sk,h,d,kv_lens", [
    (2, 130, 200, 2, 64, None),        # d = 64 (tiny / random-init DiT)
    (2, 96, 300, 2, 64, [0, 170]),     # a row with kv_len = 0
    (1, 70, 90, 1, 384, None),         # fp32 single head, the VAE's d
    (2, 130, 200, 1, 512, None),       # the SVD VAE's single head of 512
    (2, 130, 200, 1, 512, [200, 77]),
])
def test_flash_attention_matches_pallas(rng, b, sq, sk, h, d, kv_lens):
    """fp32 inputs: both sides compute fp32 scores and an fp32 P.V, so the
    only difference is the order of the sums (1e-5)."""
    q, k, v = _qkv(rng, b, sq, sk, h, d)
    jl = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tl = None if kv_lens is None else torch.tensor(kv_lens)
    want, wm, wl = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jl,
        interpret=True, return_lse=True)
    got, gm, gl = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lens=tl, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4,
                               rtol=1e-5)
    if kv_lens is not None and 0 in kv_lens:
        row = kv_lens.index(0)
        assert not got[row].any()      # kv_len = 0 gives zeros, as Pallas
        assert not np.asarray(want)[row].any()


def test_flash_attention_bf16_matches_pallas(rng):
    """bf16 inputs: both round P to bf16 before P.V; the JAX kernel keeps
    its accumulator normalised step by step, the port divides once at the
    end, so the bf16 outputs differ by about one bf16 ulp (4e-3 of 1)."""
    q, k, v = _qkv(rng, 1, 128, 256, 2, 128)
    to_j = lambda a: jnp.asarray(a, jnp.bfloat16)
    to_t = lambda a: torch.from_numpy(a).bfloat16()
    want = jfa.flash_attention(to_j(q), to_j(k), to_j(v), interpret=True)
    got = tfa.flash_attention(to_t(q), to_t(k), to_t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2,
                               rtol=1e-2)


def test_kv_len_zero_differs_from_sdpa_reference(rng):
    """Pinned departure: ``sdpa_reference`` (both packages) gives the mean
    of V for a row whose keys are all masked; the kernel gives zeros, and
    the port follows the kernel."""
    q, k, v = _qkv(rng, 1, 8, 16, 1, 64)
    lens = torch.tensor([0])
    ref = tattn.sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_lens=lens)
    jref = np.asarray(jattn_ref(q, k, v, [0]))
    np.testing.assert_allclose(ref.numpy(), jref, atol=1e-6)
    np.testing.assert_allclose(ref.numpy()[0, 0], v[0].mean(0), atol=1e-5)
    out = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), kv_lens=lens)
    assert not out.any()


def jattn_ref(q, k, v, lens):
    from worldforge_tpu.ops.attention import sdpa_reference
    return sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kv_lens=jnp.asarray(lens, jnp.int32))


# ------------------------------------------------------------ kernel 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_qk_matches_pallas(rng, dtype):
    """The Pallas kernel (interpret) is bitwise-equal to apply_rope; the
    port's plain version computes the same fp32 products and sums, so fp32
    agrees to rounding of the fused multiply-adds (1e-6) and bf16 to one
    bf16 ulp."""
    f, h, w, d, nh = 2, 8, 13, 128, 8       # s = 208 -> the kernel tiles
    s = f * h * w
    q = rng.standard_normal((1, s, nh, d)).astype(np.float32)
    k = rng.standard_normal((1, s, nh, d)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(f, h, w, d)
    tc, ts = trope.rope_cos_sin(f, h, w, d)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    wq, wk = jrope.apply_rope_qk(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                 jc, js, interpret=True)
    gq, gk = trope.apply_rope_qk(torch.from_numpy(q).to(tdt),
                                 torch.from_numpy(k).to(tdt), tc, ts)
    assert gq.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 8e-3
    for g, wnt in ((gq, wq), (gk, wk)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype,b", [("float32", 1), ("bfloat16", 2)])
def test_rope_qk_matches_pallas_d64_h12(rng, dtype, b):
    """The Pallas kernel itself in interpret mode (its wrapper takes it only
    for h % 8 == 0 and d % 128 == 0, so it is called directly, 4 heads and
    37 tokens a block) at D = 64, 12 heads and 333 tokens: the port's
    kernel runs these as a ragged last head group and a ragged last token
    run. Tolerances as in test_rope_qk_matches_pallas."""
    f, h, w, d, nh = 3, 3, 37, 64, 12
    s = f * h * w
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    k = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(f, h, w, d)
    tc, ts = trope.rope_cos_sin(f, h, w, d)
    cf = jnp.repeat(jc, 2, axis=-1)
    sf = jnp.repeat(js, 2, axis=-1) * jnp.tile(
        jnp.asarray([-1.0, 1.0], jc.dtype), d // 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    wq, wk = jrope._rope_qk_pallas(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), cf, sf, out_dtype=jdt,
        block_s=37, block_h=4, interpret=True)
    gq, gk = trope.apply_rope_qk(torch.from_numpy(q).to(tdt),
                                 torch.from_numpy(k).to(tdt), tc, ts)
    assert gq.shape == (b, s, nh, d) and gq.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 8e-3
    for g, wnt in ((gq, wq), (gk, wk)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wnt, np.float32), atol=tol,
                                   rtol=tol)


def test_rope_angles_and_split_match(rng):
    for d in (64, 128):
        assert trope.rope_3d_split(d) == jrope.rope_3d_split(d)
    np.testing.assert_array_equal(
        trope.rope_3d_angles(3, 4, 5, 64, t_positions=(4, 0, 1)),
        jrope.rope_3d_angles(3, 4, 5, 64, t_positions=(4, 0, 1)))


# ------------------------------------------------------------ kernel 3


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_modulated_layer_norm_matches_pallas(rng, out_dtype):
    """Same fp32 op sequence on both sides; the sums run in another order,
    so fp32 agrees to 1e-5 and bf16 to one bf16 ulp."""
    b, s, d = 2, 264, 256
    x = (rng.standard_normal((b, s, d)) * 3 + 1).astype(np.float32)
    sc = rng.standard_normal((b, 1, d)).astype(np.float32)
    sh = rng.standard_normal((b, 1, d)).astype(np.float32)
    want = jnorm.modulated_layer_norm(
        jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh),
        out_dtype=getattr(jnp, out_dtype), interpret=True)
    got = tnorm.modulated_layer_norm(
        torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(sh),
        out_dtype=getattr(torch, out_dtype))
    tol = 1e-5 if out_dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ kernel 4


@pytest.mark.parametrize("t,hh,ww,cin,cout", [
    (3, 8, 16, 3, 16),      # Cin = 3, the encoder's conv_in
    (2, 8, 16, 16, 24),     # Cin not divisible by 128 (the im2col path)
    (1, 4, 8, 128, 8),      # Cin divisible by 128 (the per-tap path)
    (2, 6, 10, 8, 3),       # W not divisible by 8; Cout = 3 (conv_out)
    (1, 13, 19, 3, 32),     # Tp = 3; ragged H and W (the kernel's 8 x 32)
    (1, 5, 7, 16, 3),       # Tp = 3; a tile larger than the image
    (2, 13, 35, 24, 16),    # W one pixel past a 32-pixel tile
])
def test_conv3d_causal_matches_pallas(rng, t, hh, ww, cin, cout):
    """Both round inputs and weights to bf16 and sum exact products in fp32
    (1e-5 relative: the order of the sums)."""
    x = rng.standard_normal((1, t + 2, hh, ww, cin)).astype(np.float32)
    p = JP.conv_init(jax.random.key(3), cin, cout, (3, 3, 3))
    p["b"] = jnp.asarray(rng.standard_normal(cout), jnp.float32)
    want = np.asarray(jconv.conv3d_causal_pallas(
        jnp.asarray(x), p["w"], p["b"], interpret=True))
    got = tconv.conv3d_causal(torch.from_numpy(x),
                              tensor_from_numpy(p["w"]),
                              tensor_from_numpy(p["b"])).numpy()
    assert got.shape == want.shape == (1, t, hh, ww, cout)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_conv3d_weight_layout_for_the_kernel(rng):
    """The kernel stages weights as bf16 [27, Cin16, Cout16], zero-padded;
    for Cin <= 8 (the fold route) as [28, 8, Cout16]: 8 channels a tap and
    a last zero tap, so that two taps fill a k16 step; a one-tap weight as
    [10, 8, Cout16] at Cin <= 4 and Cout <= 128, else [9, Cin16, Cout16]."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 5)).astype(
        np.float32))
    wp = tconv.prepare_weight(w)
    assert wp.shape == (28, 8, 16) and wp.dtype == torch.bfloat16
    torch.testing.assert_close(wp[:27, :3, :5].float(),
                               w.reshape(27, 3, 5).bfloat16().float())
    assert not wp[:, 3:].any() and not wp[:, :, 5:].any()
    assert not wp[27].any()
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 9, 5)).astype(
        np.float32))
    wp = tconv.prepare_weight(w)
    assert wp.shape == (27, 16, 16)
    torch.testing.assert_close(wp[:, :9, :5].float(),
                               w.reshape(27, 9, 5).bfloat16().float())
    assert not wp[:, 9:].any() and not wp[:, :, 5:].any()
    assert tconv.prepare_weight(w[0, :, :, :6]).shape == (9, 16, 16)
    assert tconv.prepare_weight(w[0, :, :, :3]).shape == (10, 8, 16)


@pytest.mark.parametrize("x_dtype,out_dtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_conv3d_causal_dtypes_match_pallas(rng, x_dtype, out_dtype):
    """The kernel reads x in its own type and writes ``out_dtype``; both
    sides round x to bf16 and sum in fp32, so an fp32 output agrees to the
    order of the sums (1e-5) and a bf16 one to one bf16 ulp (2^-8 of the
    largest value)."""
    t, hh, ww, cin, cout = 1, 9, 13, 16, 32
    x = rng.standard_normal((1, t + 2, hh, ww, cin)).astype(np.float32)
    p = JP.conv_init(jax.random.key(4), cin, cout, (3, 3, 3))
    p["b"] = jnp.asarray(rng.standard_normal(cout), jnp.float32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    want = np.asarray(jconv.conv3d_causal_pallas(
        jx, p["w"], p["b"], out_dtype=getattr(jnp, out_dtype),
        interpret=True), np.float32)
    got = tconv.conv3d_causal(
        torch.from_numpy(x).to(getattr(torch, x_dtype)),
        tensor_from_numpy(p["w"]), tensor_from_numpy(p["b"]),
        out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < (1e-5 if out_dtype == "float32" else 2.0 ** -8), rel


# Every 3x3x3 conv shape of the Wan2.1 VAE (Cin -> Cout; per single-pass
# encode / decode at 17 frames: 1/0, 4/6, 1/0, 3/6, 1/1, 11/15, 1/0, 0/1,
# 0/1), as its config builds them.
VAE_CONV_SHAPES = [(3, 96), (96, 96), (96, 192), (192, 192), (192, 384),
                   (384, 384), (384, 32), (16, 384), (96, 3)]
# Every (Cin, Cout) of kernel 4's one-tap instantiation in the DepthCrafter
# stage (``chip_smoke.py::DC_CONV2D``): the SVD UNet's 3x3 convs at its four
# levels (320, 640, 1280, 1280 channels; the skip concatenations' Cin) and
# the SVD VAE's at 128 / 256 / 512 channels.
DC_CONV2D_PAIRS = [(320, 320), (8, 320), (640, 320), (960, 320), (640, 640),
                   (320, 4), (320, 640), (960, 640), (1280, 640),
                   (1920, 640), (1280, 1280), (640, 1280), (1920, 1280),
                   (2560, 1280), (3, 128), (128, 128), (256, 128),
                   (256, 256), (128, 3), (128, 256), (512, 256), (512, 512),
                   (256, 512), (512, 8), (4, 512)]
# (frames, H, W) the port gives kernel 4: the Wan2.1 VAE at 17 x 480 x 832
# and its levels, the SVD UNet's four levels on a 24-frame window of 64 x
# 104 latents, the depth tools' 320 x 512 levels on the published 110-frame
# window, the 1024 x 1024 forward's on 8 frames, and ragged sizes
PORT_SIZES = [(17, 480, 832), (9, 240, 416), (5, 120, 208), (5, 60, 104),
              (24, 64, 104), (24, 32, 52), (24, 16, 26), (24, 8, 13),
              (110, 40, 64), (110, 20, 32), (110, 10, 16), (110, 5, 8),
              (8, 128, 128), (8, 64, 64), (8, 32, 32), (8, 16, 16)]
RAGGED_SIZES = [(3, 7, 7), (2, 13, 13), (1, 103, 103), (5, 13, 103),
                (4, 103, 7), (25, 7, 13)]


def _plan(cin, cout, taps=1, frames=1, h=8, w=32, batch=1,
          dtype=torch.float32):
    return tconv.conv_plan(cin, cout, dtype, taps=taps, batch=batch,
                           frames=frames, height=h, width=w)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", VAE_CONV_SHAPES + DC_CONV2D_PAIRS)
def test_conv3d_plan_fits_the_kernel(cin, cout, x_dtype):
    """The plan the kernel launches (``csrc/conv3d_plan.cuh``, read through
    the host library): the route from the taps, Cin and Cout (the fold for
    Cin <= 8 at three taps and Cin <= 4 into one slice at one, the walk for
    Cout <= 8 and Cin <= 112 at three, else the tile route), N slices
    that divide the padded Cout (the whole Cout where it is one of the
    kernel's widths, 160 for a multiple of 160 on the 8 x 32 box), a Cin
    chunk that divides the padded Cin, 2 to 4 stages, x by TMA unless its
    rows are no multiple of 16 bytes, fp32 x through one or two fp32
    staging buffers, and shared memory that holds the ring, the staging,
    the resident weights or the epilogue's tile within 227 KB."""
    dtype = getattr(torch, x_dtype)
    for taps in (3, 1):
        p = _plan(cin, cout, taps=taps, dtype=dtype)
        cout_p = -(-cout // 16) * 16
        route = ("fold" if cin <= 8 and (taps == 3 or cin <= 4 and
                                          cout_p <= 128) else
                 "walk" if taps == 3 and cout <= 8 and
                 -(-cin // 16) * 16 <= 112 else "tile")
        assert p.route_name == route
        assert p.cout_p % 16 == 0 and p.cout_p - cout < 16
        assert p.n in (16, 32, 96, 128, 160) and p.n * p.nslices == p.cout_p
        assert p.smem_bytes <= p.smem_limit == 232448
        assert 2 <= p.stages <= 4 or (route == "fold" and 4 <= p.stages <= 8)
        assert p.weight_bytes == p.taps_k * p.cin_p * p.n * 2 or (
            route == "tile" and p.weight_bytes == 9 * p.ck * p.n * 2)
        if route == "fold":
            assert (p.cin_p, p.ck, p.taps_k, p.ksteps) == (
                8, 8, 9 * taps + 1, (9 * taps + 1) // 2)
            assert p.manual and p.staging == 0 and p.epilogue_bytes == 0
            assert p.stage_bytes >= p.slab_pix * 16
            assert p.smem_bytes == (1024 + -(-p.weight_bytes // 1024) * 1024
                                    + p.stages * p.stage_bytes
                                    + 8 * (2 * p.stages + 1))
            continue
        assert p.cin_p % 16 == 0 and p.cin_p - cin < 16
        assert p.ck in (16, 32) and p.cin_p % p.ck == 0
        assert p.taps_k == 9 * taps and p.ksteps == p.ck // 16 * 9
        assert p.manual == (cin * dtype.itemsize % 16 != 0)
        fp32_tma = x_dtype == "float32" and not p.manual
        assert (p.staging in (1, 2)) if fp32_tma else p.staging == 0
        assert p.stage_bytes % 1024 == 0 and p.staging_bytes % 1024 == 0
        assert p.staging_bytes >= p.slab_pix * p.ck * 4
        if route == "walk":
            assert (p.n, p.nslices, p.epilogue_bytes) == (16, 1, 0)
            assert p.stage_bytes >= p.slab_pix * p.ck * 2
            assert p.smem_bytes == (1024 + -(-p.weight_bytes // 1024) * 1024
                                    + p.stages * p.stage_bytes
                                    + p.staging * p.staging_bytes
                                    + 8 * (2 * p.stages + p.staging + 1))
            continue
        # 128 for 160 only where both divide Cout (the wave model)
        assert p.n in ((160, 128) if p.cout_p % 640 == 0 else (160,)) \
            if p.cout_p % 160 == 0 else p.n <= 128
        assert p.n % (p.swizzle_bytes // 2) == 0
        assert p.stage_bytes >= 9 * p.ck * p.n * 2 + p.slab_pix * p.ck * 2
        assert p.smem_bytes == 1024 + max(
            p.stages * p.stage_bytes + p.staging * p.staging_bytes,
            p.epilogue_bytes) + 8 * (2 * p.stages + p.staging)
        assert _plan(cin, cout, taps=taps, dtype=dtype) == p


def test_conv3d_plan_main_shapes():
    """Pinned plans: 96 -> 96 on fp32 x runs whole (N 96, 64-byte swizzle)
    with two 32-channel stages and one fp32 staging buffer; 384 -> 384 as
    three 128-wide slices (128-byte swizzle), three 16-channel stages and
    two staging buffers on fp32 x, two 32-channel stages on bf16 x, all on
    the 8 x 32 box; conv_in (Cin 3) on the fold (28 taps of 8 channels, 14
    k16 steps, a ring of eight input-frame slabs), conv_out (Cout 3) on
    the walk (the whole weight resident, one output-frame run a block)."""
    full = dict(taps=3, frames=17, h=480, w=832)
    p = _plan(96, 96, **full)
    assert (p.route_name, p.n, p.nslices, p.ck, p.stages, p.staging,
            p.swizzle_bytes, p.manual, p.smem_bytes) == (
        "tile", 96, 1, 32, 2, 1, 64, False, 200744)
    assert (p.box_f, p.box_r, p.box_w, p.blocks) == (1, 8, 32, 17 * 60 * 26)
    p = _plan(384, 384, taps=3)
    assert (p.n, p.nslices, p.ck, p.stages, p.staging, p.swizzle_bytes,
            p.smem_bytes) == (128, 3, 16, 3, 2, 128, 190528)
    p = _plan(384, 384, taps=3, dtype=torch.bfloat16)
    assert (p.ck, p.stages, p.staging, p.smem_bytes) == (32, 2, 0, 193568)
    p = _plan(3, 96, **full)
    assert (p.route_name, p.cin_p, p.ck, p.taps_k, p.ksteps, p.stages,
            p.staging, p.manual, p.walk, p.blocks, p.smem_bytes) == (
        "fold", 8, 8, 28, 14, 8, 0, True, 17, 60 * 26, 93320)
    p = _plan(96, 3, **full)
    assert (p.route_name, p.n, p.ck, p.stages, p.staging, p.walk, p.blocks,
            p.weight_bytes, p.smem_bytes) == (
        "walk", 16, 32, 2, 2, 17, 60 * 26, 27 * 96 * 16 * 2, 217144)
    assert tconv.conv_plan(96, 96, x_aligned=False).manual
    # the SVD UNet's 320 -> 320 as two slices of 160 (64-byte swizzle),
    # three 16-channel stages and two staging buffers on fp32 x, at any
    # launch size; 1280 at the UNet's 8 x 13 level as ten slices of 128 over
    # boxes of two whole frames (one wave of 120 blocks)
    for frames, h in ((1, 8), (24, 64)):
        p = _plan(320, 320, frames=frames, h=h, w=128)
        assert (p.n, p.nslices, p.ck, p.stages, p.staging, p.swizzle_bytes,
                p.smem_bytes) == (160, 2, 16, 3, 2, 64, 218176)
    p = _plan(1280, 1280, frames=24, h=32, w=52)
    q = _plan(1280, 1280, frames=24, h=8, w=13)
    assert (p.n, p.nslices, q.n, q.nslices) == (160, 8, 128, 10)
    assert (q.box_f, q.box_r, q.box_w, q.blocks) == (2, 8, 13, 120)
    # one tap: the chunk is the launch's own (32 fits beside the two-frame
    # box's 300-pixel slab at N 128); both orders of the sums are one
    assert (p.ck, q.ck, q.stages, q.staging) == (16, 32, 2, 1)


# (CoutP, frames, H, W, N): the wave model's choice at the SVD UNet's 3x3
# convs on a 24-frame window of 64 x 104 latents (its four levels), the SVD
# VAE's on 8-frame chunks at 512 x 832, and the Wan2.1 VAE's (also on a
# 17-row strip, which must keep the whole frame's N); on the H100 each is
# the fastest slice width measured there
WAVE_CHOICES = [(320, 24, 64, 104, 160), (640, 24, 64, 104, 160),
                (640, 24, 32, 52, 160), (1280, 24, 32, 52, 160),
                (1280, 24, 16, 26, 160), (1280, 24, 8, 13, 128),
                (128, 8, 512, 832, 128), (256, 8, 256, 416, 128),
                (512, 8, 64, 104, 128), (96, 17, 480, 832, 96),
                (192, 9, 120, 208, 96), (384, 5, 60, 104, 128),
                (384, 1, 17, 104, 128), (192, 1, 17, 208, 96),
                (320, 1, 13, 103, 160), (16, 8, 64, 104, 16)]


@pytest.mark.parametrize("cout_p,frames,h,w,n", WAVE_CHOICES)
def test_conv3d_slice_width_by_waves(cout_p, frames, h, w, n):
    """With the launch's blocks the plan takes 160 or 128, where Cout is a
    multiple of both, by the fewest waves of one block an SM, each as long
    as N + 80 columns: 160 except where 8 slices of 160 leave the wave
    emptier than 10 of 128 (the UNet's 8 x 13 level); every other width,
    the VAE's on strips too, is the widest that divides Cout. At three taps
    the channel chunk is the widest N's either way, so the sums keep their
    order."""
    p = _plan(320, cout_p, frames=frames, h=h, w=w)
    assert p.n == n
    assert p.nslices * p.n == cout_p
    widest = next(s for s in (160, 128, 96, 32, 16)
                  if s <= cout_p and cout_p % s == 0)
    assert n == widest or (widest, n) == (160, 128)
    assert p.blocks == p.nslices * p.tiles_f * p.tiles_h * p.tiles_w
    # at three taps the chunk (which orders the sums) follows no launch size
    ck = {_plan(320, cout_p, taps=3, frames=many, h=h, w=w).ck
          for many in (1, 24, 1000)}
    assert len(ck) == 1


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", VAE_CONV_SHAPES + DC_CONV2D_PAIRS)
def test_conv3d_plan_off_160_is_the_narrower_sets(cin, cout, x_dtype):
    """Where the padded Cout is no multiple of 160, N is the widest of 128,
    96, 32, 16 that divides it at every launch size; a shape no route takes
    (a temporal tap count other than 1 or 3, an empty input) raises."""
    dtype = getattr(torch, x_dtype)
    cout_p = -(-cout // 16) * 16
    narrow = next(s for s in (128, 96, 32, 16) if cout_p % s == 0)
    if cout_p % 160:
        for frames, h, w in ((24, 64, 104), (8, 13, 103), (1, 17, 208),
                             (24, 8, 13)):
            p = _plan(cin, cout, frames=frames, h=h, w=w, dtype=dtype)
            assert p.route_name == "walk" or p.n == narrow
    for bad in (dict(taps=2), dict(frames=0), dict(h=0)):
        with pytest.raises(ValueError, match="no plan"):
            _plan(cin, cout, dtype=dtype, **bad)


def _writes(p, batch, frames, h, w):
    """A pure-Python model of the kernel's map from (block, M row) to
    output pixel (``csrc/conv3d.cu``: ``tile_block``, ``walk_block``,
    ``fold_block``), for one N slice: how many times each output pixel
    [batch, frames, h, w] is written, and the real rows' share of all the
    M rows the launch computes."""
    tile = p.route_name == "tile"
    run = p.box_f if tile else p.walk
    slices = p.nslices if p.route_name == "fold" or tile else 1
    idx = np.arange(0, p.blocks, slices) // slices      # slice 0's blocks
    bf, t = idx % (batch * p.tiles_f), idx // (batch * p.tiles_f)
    b, t0 = bf // p.tiles_f, (bf % p.tiles_f) * run
    x0, y0 = (t % p.tiles_w) * p.box_w, (t // p.tiles_w) * p.box_r
    m = np.arange(256)
    plane = p.box_r * p.box_w
    f, dy, dx = m // plane, m % plane // p.box_w, m % p.box_w
    real = m < (p.box_f if tile else 1) * plane
    count = np.zeros((batch, frames, h, w), np.int64)
    rows = 0
    for k in range(1 if tile else run):
        # the frame of each (block, row): the box's frames (tile) or the
        # walk's k-th output frame, where the run has one
        tt = t0[:, None] + (f[None, :] if tile else k)
        if not tile:
            live = (t0 + k < frames) | (k == 0)
            tt, bb = tt[live], b[live]
            yy, xx = y0[live, None] + dy, x0[live, None] + dx
        else:
            bb, yy, xx = b, y0[:, None] + dy, x0[:, None] + dx
        ok = real[None, :] & (tt < frames) & (yy < h) & (xx < w)
        tt, bb = (np.broadcast_to(a, ok.shape) for a in (tt, bb[:, None]))
        np.add.at(count, (bb[ok], tt[ok], yy[ok], xx[ok]), 1)
        rows += ok.shape[0] * 256
    return count, count.sum() / rows


@pytest.mark.parametrize("frames,h,w", PORT_SIZES + RAGGED_SIZES)
def test_conv3d_routes_cover_every_pixel_once(frames, h, w):
    """Each route's blocks, through the kernel's map of M rows to pixels,
    write every output pixel exactly once, at every width the port runs and
    at ragged sizes, with batch 2; at the port's sizes at least 80% of the
    M rows a launch computes are real pixels where the K loop is long (the
    SVD UNet's 8 x 13 level: 41% on the 8 x 32 box; short K loops keep the
    8 x 32 box at W >= 32), and every slab holds its box's taps."""
    for cin, cout, taps in ((1280, 1280, 1), (2560, 1280, 1), (96, 96, 3),
                            (3, 96, 3), (96, 3, 3), (8, 320, 1), (64, 32, 3),
                            (3, 128, 1)):
        p = _plan(cin, cout, taps=taps, frames=frames, h=h, w=w, batch=2)
        count, share = _writes(p, 2, frames, h, w)
        assert (count == 1).all(), (cin, cout, p)
        long_k = -(-cin // 16) * 16 * taps >= 128 and p.n > 16
        if (frames, h, w) in PORT_SIZES and p.route_name == "tile" and long_k:
            assert share >= 0.8, (cin, cout, share, p)
        assert p.slab_pix == p.box_f * (p.box_r + 2) * (p.box_w + 2)
        assert p.slab_pix <= (340 if w % 32 == 0 else 432)
        assert p.box_f * p.box_r * p.box_w <= 256
        if w % 32 == 0:
            assert (p.box_f, p.box_r, p.box_w) == (1, 8, 32)


# the Wan2.1 VAE's widths at 480 x 832 and at the refine's 704 x 1280
VAE_WIDTHS = (832, 416, 208, 104, 1280, 640, 320, 160)


@pytest.mark.parametrize("w", VAE_WIDTHS)
def test_conv3d_route_and_k_order_follow_no_height_or_frames(w):
    """The route and the order of each output's sums (the padded Cin, the
    taps and, at three taps, the channel chunk and the k16 steps of a
    stage, which interleave chunks with temporal taps; at one tap every
    chunk sums each 16-channel block's nine taps in turn) are the same for
    every strip height 17-242 and every chunk length, so that the VAE's
    H-strips and streaming chunks are bit-equal to the whole frame; only the
    box, the walk, the stages and the grid may follow H and T."""
    for cin, cout in VAE_CONV_SHAPES:
        for taps in (3, 1):
            for dtype in (torch.float32, torch.bfloat16):
                order = {(p.route, p.cin_p, p.taps_k) + (
                             (p.ck, p.ksteps) if taps == 3 else ())
                         for h in range(17, 243, 5)
                         for frames in (1, 2, 3, 4, 5, 9, 17, 21)
                         for p in [_plan(cin, cout, taps=taps, frames=frames,
                                         h=h, w=w, dtype=dtype)]}
                assert len(order) == 1, (cin, cout, taps, dtype, order)


def test_conv3d_prepared_weight_cache(rng):
    """The bf16 weight layout is made once per weight tensor,
    and made again when the tensor changes in place or is replaced."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 5)).astype(
        np.float32))
    wp = tconv.prepared_weight(w)
    assert wp.shape == (28, 8, 16) and wp.dtype == torch.bfloat16
    assert torch.equal(wp, tconv.prepare_weight(w))
    assert tconv.prepared_weight(w) is wp
    w.mul_(2.0)
    wp2 = tconv.prepared_weight(w)
    assert wp2 is not wp
    torch.testing.assert_close(wp2[:27, :3, :5].float(),
                               w.reshape(27, 3, 5).bfloat16().float())
    assert tconv.prepared_weight(w) is wp2
    w2 = w.clone()
    wp3 = tconv.prepared_weight(w2)
    assert wp3 is not wp2 and torch.equal(wp3, wp2)
    with torch.inference_mode():
        wi = torch.ones((3, 3, 3, 16, 32))
        assert tconv.prepared_weight(wi) is tconv.prepared_weight(wi)


# ------------------------------------------------------------ helpers


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_dense_bf16_weights_fp32_request(rng, x_dtype):
    """bf16-stored weights under an fp32 compute request take the hi/lo
    two-term split (the DiT head); fp32 inputs agree to fp32 rounding."""
    x = rng.standard_normal((4, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    want = np.asarray(JP.dense(jp, jnp.asarray(x, getattr(jnp, x_dtype)),
                               compute_dtype=jnp.float32))
    got = TP.dense({"w": tensor_from_numpy(jp["w"])},
                   torch.from_numpy(x).to(getattr(torch, x_dtype)),
                   compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the split recovers fp32-input accuracy, unlike a plain bf16 cast
    exact = x @ jp["w"].astype(np.float32)
    if x_dtype == "float32":
        assert np.abs(got - exact).max() < 1e-4


@pytest.mark.parametrize("target,method", [
    ((1, 3, 5, 24, 40), "linear"),     # up-resize
    ((2, 3, 3, 5, 9), "linear"),       # down-resize (antialiased), batch bc
    ((1, 1, 5, 7, 33), "nearest"),
])
def test_resize_video_like_matches_jax_image_resize(rng, target, method):
    from worldforge_tpu.sampling.guidance import \
        resize_video_like as jresize
    c = target[1]
    x = rng.random((1, c, 5, 12, 20)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), target, method))
    got = resize_video_like(torch.from_numpy(x), target, method).numpy()
    assert got.shape == tuple(target)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("n,hh,ww,cin,cout", [(2, 9, 13, 16, 32),
                                              (3, 5, 7, 3, 5)])
def test_conv2d_3x3_matches_jax_conv_of_bf16_operands(rng, n, hh, ww, cin,
                                                      cout):
    """Kernel 4's one-tap instantiation (the VAE's 3x3 resample convs on
    the card) is the JAX package's XLA conv as it runs on its chip: bf16
    operands, fp32 sums. Its plain version and ``core/params.conv`` with
    ``bf16_operands`` against ``worldforge_tpu/core/params.py::conv`` of
    the rounded operands."""
    x = rng.standard_normal((n, hh, ww, cin)).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    r16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(JP.conv({"w": r16(w), "b": jnp.asarray(b)}, r16(x),
                              padding="SAME"))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    for got in (tconv.conv2d_3x3(tx, tw, tb),
                TP.conv({"w": tw, "b": tb}, tx, padding=1,
                        bf16_operands=True)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tconv.prepare_weight(tw).shape == (
        (10, 8, _r16(cout)) if cin <= 4 else (9, _r16(cin), _r16(cout)))
    full = np.asarray(JP.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x), padding="SAME"))
    np.testing.assert_allclose(TP.conv({"w": tw, "b": tb}, tx,
                                       padding=1).numpy(), full, rtol=1e-5,
                               atol=1e-5)


def _r16(n):
    return -(-n // 16) * 16
