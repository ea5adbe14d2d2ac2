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
    """The kernel stages weights as bf16 [27, Cin16, Cout16], zero-padded."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 5)).astype(
        np.float32))
    wp = tconv.prepare_weight(w)
    assert wp.shape == (27, 16, 16) and wp.dtype == torch.bfloat16
    torch.testing.assert_close(wp[:, :3, :5].float(),
                               w.reshape(27, 3, 5).bfloat16().float())
    assert not wp[:, 3:].any() and not wp[:, :, 5:].any()


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


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", VAE_CONV_SHAPES)
def test_conv3d_plan_fits_the_kernel(cin, cout, x_dtype):
    """The tile plan the wrapper hands the kernel: 256 output pixels a
    block, N slices that divide the padded Cout (the whole Cout up to 128),
    a Cin chunk that divides the padded Cin, 2 to 4 stages, x by TMA unless
    its rows are no multiple of 16 bytes (Cin = 3), fp32 x through one or
    two fp32 staging buffers, and shared memory that holds the ring, the
    staging and the epilogue's tile within 227 KB."""
    dtype = getattr(torch, x_dtype)
    p = tconv.conv_plan(cin, cout, dtype)
    assert p.tile[0] * p.tile[1] == 256
    assert p.cin_p % 16 == 0 and p.cin_p - cin < 16
    assert p.cout_p % 16 == 0 and p.cout_p - cout < 16
    assert p.n in (16, 32, 96, 128) and p.n * p.nslices == p.cout_p
    assert p.nslices == 1 or p.cout_p > 128
    assert p.ck in (16, 32) and p.cin_p % p.ck == 0
    assert 2 <= p.stages <= 4
    assert p.manual == (cin == 3)
    fp32_tma = x_dtype == "float32" and not p.manual
    assert (p.staging in (1, 2)) if fp32_tma else p.staging == 0
    assert p.n % (p.swizzle_bytes // 2) == 0
    assert p.stage_bytes % 1024 == 0 and p.staging_bytes % 1024 == 0
    assert p.stage_bytes >= 9 * p.ck * p.n * 2 + 10 * 34 * p.ck * 2
    assert p.staging_bytes >= 10 * 34 * p.ck * 4
    assert p.smem_bytes == 1024 + max(
        p.stages * p.stage_bytes + p.staging * p.staging_bytes,
        p.epilogue_bytes) + 8 * (2 * p.stages + p.staging)
    assert p.smem_bytes <= 227 * 1024
    assert tconv.conv_plan(cin, cout, dtype) == p


def test_conv3d_plan_main_shapes():
    """Pinned plans: 96 -> 96 on fp32 x runs whole (N 96, 64-byte swizzle)
    with two 32-channel stages and one fp32 staging buffer; 384 -> 384 as
    three 128-wide slices (128-byte swizzle), three 16-channel stages and
    two staging buffers on fp32 x, two 32-channel stages on bf16 x;
    conv_in (Cin 3) stages x by hand."""
    p = tconv.conv_plan(96, 96)
    assert (p.n, p.nslices, p.ck, p.stages, p.staging, p.swizzle_bytes,
            p.manual, p.smem_bytes) == (96, 1, 32, 2, 1, 64, False, 200744)
    p = tconv.conv_plan(384, 384)
    assert (p.n, p.nslices, p.ck, p.stages, p.staging, p.swizzle_bytes,
            p.smem_bytes) == (128, 3, 16, 3, 2, 128, 190528)
    p = tconv.conv_plan(384, 384, torch.bfloat16)
    assert (p.ck, p.stages, p.staging, p.smem_bytes) == (32, 2, 0, 193568)
    p = tconv.conv_plan(3, 96)
    assert (p.cin_p, p.ck, p.stages, p.staging, p.manual) == (16, 16, 4, 0,
                                                              True)
    assert tconv.conv_plan(96, 96, x_aligned=False).manual


def test_conv3d_prepared_weight_cache(rng):
    """The bf16 [27, CinP, CoutP] weight is made once per weight tensor,
    and made again when the tensor changes in place or is replaced."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 5)).astype(
        np.float32))
    wp = tconv.prepared_weight(w)
    assert wp.shape == (27, 16, 16) and wp.dtype == torch.bfloat16
    assert torch.equal(wp, tconv.prepare_weight(w))
    assert tconv.prepared_weight(w) is wp
    w.mul_(2.0)
    wp2 = tconv.prepared_weight(w)
    assert wp2 is not wp
    torch.testing.assert_close(wp2[:, :3, :5].float(),
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
    assert tconv.prepare_weight(tw).shape == (9, 16, _r16(cout))
    full = np.asarray(JP.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x), padding="SAME"))
    np.testing.assert_allclose(TP.conv({"w": tw, "b": tb}, tx,
                                       padding=1).numpy(), full, rtol=1e-5,
                               atol=1e-5)


def _r16(n):
    return -(-n // 16) * 16
