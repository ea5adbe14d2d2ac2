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
