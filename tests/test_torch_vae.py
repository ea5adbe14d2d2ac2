"""The port's Wan VAE against the JAX package's, on the CPU.

The JAX side runs its 3x3x3 causal convs through the Pallas conv kernel in
interpret mode (``vae._CONV3D_MODE = "pallas_interpret"``, set for the test
and restored), which is where the port's conv3d kernel stands: both round
the conv inputs to bf16 and sum in fp32.

That rounding sets the floor of the comparison. The two frameworks compute
the fp32 norms and activations between the convs with last-bit differences;
a conv input that lies on a bf16 rounding boundary then rounds the other way
on one side, which moves it by one bf16 ulp (2^-8 relative), and the deeper
convs amplify those flips. The kernel-path tests therefore hold the latents
and pixels at bf16 noise level. The algorithm itself is held tightly by
running both sides with fp32 convs (JAX's native ``"3d"`` mode, and the
port's conv3d swapped for an fp32 convolution for the test).

The weights are made with the port's init and carried to JAX, which keeps
the test fast (the JAX init of the tiny VAE compiles op by op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.models.wan.vae_stream import vae_encode_streaming
from worldforge_tpu_torch.pipelines.vae_dispatch import vae_fn_pair

torch.set_num_threads(2)


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    """An fp32 3x3x3 causal conv (no bf16 rounding) for the algorithm
    check; the port's conv3d kernel rounds its inputs to bf16."""
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.fixture(params=["kernel", "fp32"])
def conv_mode(request, monkeypatch):
    """'kernel': JAX runs the Pallas conv (interpret), the port its conv3d
    kernel's plain version; 'fp32': both run fp32 convs."""
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = ("pallas_interpret" if request.param == "kernel"
                         else "3d")
    if request.param == "fp32":
        monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    try:
        yield request.param
    finally:
        jvae._CONV3D_MODE = old


# relative max / relative L2 error allowed, by conv mode (see module doc):
# bf16 noise level for the kernel path (measured up to 1.2e-2 / 1.1e-2 on
# a small latent channel), fp32 rounding for the fp32 path (measured 1e-6)
TOL = {"kernel": (3e-2, 2e-2), "fp32": (1e-5, 1e-5)}


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = tvae.WanVAEConfig.tiny()
    tp = tvae.init_wan_vae(torch.Generator().manual_seed(1), cfg)
    # the zero-init attention projections would hide the attention block
    gen = torch.Generator().manual_seed(5)
    for part in ("encoder", "decoder"):
        w = tp[part]["mid"]["attn"]["proj"]["w"]
        w.copy_(0.2 * torch.randn(w.shape, generator=gen))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return jvae.WanVAEConfig.tiny(), jp, tp


def _check(got, want, mode):
    rel_max = np.abs(got - want).max() / np.abs(want).max()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    tol_max, tol_l2 = TOL[mode]
    assert rel_max < tol_max and rel_l2 < tol_l2, (rel_max, rel_l2)


def test_vae_encode_matches_jax(rng, tiny_vae, conv_mode):
    cfg, jp, tp = tiny_vae
    video = rng.uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    want = np.asarray(jvae.vae_encode(jp, cfg, jnp.asarray(video)))
    got = tvae.vae_encode(tp, tvae.WanVAEConfig.tiny(),
                          torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, cfg.z_dim, 2, 2, 2)
    _check(got, want, conv_mode)


def test_vae_decode_matches_jax(rng, tiny_vae, conv_mode):
    cfg, jp, tp = tiny_vae
    z = rng.standard_normal((1, cfg.z_dim, 2, 2, 2)).astype(np.float32)
    want = np.asarray(jvae.vae_decode(jp, cfg, jnp.asarray(z)))
    got = tvae.vae_decode(tp, tvae.WanVAEConfig.tiny(),
                          torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 3, 5, 16, 16)
    _check(got, want, conv_mode)


def test_vae_dispatch_truncates_to_causal(rng, tiny_vae):
    """T = 6 is no 1 + 4k: the encode fn drops the tail frame, as the
    reference encoder does."""
    _, _, tp = tiny_vae
    dec, enc = vae_fn_pair(False)
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 6, 16, 16)).astype(
        np.float32))
    cfg = tvae.WanVAEConfig.tiny()
    torch.testing.assert_close(enc(tp, cfg, video),
                               tvae.vae_encode(tp, cfg, video[:, :, :5]))
    # the streaming VAE and its H-strip tiling are ported: the tiled
    # streaming encode of the causal frames is the single pass's
    torch.testing.assert_close(
        vae_encode_streaming(tp, cfg, video[:, :, :5], spatial_chunks=2),
        tvae.vae_encode(tp, cfg, video[:, :, :5]), rtol=1e-5, atol=1e-6)


def test_random_init_matches_jax_tree():
    cfg = tvae.WanVAEConfig.tiny()
    tp = tvae.init_wan_vae(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda: jvae.init_wan_vae(jax.random.key(0),
                                                 jvae.WanVAEConfig.tiny()))
    shapes_t = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
    shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert (jax.tree_util.tree_leaves_with_path(shapes_t)
            == jax.tree_util.tree_leaves_with_path(shapes_j))


@pytest.mark.parametrize("shape", [(3, 17, 23, 8, 8), (2, 16, 10, 4, 12)])
def test_stride2_one_tap_route_matches_strided_conv(rng, shape):
    """The card's route for the encoder's 3x3 stride-2 VALID conv
    (``_conv2d_s2_one_tap``: the stride-1 SAME conv of kernel 4's one tap,
    odd rows and columns kept), run here through the kernel's plain
    version, against ``P.conv(stride=2)`` and JAX's XLA conv on the same
    bf16-rounded operands (the kernel's contract), at odd and even H and
    W."""
    n, h, w, cin, cout = shape
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
         "b": rng.standard_normal((cout,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tvae._conv2d_s2_one_tap(tp, torch.from_numpy(x)).numpy()
    want = TP.conv(tp, torch.from_numpy(x), stride=2,
                   bf16_operands=True).numpy()
    r16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    jax_want = np.asarray(jax.lax.conv_general_dilated(
        r16(x), r16(p["w"]), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)) + p["b"]
    assert got.shape == want.shape == ((n, (h - 1) // 2, (w - 1) // 2, cout))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got, jax_want, rtol=0, atol=1e-6 * scale)
