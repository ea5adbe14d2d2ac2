"""The port's streaming Wan VAE against its single-pass VAE and against the
JAX package's streaming VAE, on the CPU.

Two conv modes, as in ``test_torch_vae.py``: 'fp32' runs fp32 3x3x3 convs
on both sides (JAX's native conv, the port's conv3d swapped for an fp32
convolution) and holds the results to 1e-5 relative; 'kernel' runs the JAX
Pallas conv in interpret mode against the port's conv3d kernel path, both
rounding the conv inputs to bf16, and holds them at bf16 noise level (a
last-bit fp32 difference flips a bf16 rounding; see ``test_torch_vae.py``).
Streaming against the port's own single pass is held the same way: with
fp32 convs it is the same arithmetic up to fp32 rounding, with the kernel
path a last-bit difference of the norms between the two passes flips a
bf16 rounding as well (measured 2.7e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.models.wan import vae_stream as jvs
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.models.wan import vae_stream as tvs
from worldforge_tpu_torch.pipelines.vae_dispatch import vae_fn_pair

torch.set_num_threads(2)

# relative max / relative L2 error allowed, by conv mode
TOL = {"kernel": (3e-2, 2e-2), "fp32": (1e-5, 1e-5)}
# latent frames per test, by conv mode (the Pallas interpret conv is slow)
T_LAT = {"kernel": 2, "fp32": 3}


def fp32_conv3d(x, w, b=None, *, out_dtype=None):
    p = {"w": w} if b is None else {"w": w, "b": b}
    return TP.conv(p, x, padding=(0, 1, 1))


@pytest.fixture(params=["kernel", "fp32"])
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


def _rel(got, want):
    return (np.abs(got - want).max() / np.abs(want).max(),
            np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(got, want, mode):
    rel_max, rel_l2 = _rel(got, want)
    tol_max, tol_l2 = TOL[mode]
    assert rel_max < tol_max and rel_l2 < tol_l2, (rel_max, rel_l2)


def test_encode_streaming_matches(rng, tiny_vae, conv_mode):
    jcfg, jp, tp = tiny_vae
    cfg = tvae.WanVAEConfig.tiny()
    t = T_LAT[conv_mode]
    video = rng.uniform(-1, 1, (1, 3, 4 * t - 3, 16, 16)).astype(np.float32)
    got = tvs.vae_encode_streaming(tp, cfg, torch.from_numpy(video)).numpy()
    single = tvae.vae_encode(tp, cfg, torch.from_numpy(video)).numpy()
    want = np.asarray(jvs.vae_encode_streaming(jp, jcfg, jnp.asarray(video)))
    assert got.shape == want.shape == (1, cfg.z_dim, t, 2, 2)
    _check(got, single, conv_mode)
    _check(got, want, conv_mode)


@pytest.mark.parametrize("chunk", [1, 2])
def test_decode_streaming_matches(rng, tiny_vae, conv_mode, chunk):
    jcfg, jp, tp = tiny_vae
    cfg = tvae.WanVAEConfig.tiny()
    t = 2 * T_LAT[conv_mode] - 1          # 1 + a multiple of both chunks
    z = rng.standard_normal((1, cfg.z_dim, t, 2, 2)).astype(np.float32)
    got = tvs.vae_decode_streaming(tp, cfg, torch.from_numpy(z),
                                   chunk=chunk).numpy()
    single = tvae.vae_decode(tp, cfg, torch.from_numpy(z)).numpy()
    want = np.asarray(jvs.vae_decode_streaming(jp, jcfg, jnp.asarray(z),
                                               chunk=chunk))
    assert got.shape == want.shape == (1, 3, 4 * t - 3, 16, 16)
    _check(got, single, conv_mode)
    _check(got, want, conv_mode)


def test_dispatch_streams_and_spatial_chunks_raise(rng, tiny_vae):
    """The streaming pair truncates T = 10 to the causal 9 frames, as the
    single pass does; the H-strip tiling is a later slice and raises."""
    _, _, tp = tiny_vae
    cfg = tvae.WanVAEConfig.tiny()
    video = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 10, 16, 16)).astype(
        np.float32))
    dec, enc = vae_fn_pair(True, chunk=2)
    lat = enc(tp, cfg, video)
    torch.testing.assert_close(lat, tvae.vae_encode(tp, cfg, video[:, :, :9]),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dec(tp, cfg, lat), tvae.vae_decode(tp, cfg,
                                                                  lat),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="H-strip"):
        tvs.vae_encode_streaming(tp, cfg, video[:, :, :9], spatial_chunks=2)
    with pytest.raises(NotImplementedError, match="H-strip"):
        tvs.vae_decode_streaming(tp, cfg, lat, spatial_chunks=2)


def test_caches_match_jax_tree(tiny_vae):
    jcfg, jp, tp = tiny_vae
    cfg = tvae.WanVAEConfig.tiny()
    for tinit, jinit in ((tvs.init_encoder_caches, jvs.init_encoder_caches),
                         (tvs.init_decoder_caches, jvs.init_decoder_caches)):
        part = "encoder" if tinit is tvs.init_encoder_caches else "decoder"
        got = tinit(tp[part], cfg, 1, 4, 6)
        want = jinit(jp[part], jcfg, 1, 4, 6)
        shapes = lambda tree: [tuple(a.shape) for a in
                               jax.tree_util.tree_leaves(tree)]
        assert shapes(jax.tree_util.tree_map(np.asarray, got)) == \
            shapes(want)


def test_caches_hold_only_their_frames(rng, tiny_vae):
    """A carried cache owns a copy of its 2 frames, not a view that keeps
    the whole padded chunk alive (at 704 x 1280 the views held about twice
    the streaming decoder's working set)."""
    _, _, tp = tiny_vae
    cfg = tvae.WanVAEConfig.tiny()
    caches = tvs.init_decoder_caches(tp["decoder"], cfg, 1, 2, 2)
    z = torch.from_numpy(rng.standard_normal((1, 3, 2, 2, cfg.z_dim)).astype(
        np.float32))
    z = tvae._causal_conv3d(tp["conv2"], z)
    for is_first, zf in ((True, z[:, :1]), (False, z[:, 1:])):
        _, caches = tvs._decoder_chunk(tp["decoder"], cfg, zf, caches,
                                       is_first)
    for c in jax.tree_util.tree_leaves(caches):
        assert c.untyped_storage().nbytes() == c.numel() * c.element_size()
