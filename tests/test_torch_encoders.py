"""The port's UMT5 and CLIP-H encoders against the JAX package's, on the CPU.

Tiny configs, weights from the JAX init carried over by
``io/from_jax.py``, the same numpy inputs on both sides. fp32 compute to
1e-4 of the largest |output|; UMT5 with bf16 weights and compute (the
default) to 2e-2 (6e-3 to 7e-3 measured over three seeds): both sides
round each matmul's output and the activations to bf16, at places that
differ by a bf16 ulp (2^-8 = 4e-3) and compound over the 2 layers and the
residual stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.models.encoders import clip_vision as jclip
from worldforge_tpu.models.encoders import umt5 as jumt5
from worldforge_tpu.ops.attention import sdpa_reference as jsdpa
from worldforge_tpu_torch.io.from_jax import (clip_params_from_jax,
                                              tree_from_numpy,
                                              umt5_params_from_jax)
from worldforge_tpu_torch.models.encoders import clip_vision as tclip
from worldforge_tpu_torch.models.encoders import umt5 as tumt5
from worldforge_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def test_rel_position_buckets_equal_jax():
    for q, k in ((512, 512), (7, 300), (300, 7)):
        np.testing.assert_array_equal(
            tumt5.rel_position_bucket_matrix(q, k, 32, 128),
            jumt5.rel_position_bucket_matrix(q, k, 32, 128))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_umt5_matches_jax(rng, dtype, tol):
    cfg = jumt5.UMT5Config.tiny()
    jd = getattr(jnp, dtype)
    p = jumt5.init_umt5(jax.random.key(0), cfg, dtype=jd)
    ids = rng.integers(0, cfg.vocab_size, (2, 24))
    mask = np.ones((2, 24), np.int32)
    mask[1, 9:] = 0
    want = jumt5.umt5_encode(p, cfg, jnp.asarray(ids), jnp.asarray(mask),
                             compute_dtype=jd)
    got = tumt5.umt5_encode(
        umt5_params_from_jax(jax.tree_util.tree_map(np.asarray, p)),
        tumt5.UMT5Config.tiny(), torch.from_numpy(ids),
        torch.from_numpy(mask), compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32
    assert not got[1, 9:].any()
    assert _rel(got.numpy(), want) < tol


def _clip(seed=0):
    cfg = jclip.CLIPVisionConfig.tiny()
    p = jclip.init_clip_vision(jax.random.key(seed), cfg)
    return cfg, p, clip_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               p))


def test_clip_vision_matches_jax(rng):
    cfg, p, tp = _clip()
    image = rng.random((40, 60, 3)).astype(np.float32)
    pix = tclip.preprocess_clip(image, cfg.image_size)
    np.testing.assert_array_equal(pix, jclip.preprocess_clip(
        image, cfg.image_size))
    tcfg = tclip.CLIPVisionConfig.tiny()
    for penultimate in (True, False):
        want = jclip.clip_vision_hidden(p, cfg, jnp.asarray(pix),
                                        penultimate=penultimate)
        got = tclip.clip_vision_hidden(tp, tcfg, torch.from_numpy(pix),
                                       penultimate=penultimate)
        assert got.shape == (1, cfg.tokens, cfg.width)
        assert _rel(got.numpy(), want) < 1e-4
    proj = jclip.init_clip_projection(jax.random.key(1), cfg, 16)
    want = jclip.clip_vision_image_embeds(p, proj, cfg, jnp.asarray(pix))
    got = tclip.clip_vision_image_embeds(
        tp, tree_from_numpy(jax.tree_util.tree_map(np.asarray, proj)), tcfg,
        torch.from_numpy(pix))
    assert _rel(got.numpy(), want) < 1e-4


def test_flash_attention_plain_d80_matches_sdpa_reference(rng):
    """Kernel 1's contract at CLIP-H's head dim (fp32, 16 heads of 80 on
    the card), with ragged key lengths and m / l."""
    q, k, v = (rng.standard_normal((2, 57, 3, 80)).astype(np.float32)
               for _ in range(3))
    lens = np.array([57, 20], np.int32)
    want = jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 kv_lens=jnp.asarray(lens))
    got, m, l = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    kv_lens=torch.from_numpy(lens),
                                    return_lse=True)
    assert _rel(got.numpy(), want) < 1e-5
    assert m.shape == l.shape == (2, 3, 57)
    assert 80 in tfa._KERNEL_HEAD_DIMS[torch.float32]
