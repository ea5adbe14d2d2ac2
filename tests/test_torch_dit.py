"""The port's Wan DiT against the JAX package's, on the CPU.

The JAX tiny i2v config with its zero-init head randomized (as the
random-init loader does), weights carried over by ``io/from_jax.py``, the
same numpy inputs on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY as T_DEFAULT
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import (dit_params_from_jax,
                                              unstack_layers)
from worldforge_tpu_torch.models.wan import dit as tdit

torch.set_num_threads(2)


def _jax_params(cfg, dtype):
    p = jdit.init_wan_dit(jax.random.key(0), cfg, dtype=dtype)
    head = p["head"]["head"]["w"]
    p["head"]["head"]["w"] = (0.02 * jax.random.normal(
        jax.random.key(99), head.shape, jnp.float32)).astype(head.dtype)
    return p


def _inputs(cfg, rng, t):
    x = rng.standard_normal((1, cfg.out_dim, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((1, cfg.in_dim - cfg.out_dim, 3, 8, 8)).astype(
        np.float32)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    clip = rng.standard_normal((1, 257, cfg.clip_dim)).astype(np.float32)
    return x, y, np.array([t], np.float32), ctx, clip


def _run_both(policy_pair, dtype, t, rng, token_chunk=1):
    jpol, tpol = policy_pair
    cfg = jdit.WanDiTConfig.tiny("i2v")
    p = _jax_params(cfg, dtype)
    x, y, tt, ctx, clip = _inputs(cfg, rng, t)
    want = np.asarray(jdit.wan_dit_forward(
        p, cfg, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx),
        clip_fea=jnp.asarray(clip), y=jnp.asarray(y), policy=jpol,
        token_chunk=token_chunk))
    tp = dit_params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    got = tdit.wan_dit_forward(
        tp, tdit.WanDiTConfig.tiny("i2v"), torch.from_numpy(x),
        torch.from_numpy(tt), torch.from_numpy(ctx),
        clip_fea=torch.from_numpy(clip), y=torch.from_numpy(y),
        policy=tpol, token_chunk=token_chunk).numpy()
    assert got.shape == want.shape == (1, cfg.out_dim, 3, 8, 8)
    return got, want


@pytest.mark.parametrize("t", [999.0, 37.0])
def test_dit_fp32_policy_matches_jax(rng, t):
    """FP32_POLICY with fp32 weights: the same fp32 arithmetic, summed in
    another order (measured 4e-7 relative); held below 1e-4 relative."""
    got, want = _run_both((J_FP32, T_FP32), jnp.float32, t, rng)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("token_chunk", [2, 4, 5])
def test_dit_token_chunk_matches_jax(rng, token_chunk):
    """``token_chunk``: the FFN over that many token chunks where it divides
    the 48 tokens (2, 4), one call where it does not (5), as JAX's
    ``_ffn_token_chunked``; held below 1e-4 relative of JAX's chunked
    forward under FP32_POLICY."""
    got, want = _run_both((J_FP32, T_FP32), jnp.float32, 500.0, rng,
                          token_chunk)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-4, rel


def test_dit_default_policy_matches_jax(rng):
    """The default bf16 policy with bf16 weights: bf16 matmul outputs round
    in other places in the two frameworks (and the port's attention rounds
    P to bf16 like the kernel), about 2e-3 relative; held below 1e-2."""
    got, want = _run_both((J_DEFAULT, T_DEFAULT), jnp.bfloat16, 999.0, rng)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-2, rel


def test_from_jax_unstacks_blocks():
    cfg = jdit.WanDiTConfig.tiny("i2v")
    p = jax.tree_util.tree_map(np.asarray, _jax_params(cfg, jnp.bfloat16))
    tp = dit_params_from_jax(p)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    w = tp["blocks"][1]["ffn"]["fc1"]["w"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (128, 256)
    np.testing.assert_array_equal(
        w.float().numpy(), p["blocks"]["ffn"]["fc1"]["w"][1].astype(
            np.float32))
    assert len(unstack_layers({"a": np.zeros((3, 2)),
                               "b": {"c": np.ones((3,))}})) == 3


def test_patchify_roundtrip_and_pieces(rng):
    x = rng.standard_normal((2, 5, 3, 4, 6)).astype(np.float32)
    jt = np.asarray(jdit.patchify(jnp.asarray(x), (1, 2, 2)))
    tt = tdit.patchify(torch.from_numpy(x), (1, 2, 2))
    np.testing.assert_array_equal(tt.numpy(), jt)
    back = tdit.unpatchify(tt, (3, 2, 3), (1, 2, 2), 5)
    np.testing.assert_array_equal(back.numpy(), x)
    t = np.array([0.0, 17.0, 999.0], np.float32)
    np.testing.assert_allclose(
        tdit.sinusoidal_embedding_1d(32, torch.from_numpy(t)).numpy(),
        np.asarray(jdit.sinusoidal_embedding_1d(32, jnp.asarray(t))),
        atol=1e-5)


def test_random_init_shapes_match_jax():
    cfg = tdit.WanDiTConfig.tiny("i2v")
    tp = tdit.init_wan_dit(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda: jdit.init_wan_dit(jax.random.key(0),
                                                 jdit.WanDiTConfig.tiny()))
    jl = unstack_layers(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jp["blocks"]))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp["blocks"][0]))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jl[0]))
    assert flat_t == flat_j
    assert tp["head"]["head"]["w"].dtype == torch.bfloat16
    assert tp["time_projection"]["w"].dtype == torch.float32
