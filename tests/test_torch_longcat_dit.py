"""The port's LongCat DiT against the JAX package's, on the CPU.

The JAX tiny config, weights made with the JAX init and carried over by
``io/from_jax.py``, the same numpy inputs on both sides: per-frame
timesteps and a text mask whose length (5) is shorter than the padded text
(8), so ``kv_lens`` masks keys. Three variants: dense self-attention,
block-sparse attention (sparsity 0.5 on a 512-token grid of 4 chunks; the
JAX side runs its dense-masked reference off the TPU, the port the plain
version of kernel 5) and the cond/noise split (``num_cond_latents=1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core.dtypes import DEFAULT_POLICY as J_DEFAULT
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.longcat import dit as jdit
from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY as T_DEFAULT
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import longcat_dit_params_from_jax
from worldforge_tpu_torch.models.longcat import dit as tdit

torch.set_num_threads(2)

M, TEXT_LEN = 8, 5
VARIANTS = {
    "dense": dict(),
    "bsa": dict(bsa_params={"sparsity": 0.5}),
    "cond_split": dict(num_cond_latents=1),
    # the QKV prologue and the FFN over token chunks (JAX's lax.map)
    "token_chunk": dict(token_chunk=4),
    "cond_split_token_chunk": dict(num_cond_latents=1, token_chunk=2),
}


@pytest.fixture(scope="module")
def jax_params():
    cfg = jdit.LongCatDiTConfig.tiny()
    return {dt: jax.tree_util.tree_map(np.asarray, jdit.init_longcat_dit(
        jax.random.key(0), cfg, dtype=getattr(jnp, dt)))
        for dt in ("float32", "bfloat16")}


def _inputs(rng, cfg):
    # (T, H, W) = (8, 8, 32) latents -> (8, 4, 16) tokens = 512 = 4 chunks
    x = rng.standard_normal((1, cfg.in_channels, 8, 8, 32)).astype(
        np.float32)
    t = np.linspace(900.0, 50.0, 8, dtype=np.float32)[None]
    ctx = rng.standard_normal((1, M, cfg.caption_channels)).astype(
        np.float32)
    mask = np.zeros((1, M), np.int32)
    mask[:, :TEXT_LEN] = 1
    return x, t, ctx, mask


def _run_both(jp, rng, jpol, tpol, **kw):
    cfg = jdit.LongCatDiTConfig.tiny()
    x, t, ctx, mask = _inputs(rng, cfg)
    want = np.asarray(jdit.longcat_dit_forward(
        jax.tree_util.tree_map(jnp.asarray, jp), cfg, jnp.asarray(x),
        jnp.asarray(t), jnp.asarray(ctx),
        encoder_attention_mask=jnp.asarray(mask), policy=jpol, **kw))
    got = tdit.longcat_dit_forward(
        longcat_dit_params_from_jax(jp), tdit.LongCatDiTConfig.tiny(),
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
        encoder_attention_mask=torch.from_numpy(mask), policy=tpol,
        **kw).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_longcat_dit_fp32_matches_jax(jax_params, rng, variant):
    """FP32_POLICY with fp32 weights: the same fp32 arithmetic summed in
    another order (measured 3e-7 to 4e-7 relative); held below 1e-4."""
    rel = _run_both(jax_params["float32"], rng, J_FP32, T_FP32,
                    **VARIANTS[variant])
    assert rel < 1e-4, rel


def test_longcat_dit_bf16_matches_jax(jax_params, rng):
    """The default bf16 policy with bf16 weights: bf16 matmul outputs round
    in other places in the two frameworks, and the port's attention rounds
    P to bf16 like the kernels (measured 2.8e-3 relative); held below
    2e-2."""
    rel = _run_both(jax_params["bfloat16"], rng, J_DEFAULT, T_DEFAULT)
    assert rel < 2e-2, rel


def test_pieces_and_init_match_jax(jax_params, rng):
    t = np.array([0.0, 17.5, 999.0], np.float32)
    np.testing.assert_allclose(
        tdit.timestep_embedding(torch.from_numpy(t), 16).numpy(),
        np.asarray(jdit.timestep_embedding(jnp.asarray(t), 16)), atol=1e-5)
    cfg = tdit.LongCatDiTConfig.tiny()
    assert tdit.LongCatDiTConfig.longcat_13b().ffn_hidden == 11008
    tp = tdit.init_longcat_dit(torch.Generator().manual_seed(0), cfg)
    want = longcat_dit_params_from_jax(jax_params["bfloat16"])
    shapes = lambda tree: jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), tree))
    assert shapes(tp) == shapes(want)
    assert len(tp["blocks"]) == cfg.depth
    assert tp["final"]["linear"]["w"].dtype == torch.bfloat16
    assert tp["blocks"][0]["adaln"]["w"].dtype == torch.float32


def test_later_slices_raise(jax_params, rng):
    """Meshes and ``token_chunk`` are ported (``tests/test_torch_parallel
    _models.py``, the token_chunk variants above); what still raises is an
    FSDP-sharded tree (a leaf marked with its ``fsdp_axis``) without the
    mesh it was sharded on."""
    cfg = tdit.LongCatDiTConfig.tiny()
    x, t, ctx, _ = _inputs(rng, cfg)
    p = longcat_dit_params_from_jax(jax_params["float32"])
    p["blocks"][0]["qkv"]["w"].fsdp_axis = 1
    with pytest.raises(ValueError, match="mesh"):
        tdit.longcat_dit_forward(p, cfg, torch.from_numpy(x),
                                 torch.from_numpy(t), torch.from_numpy(ctx))
