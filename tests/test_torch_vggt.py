"""The port's VGGT against the JAX package's, on the CPU, in fp32.

``VGGTConfig.tiny()`` weights from the JAX init, their LayerScale gammas
drawn from U(0.5, 1.5) (the init's 0.01 would hide the blocks), carried
over by ``io/from_jax.vggt_params_from_jax``; the same numpy inputs on both
sides; 1e-4 of the largest |output| (fp32 sums in another order). Images
are 28 x 56 (a 2 x 4 patch grid), so the DINO position embedding is
resized to a non-square grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.models.vggt import heads as jheads
from worldforge_tpu.models.vggt import inference as jinf
from worldforge_tpu.models.vggt import model as jmodel
from worldforge_tpu.models.vggt import utils as jutils
from worldforge_tpu.models.vggt import vit as jvit
from worldforge_tpu_torch.io.from_jax import (tree_from_numpy,
                                              vggt_params_from_jax)
from worldforge_tpu_torch.models.vggt import heads as theads
from worldforge_tpu_torch.models.vggt import inference as tinf
from worldforge_tpu_torch.models.vggt import model as tmodel
from worldforge_tpu_torch.models.vggt import utils as tutils
from worldforge_tpu_torch.models.vggt import vit as tvit

torch.set_num_threads(2)
TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


def _gammas(tree, rng):
    """LayerScale gammas from U(0.5, 1.5), everything else as it is."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.uniform(0.5, 1.5, np.shape(v)),
                                jnp.float32) if k == "gamma"
                    else _gammas(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gammas(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def vggt():
    cfg = jmodel.VGGTConfig.tiny()
    p = _gammas(jinf.init_vggt_full(jax.random.key(0), cfg),
                np.random.default_rng(1))
    rng = np.random.default_rng(2)
    images = rng.random((1, 2, 3, 28, 56)).astype(np.float32)
    return cfg, p, vggt_params_from_jax(jax.tree_util.tree_map(np.asarray, p)
                                        ), images


def test_pos_embed_resize_matches_jax(rng):
    """jax.image.resize's bicubic (Keys a = -0.5, antialiased when
    shrinking) at non-square grids, down (37 x 37 -> 21 x 37, the 294 x 518
    input) and up."""
    for m, gh, gw in ((37, 21, 37), (2, 2, 4), (5, 7, 3)):
        pos = rng.standard_normal((1, m * m + 1, 8)).astype(np.float32)
        want = jvit._interp_pos_embed(jnp.asarray(pos), gh, gw, 8)
        _close(tvit.interp_pos_embed(torch.from_numpy(pos), gh, gw), want,
               1e-6)


def test_rope2d_matches_jax(rng):
    x = rng.standard_normal((2, 13, 3, 16)).astype(np.float32)
    pos = jmodel.make_positions(3, 4, 1)
    np.testing.assert_array_equal(tmodel.make_positions(3, 4, 1), pos)
    _close(tmodel.rope2d_rotate(torch.from_numpy(x), pos),
           jmodel.rope2d_rotate(jnp.asarray(x), pos), 1e-6)


def test_aggregator_taps_match_jax(vggt):
    cfg, p, tp, images = vggt
    want = jmodel.vggt_aggregator_forward(p["aggregator"], cfg,
                                          jnp.asarray(images))
    got = tmodel.vggt_aggregator_forward(tp["aggregator"],
                                         tmodel.VGGTConfig.tiny(),
                                         torch.from_numpy(images))
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for layer in want:
        _close(got[layer].numpy(), want[layer])


def test_camera_head_matches_jax(rng):
    jcfg = jheads.CameraHeadConfig.tiny(dim_in=64)
    p = _gammas(jheads.init_camera_head(jax.random.key(3), jcfg), rng)
    tok = rng.standard_normal((1, 3, 64)).astype(np.float32)
    want = jheads.camera_head_forward(p, jcfg, jnp.asarray(tok))
    got = theads.camera_head_forward(
        tree_from_numpy(jax.tree_util.tree_map(np.asarray, p)),
        theads.CameraHeadConfig.tiny(dim_in=64), torch.from_numpy(tok))
    _close(got.numpy(), want)


@pytest.mark.parametrize("stride", [2, 4])
def test_deconv_matches_jax(rng, stride):
    """JAX's conv_transpose (kernel = stride, VALID, HWIO, not flipped)."""
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((stride, stride, 6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    want = jheads._deconv2d(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), stride)
    got = theads._deconv2d(tree_from_numpy(p), torch.from_numpy(x), stride)
    _close(got.numpy(), want, 1e-6)


def test_dpt_head_matches_jax(rng):
    jcfg = jheads.DPTHeadConfig.tiny(dim_in=64)
    p = jheads.init_dpt_head(jax.random.key(4), jcfg)
    taps = [rng.standard_normal((1, 2, 3 + 8, 64)).astype(np.float32)
            for _ in range(4)]
    want = jax.jit(lambda p, t: jheads.dpt_head_forward(
        p, jcfg, t, (28, 56), 3))(p, [jnp.asarray(t) for t in taps])
    got = theads.dpt_head_forward(
        tree_from_numpy(jax.tree_util.tree_map(np.asarray, p)),
        theads.DPTHeadConfig.tiny(dim_in=64),
        [torch.from_numpy(t) for t in taps], (28, 56), 3)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_vggt_forward_matches_jax(vggt):
    cfg, p, tp, images = vggt
    want = jinf.vggt_forward(p, cfg, jnp.asarray(images))
    got = tinf.vggt_forward(tp, tmodel.VGGTConfig.tiny(),
                            torch.from_numpy(images))
    assert got["depth"].shape == (1, 2, 28, 56, 1)
    for key in ("pose_enc", "depth", "depth_conf"):
        _close(got[key].numpy(), want[key])


def test_pose_encoding_and_depth_and_camera(vggt):
    cfg, p, tp, images = vggt
    enc = np.random.default_rng(5).standard_normal((1, 2, 9)).astype(
        np.float32)
    for a, b in zip(tutils.pose_encoding_to_extri_intri(enc, (28, 56)),
                    jutils.pose_encoding_to_extri_intri(enc, (28, 56))):
        np.testing.assert_array_equal(a, b)
    depth, conf, e44, k = tinf.depth_and_camera(
        tp, tmodel.VGGTConfig.tiny(), images[0], camera_index=1,
        device="cpu")
    out = jinf.vggt_forward(p, cfg, jnp.asarray(images))
    extr, intr = jutils.pose_encoding_to_extri_intri(
        np.asarray(out["pose_enc"]), (28, 56))
    _close(depth, np.asarray(out["depth"])[0, 1, :, :, 0])
    _close(conf, np.asarray(out["depth_conf"])[0, 1])
    _close(e44[:3], extr[0, 1])
    _close(k, intr[0, 1])


def test_vggt_estimate_needs_weights(vggt, tmp_path, monkeypatch):
    """Without a checkpoint ``vggt_estimate`` stops with the JAX message;
    with a converted one (the fixture's tree written in the upstream
    layout, the config patched to the tiny one) it runs, and its depth,
    confidence and cameras equal JAX's forward on the JAX converter's tree
    to 1e-4."""
    from PIL import Image
    from safetensors.numpy import save_file

    from tests.test_torch_convert import vggt_sd
    from worldforge_tpu.io.convert_vggt import load_converted_vggt
    cfg, p, _, _ = vggt
    path = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (20, 30, 3), np.uint8)).save(path)
    with pytest.raises(SystemExit, match="VGGT weights required"):
        tinf.vggt_estimate(str(path))
    images = tutils.load_and_preprocess_images([str(path)])
    np.testing.assert_array_equal(
        images, jutils.load_and_preprocess_images([str(path)]))
    ckpt = str(tmp_path / "vggt.safetensors")
    save_file(vggt_sd(jax.tree_util.tree_map(np.asarray, p), cfg), ckpt)
    monkeypatch.setattr(tmodel.VGGTConfig, "vggt_1b",
                        classmethod(lambda c: c.tiny()))
    depth, conf, e44, k = tinf.vggt_estimate(str(path), checkpoint=ckpt,
                                             device="cpu")
    jp = load_converted_vggt(ckpt, cfg)
    out = jax.jit(lambda q, im: jinf.vggt_forward(q, cfg, im))(
        jp, jnp.asarray(images)[None])
    extr, intr = jutils.pose_encoding_to_extri_intri(
        np.asarray(out["pose_enc"]), images.shape[-2:])
    assert depth.shape == images.shape[-2:]
    _close(depth, np.asarray(out["depth"])[0, 0, :, :, 0])
    _close(conf, np.asarray(out["depth_conf"])[0, 0])
    _close(e44[:3], extr[0, 0])
    _close(k, intr[0, 0])
