"""The port's VGGT track and point heads against the JAX package's, on the
CPU, in fp32.

JAX weights (random leaves, so no branch hides behind a zero or a one)
carried over by ``io/from_jax.py``; the same seeded numpy inputs on both
sides. Tolerances, of the largest |output|: sampling and embeddings 1e-6;
one forward of a module and a first refinement 1e-5; later refinements,
visibility, confidence and the whole VGGT 1e-4 (fp32 sums in another
order, carried through the refinements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import (_assert_same, _random_tree, _save,
                                      track_head_sd, zero_refine4_unit1)
from worldforge_tpu.io import convert_vggt as jcv
from worldforge_tpu.models.vggt import heads as jheads
from worldforge_tpu.models.vggt import inference as jinf
from worldforge_tpu.models.vggt import model as jmodel
from worldforge_tpu.models.vggt import track as jtrack
from worldforge_tpu.ops import sampling as jsampling
from worldforge_tpu_torch.io import convert_vggt as tcv
from worldforge_tpu_torch.io.from_jax import (track_head_params_from_jax,
                                              tree_from_numpy,
                                              vggt_params_from_jax)
from worldforge_tpu_torch.io.torch_load import load_state_dict
from worldforge_tpu_torch.models.vggt import heads as theads
from worldforge_tpu_torch.models.vggt import inference as tinf
from worldforge_tpu_torch.models.vggt import model as tmodel
from worldforge_tpu_torch.models.vggt import track as ttrack
from worldforge_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(2)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


def _random(init, seed, *args):
    """A JAX init's tree with random leaves (numpy)."""
    return _random_tree(jax.eval_shape(lambda k: init(k, *args),
                                       jax.random.key(0)),
                        np.random.default_rng(seed))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bilinear_sample_matches_jax(rng, padding):
    """Points inside, on the edges and outside the grid (each corner is
    clamped, and zeroed outside with ``zeros``)."""
    grid = rng.standard_normal((3, 7, 9, 5)).astype(np.float32)
    xy = rng.uniform(-2.0, 10.5, (3, 40, 2)).astype(np.float32)
    xy[:, :4] = [[0.0, 0.0], [8.0, 6.0], [8.5, 3.0], [-0.5, 6.0]]
    want = jsampling.bilinear_sample(jnp.asarray(grid), jnp.asarray(xy),
                                     padding=padding)
    got = tsampling.bilinear_sample(_t(grid), _t(xy), padding=padding)
    _close(got.numpy(), want, 1e-6)
    if padding == "zeros":
        far = np.abs(xy - 4).max(-1) > 7
        assert (got.numpy()[far] == 0).all()


def test_flow_embedding_and_pos_embed_match_jax(rng):
    flows = rng.standard_normal((2, 5, 2)).astype(np.float32) * 30
    _close(ttrack.flow_embedding(_t(flows), 8).numpy(),
           jtrack.flow_embedding(jnp.asarray(flows), 8), 1e-6)
    np.testing.assert_array_equal(ttrack.sincos_pos_embed_2d(20, 3, 5),
                                  jtrack.sincos_pos_embed_2d(20, 3, 5))


def test_corr_sample_matches_jax(rng):
    """Two pyramid levels of a 12 x 16 map; the (dy, dx) grid added to
    (x, y) centres as JAX (and the reference) add it."""
    fm = rng.standard_normal((1, 3, 12, 16, 8)).astype(np.float32)
    targets = rng.standard_normal((1, 3, 4, 8)).astype(np.float32)
    coords = rng.uniform(-1, 14, (1, 3, 4, 2)).astype(np.float32)
    want = jtrack.corr_sample(jtrack.corr_pyramid(jnp.asarray(fm), 2),
                              jnp.asarray(targets), jnp.asarray(coords), 2)
    got = ttrack.corr_sample(ttrack.corr_pyramid(_t(fm), 2), _t(targets),
                             _t(coords), 2)
    assert got.shape == (1, 3, 4, 2 * 25)
    _close(got.numpy(), want, 1e-5)


def test_updateformer_matches_jax(rng):
    cfg = jtrack.TrackHeadConfig.tiny()
    p = _random(jtrack.init_updateformer, 1, cfg)
    x = rng.standard_normal((1, 5, 3, cfg.transformer_dim)).astype(
        np.float32)
    want = jax.jit(lambda q, v: jtrack.updateformer_forward(q, cfg, v))(
        _j(p), jnp.asarray(x))
    got = ttrack.updateformer_forward(tree_from_numpy(p),
                                      ttrack.TrackHeadConfig.tiny(), _t(x))
    _close(got.numpy(), want, 1e-5)


def test_track_predictor_matches_jax(rng):
    """Every refinement's coordinates, the visibility and the confidence;
    frame 0 equals the query points exactly (pinned on a copy)."""
    cfg = jtrack.TrackHeadConfig.tiny()
    p = _random(jtrack.init_track_predictor, 2, cfg)
    fmaps = rng.standard_normal((1, 3, 8, 10, cfg.features)).astype(
        np.float32)
    qp = np.asarray([[[4.0, 4.0], [2.5, 13.0], [17.0, 1.0]]], np.float32)
    want = jax.jit(lambda q, x, f: jtrack.track_predictor_forward(
        q, cfg, x, f))(_j(p), jnp.asarray(qp), jnp.asarray(fmaps))
    got = ttrack.track_predictor_forward(tree_from_numpy(p),
                                         ttrack.TrackHeadConfig.tiny(),
                                         _t(qp), _t(fmaps))
    assert len(got[0]) == cfg.iters
    for g, w in zip(got[0], want[0]):
        _close(g.numpy(), w, 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].numpy(), want[2], 1e-4)
    np.testing.assert_array_equal(got[0][-1][:, 0].numpy(), qp)


def test_track_head_matches_jax(rng):
    """The DPT feature extractor (feature_only, down_ratio 2, no position
    embedding) and the tracker, from four random taps."""
    cfg = jtrack.TrackHeadConfig.tiny()
    p = _random(jtrack.init_track_head, 3, cfg)
    taps = [rng.standard_normal((1, 2, 5 + 4 * 6, 64)).astype(np.float32)
            for _ in range(4)]
    qp = np.asarray([[[10.0, 12.0], [40.5, 20.0]]], np.float32)
    want = jax.jit(lambda q, t, x: jtrack.track_head_forward(
        q, cfg, t, (56, 84), 5, x))(_j(p), [jnp.asarray(t) for t in taps],
                                    jnp.asarray(qp))
    got = ttrack.track_head_forward(track_head_params_from_jax(p),
                                    ttrack.TrackHeadConfig.tiny(),
                                    [_t(t) for t in taps], (56, 84), 5,
                                    _t(qp))
    for g, w in zip(got[0], want[0]):
        _close(g.numpy(), w, 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].numpy(), want[2], 1e-4)


@pytest.mark.parametrize("opts", [
    {"activation": "inv_log", "conf_activation": "expp0", "output_dim": 4},
    {"feature_only": True, "down_ratio": 2, "pos_embed": False},
    {"down_ratio": 2}])
def test_dpt_head_options_match_jax(rng, opts):
    """The DPT head's options beyond the depth head's: the point head's
    activations, the feature-only head and down_ratio."""
    import dataclasses
    jcfg = dataclasses.replace(jheads.DPTHeadConfig.tiny(dim_in=64), **opts)
    p = _random(jheads.init_dpt_head, 4, jcfg)
    taps = [rng.standard_normal((1, 2, 3 + 8, 64)).astype(np.float32)
            for _ in range(4)]
    want = jax.jit(lambda q, t: jheads.dpt_head_forward(
        q, jcfg, t, (28, 56), 3))(_j(p), [jnp.asarray(t) for t in taps])
    got = theads.dpt_head_forward(
        tree_from_numpy(p),
        dataclasses.replace(theads.DPTHeadConfig.tiny(dim_in=64), **opts),
        [_t(t) for t in taps], (28, 56), 3)
    if opts.get("feature_only"):
        assert "out_conv2a" not in p
        got, want = [got], [want]
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)


def _tiny_track(cls, dim_in, patch_size):
    """``cls.tiny()`` at the VGGT's width and patch size."""
    import dataclasses
    return dataclasses.replace(cls.tiny(), dim_in=dim_in,
                               patch_size=patch_size)


def test_vggt_forward_with_point_and_track_heads_matches_jax(rng,
                                                             monkeypatch):
    """``VGGTConfig.tiny()`` with the point head and a track head (the
    tiny track config on both sides, patched in where each package makes
    its track config) on 2 frames of 28 x 56; every output against JAX's;
    no track without query points."""
    jcls = jtrack.TrackHeadConfig
    monkeypatch.setattr(jtrack, "TrackHeadConfig", lambda dim_in, patch_size:
                        _tiny_track(jcls, dim_in, patch_size))
    monkeypatch.setattr(tinf, "track_head_config", lambda c: _tiny_track(
        ttrack.TrackHeadConfig, c.embed_dim * 2, c.patch_size))
    cfg = jmodel.VGGTConfig.tiny()
    p = _random(lambda k, c: jinf.init_vggt_full(k, c, enable_point=True,
                                                 enable_track=True), 5, cfg)
    assert p["track_head"]["tracker"]["corr_mlp"]["fc1"]["w"].shape[0] == \
        2 * 25
    images = rng.random((1, 2, 3, 28, 56)).astype(np.float32)
    qp = np.asarray([[[3.0, 4.0], [40.5, 21.25], [17.0, 9.0]]], np.float32)
    want = jax.jit(lambda q, im, x: jinf.vggt_forward(q, cfg, im, x))(
        _j(p), jnp.asarray(images), jnp.asarray(qp))
    got = tinf.vggt_forward(vggt_params_from_jax(p),
                            tmodel.VGGTConfig.tiny(), _t(images), _t(qp))
    assert sorted(got) == sorted(want)
    assert got["track"].shape == (1, 2, 3, 2)
    assert got["world_points"].shape == (1, 2, 28, 56, 3)
    for key in want:
        _close(got[key].numpy(), want[key], 1e-4)
    without = tinf.vggt_forward(vggt_params_from_jax(p),
                                tmodel.VGGTConfig.tiny(), _t(images))
    assert "track" not in without and "world_points" in without


def test_depth_and_camera_runs_only_the_depth_path(rng, monkeypatch):
    """With a full tree (point and track heads) ``depth_and_camera`` runs
    one DPT head, the depth head, and gives exactly what it gives on the
    tree without them."""
    cfg = tmodel.VGGTConfig.tiny()
    full = tinf.init_vggt_full(torch.Generator().manual_seed(3), cfg,
                               enable_point=True, enable_track=True)
    lean = {k: full[k] for k in ("aggregator", "camera_head", "depth_head")}
    images = rng.random((2, 3, 28, 56)).astype(np.float32)
    want = tinf.depth_and_camera(lean, cfg, images, camera_index=1,
                                 device="cpu")
    calls = []
    dpt = tinf.dpt_head_forward
    monkeypatch.setattr(tinf, "dpt_head_forward",
                        lambda p, *a, **k: calls.append(p) or dpt(p, *a,
                                                                   **k))
    got = tinf.depth_and_camera(full, cfg, images, camera_index=1,
                                device="cpu")
    assert len(calls) == 1 and calls[0] is full["depth_head"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_published_track_predictor_matches_jax(rng):
    """The track head's published tracker (features 128, 7 correlation
    levels, which 70 x 70 features reach at 1 x 1; hidden 384, depth 6) on
    the same features over 2 refinements: the first to 1e-5, the second
    and the visibility and confidence after it to 1e-4. With random
    weights each refinement multiplies a rounding difference ~25 times
    (4e-6 px after the first, 5e-2 px after the fourth), so the default 4
    are held in the tiny configs above."""
    cfg = jtrack.TrackHeadConfig(dim_in=64)
    p = _random(jtrack.init_track_predictor, 7, cfg)
    fm = rng.standard_normal((1, 2, 70, 70, 128)).astype(np.float32)
    qp = np.asarray([[[30.0, 40.0], [100.5, 71.25], [7.0, 130.0]]],
                    np.float32)
    want = jax.jit(lambda q, x, f: jtrack.track_predictor_forward(
        q, cfg, x, f, iters=2))(_j(p), jnp.asarray(qp), jnp.asarray(fm))
    got = ttrack.track_predictor_forward(
        tree_from_numpy(p), ttrack.TrackHeadConfig(dim_in=64), _t(qp),
        _t(fm), iters=2)
    _close(got[0][0].numpy(), want[0][0], 1e-5)
    _close(got[0][1].numpy(), want[0][1], 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].numpy(), want[2], 1e-4)


def test_convert_track_head_matches_jax(tmp_path):
    """``convert_track_head`` on a synthetic upstream-layout checkpoint:
    the tree equals ``track_head_params_from_jax`` of JAX's conversion leaf
    for leaf, and of the source tree."""
    p = _random(jtrack.init_track_head, 6, jtrack.TrackHeadConfig())
    zero_refine4_unit1(p["feature_extractor"])
    sd = {}
    track_head_sd(sd, p)
    path = _save(sd, str(tmp_path / "track.safetensors"), "float32")
    got = tcv.convert_track_head(load_state_dict(path), device="cpu")
    want = track_head_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcv.convert_track_head(
            {k: np.asarray(v) for k, v in sd.items()})))
    _assert_same(got, want)
    _assert_same(got, track_head_params_from_jax(p))
    assert len(got["tracker"]["updateformer"]["v2p"]) == 6
