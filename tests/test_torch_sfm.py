"""The port's SfM path (``worldforge_tpu_torch/sfm/*``, the ALIKED and
tracker converters, the splat's numpy-renderer fallback) against the JAX
package's, on the CPU, in fp32.

The same seeded numpy inputs and (random-leaf) JAX weights carried over by
``io/from_jax.py`` on both sides. Tolerances, of the largest |output|:
one forward of a module or one refinement 1e-5; keypoints as score-sorted
sets, their integer pixels equal and their refined positions, scores and
descriptors to 1e-5; host code (FPS, ranking, SIFT, the COLMAP files)
exactly equal.

A random-init tracker is chaotic: a coordinate head of random weights
moves a track by pixels per refinement and a rounding difference grows
~400 times per coarse refinement (a 1e-6 change of the images moves the
sixth refinement's tracks by ~30 px, both packages alike). The whole
tracker and ``predict_tracks`` are therefore held with the coordinate
columns of both flow heads scaled by 0.01 (``_damped``): each refinement
then moves a track by a fraction of a pixel, as a trained tracker's late
refinements do, and the full-scale heads are held one refinement at a
time.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_aliked import aliked_to_torch_layout
from tests.test_torch_convert import (_assert_same, _conv, _lin, _ln,
                                      _random_tree, attn_block_sd)
from worldforge_tpu.io import convert_aliked as jca
from worldforge_tpu.io import convert_sfm_tracker as jcs
from worldforge_tpu.sfm import aliked as jal
from worldforge_tpu.sfm import colmap_export as jcol
from worldforge_tpu.sfm import distortion as jdist
from worldforge_tpu.sfm import extractors as jext
from worldforge_tpu.sfm import projection as jproj
from worldforge_tpu.sfm import superpoint as jsp
from worldforge_tpu.sfm import track_predict as jtp
from worldforge_tpu.sfm import tracker as jtr
from worldforge_tpu.sfm import utils as jutils
from worldforge_tpu.warp import splat as jsplat
from worldforge_tpu_torch.io import convert_aliked as tca
from worldforge_tpu_torch.io import convert_sfm_tracker as tcs
from worldforge_tpu_torch.io.from_jax import (aliked_params_from_jax,
                                              sfm_tracker_params_from_jax,
                                              superpoint_params_from_jax)
from worldforge_tpu_torch.sfm import aliked as tal
from worldforge_tpu_torch.sfm import colmap_export as tcol
from worldforge_tpu_torch.sfm import distortion as tdist
from worldforge_tpu_torch.sfm import extractors as text
from worldforge_tpu_torch.sfm import projection as tproj
from worldforge_tpu_torch.sfm import superpoint as tsp
from worldforge_tpu_torch.sfm import track_predict as ttp
from worldforge_tpu_torch.sfm import tracker as ttr
from worldforge_tpu_torch.sfm import utils as tutils
from worldforge_tpu_torch.warp import splat as tsplat

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


def _random(init, seed, *args):
    """A JAX init's tree with random leaves (numpy); BatchNorm running
    variances drawn from U(0.5, 1.5), as a variance is positive."""
    tree = _random_tree(jax.eval_shape(lambda k: init(k, *args),
                                       jax.random.key(0)),
                        np.random.default_rng(seed))
    r = np.random.default_rng(seed + 1000)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: r.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']") else a, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _damped(tree, f=0.01):
    """The tracker tree with the (dx, dy) columns of both flow heads
    scaled by ``f``."""
    tree = jax.tree_util.tree_map(np.copy, tree)
    for k in ("coarse_predictor", "fine_predictor"):
        fh = tree[k]["updateformer"]["flow_head"]
        fh["w"][:, :2] *= f
        fh["b"][:2] *= f
    return tree


@pytest.fixture(scope="module")
def tracker():
    """The published-width VGGSfM tracker (coarse and fine) with random
    leaves, as numpy."""
    return _random(lambda k: jtr.init_sfm_tracker(k), 11)


def _grid(img, n=4):
    h, w = img.shape[:2]
    ys, xs = np.meshgrid((np.arange(n) + 0.5) * h / n + 0.3,
                         (np.arange(n) + 0.5) * w / n - 0.2, indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)


# ------------------------------------------------- distortion, projection


@pytest.mark.parametrize("k", [1, 2, 4])
def test_distortion_matches_jax(rng, k):
    """Radial terms up to 0.1 and tangential ones up to 0.01, where the
    Newton inversion converges (a tangential 0.09 leaves points that
    neither package inverts, each wandering its own way)."""
    params = rng.uniform(-0.1, 0.1, (2, k)).astype(np.float32)
    params[:, 2:] *= 0.1
    tracks = rng.uniform(-0.6, 0.6, (2, 30, 2)).astype(np.float32)
    _close(tdist.single_undistortion(_t(params), _t(tracks)).numpy(),
           jdist.single_undistortion(jnp.asarray(params),
                                     jnp.asarray(tracks)), 1e-6)
    want = jax.jit(lambda a, b: jdist.iterative_undistortion(a, b, 30))(
        jnp.asarray(params), jnp.asarray(tracks))
    got = tdist.iterative_undistortion(_t(params), _t(tracks), 30)
    _close(got.numpy(), want, 1e-5)
    redo = tdist.single_undistortion(_t(params), got)
    _close(redo.numpy(), tracks, 1e-4)


def test_projection_matches_jax(rng):
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pts[0] = [0.0, 0.0, 0.0]                 # z = 0 in camera 0: NaN -> 0
    ext = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    ext[1, :, 3] = [0.3, -0.1, 0.2]
    k = np.tile(np.array([[100, 0, 50], [0, 110, 40], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    dist = rng.uniform(-0.05, 0.05, (2, 4)).astype(np.float32)
    for extra in (None, dist):
        want, wcam = jproj.project_3d_points(
            jnp.asarray(pts), jnp.asarray(ext), jnp.asarray(k),
            None if extra is None else jnp.asarray(extra))
        got, gcam = tproj.project_3d_points(
            _t(pts), _t(ext), _t(k), None if extra is None else _t(extra))
        _close(gcam.numpy(), wcam, 1e-6)
        g, w = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w) & (np.abs(w) < 1e30)
        _close(g[fin], w[fin], 1e-6)


def test_fps_ranking_and_index_utils(rng):
    dm = rng.uniform(0, 10, (9, 9))
    assert tutils.farthest_point_sampling(dm, 5, 3) == \
        jutils.farthest_point_sampling(dm, 5, 3)
    for spatial, shape in ((False, (7, 16)), (True, (7, 5, 16))):
        f = rng.standard_normal(shape)
        assert tutils.rank_frames_by_similarity(f, 4, spatial) == \
            jutils.rank_frames_by_similarity(f, 4, spatial)
    np.testing.assert_array_equal(tutils.calculate_index_mappings(3, 6),
                                  jutils.calculate_index_mappings(3, 6))
    x = rng.standard_normal((2, 6, 3))
    for a, b in zip(tutils.switch_tensor_order([x, None], [2, 1, 0], 1),
                    jutils.switch_tensor_order([x, None], [2, 1, 0], 1)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- keypoints


def _same_keypoints(got, want, tol=1e-5):
    """Valid keypoints as score-sorted sets: the same count, positions and
    descriptors to ``tol`` after sorting both by score."""
    gs, ws = got["scores"].numpy(), np.asarray(want["scores"])
    for b in range(gs.shape[0]):
        gv, wv = gs[b] > 0, ws[b] > 0
        assert gv.sum() == wv.sum() > 0
        go = np.argsort(-gs[b][gv], kind="stable")
        wo = np.argsort(-ws[b][wv], kind="stable")
        for key in ("scores", "keypoints", "descriptors"):
            g = got[key].numpy()[b][gv][go]
            w = np.asarray(want[key])[b][wv][wo]
            _close(g, w, tol)
        pad = got["keypoints"].numpy()[b][~gv]
        assert (pad == -1).all()


def test_superpoint_matches_jax(rng):
    """SuperPoint (tiny) on two grey images, one not a multiple of 8 (the
    heat map covers the largest multiple of 8 of it)."""
    cfg = jsp.SuperPointConfig.tiny()
    p = _random(jsp.init_superpoint, 12, cfg)
    for shape in ((2, 64, 48, 1), (1, 70, 66, 1)):
        img = rng.random(shape).astype(np.float32)
        want = jax.jit(lambda q, x: jsp.superpoint_forward(q, cfg, x))(
            _j(p), jnp.asarray(img))
        got = tsp.superpoint_forward(superpoint_params_from_jax(p),
                                     tsp.SuperPointConfig.tiny(), _t(img))
        _same_keypoints(got, want)


def test_simple_nms_and_top_k_ties():
    """Max-pool NMS as JAX's, and the top-k's tie order (the lower flat
    index first), which ``torch.topk`` does not promise."""
    s = np.zeros((1, 9, 9), np.float32)
    s[0, 2, 2], s[0, 2, 3], s[0, 6, 6] = 0.5, 0.9, 0.7
    np.testing.assert_array_equal(
        tsp.simple_nms(_t(s), 1).numpy(),
        np.asarray(jsp.simple_nms(jnp.asarray(s), 1)))
    x = np.asarray([[0.3, 0.7, 0.7, 0.1, 0.7, -1.0, -1.0]], np.float32)
    vals, idx = tsp.top_k(_t(x), 5)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


def test_aliked_pieces_match_jax(rng):
    """The deformable conv (offsets large enough to leave the map: zero
    padding per corner), the align-corners upsample, DKD on a batch whose
    second image has no peak above the threshold (its own mean is the
    threshold) and SDDH."""
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    dcn = {"offset": {"w": rng.standard_normal((3, 3, 6, 18)).astype(
        np.float32), "b": rng.standard_normal(18).astype(np.float32) * 2},
        "w": rng.standard_normal((3, 3, 6, 5)).astype(np.float32) * 0.3}
    _close(tal.deform_conv(
        jax.tree_util.tree_map(_t, dcn), _t(x)).numpy(),
        jax.jit(jal._deform_conv)(_j(dcn), jnp.asarray(x)), 1e-5)
    for f in (2, 8):
        _close(tal.upsample_ac(_t(x), f).numpy(),
               jal._upsample_ac(jnp.asarray(x), f), 1e-6)
    cfg = jal.ALIKEDConfig.tiny(max_num_keypoints=20)
    score = rng.random((2, 24, 28)).astype(np.float32)
    score[1] *= 0.004                        # below 0.005 everywhere
    want = jax.jit(lambda x: jal.dkd_detect(x, cfg))(jnp.asarray(score))
    got = tal.dkd_detect(_t(score), tal.ALIKEDConfig.tiny(
        max_num_keypoints=20))
    _close(got[0].numpy(), want[0], 1e-5)
    _close(got[1].numpy(), want[1], 1e-5)
    assert (got[1][1] > 0).sum() > 0 and (got[1][1] < 0.005).all()
    p = _random(jal.init_aliked, 13, cfg)
    feat = rng.standard_normal((2, 24, 28, cfg.dim)).astype(np.float32)
    _close(tal.sddh_describe(aliked_params_from_jax(p),
                             tal.ALIKEDConfig.tiny(), _t(feat),
                             got[0]).numpy(),
           jax.jit(lambda q, f, k: jal.sddh_describe(q, cfg, f, k))(
               _j(p), jnp.asarray(feat), want[0]), 1e-5)


def test_aliked_forward_matches_jax(rng):
    cfg = jal.ALIKEDConfig.tiny()
    p = _random(jal.init_aliked, 14, cfg)
    img = rng.random((2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(lambda q, x: jal.aliked_forward(q, cfg, x))(
        _j(p), jnp.asarray(img))
    got = tal.aliked_forward(aliked_params_from_jax(p), tal.ALIKEDConfig.tiny(),
                             _t(img))
    _same_keypoints(got, want)
    np.testing.assert_array_equal(
        tal.pad_to_multiple(img[0, :50, :70]),
        jal.pad_to_multiple(img[0, :50, :70]))


def test_extractors_match_jax(rng):
    """SIFT exactly equal (both are cv2 on the host); ALIKED + SuperPoint
    through ``make_extractors`` with carried weights on an image whose size
    is not a multiple of 32, combined as sets; random init on the CPU and
    an unknown method's fallback."""
    img = np.kron(rng.uniform(0, 1, (6, 7)) > 0.5,
                  np.ones((16, 16)))[..., None].repeat(3, -1)
    img = (0.8 * img + 0.2 * rng.random(img.shape)).astype(np.float32)
    np.testing.assert_array_equal(text.sift_extract(img, 100),
                                  jext.sift_extract(img, 100))
    acfg, scfg = jal.ALIKEDConfig.tiny(), jsp.SuperPointConfig.tiny()
    ap, sp = _random(jal.init_aliked, 15, acfg), \
        _random(jsp.init_superpoint, 16, scfg)
    kw = dict(max_query_num=40, aliked_cfg=acfg, superpoint_cfg=scfg)
    jx = jext.make_extractors("aliked+sp+sift", aliked_params=_j(ap),
                              superpoint_params=_j(sp), **kw)
    kw.update(aliked_cfg=tal.ALIKEDConfig.tiny(),
              superpoint_cfg=tsp.SuperPointConfig.tiny())
    tx = text.make_extractors("aliked+sp+sift",
                              aliked_params=aliked_params_from_jax(ap),
                              superpoint_params=superpoint_params_from_jax(
                                  sp), device="cpu", **kw)
    assert list(tx) == list(jx) == ["aliked", "sp", "sift"]
    for name in tx:
        g, w = tx[name](img), np.asarray(jx[name](img))
        assert g.shape == w.shape and g.shape[0] > 0, name
        _close(g[np.lexsort(g.T)], w[np.lexsort(w.T)], 1e-5)
    both = text.combined_extract_fn(tx, round_keypoints=True)(img)
    assert both.shape[0] == sum(fn(img).shape[0] for fn in tx.values())
    assert (both == np.round(both)).all()
    fresh = text.make_extractors("bogus", max_query_num=8, device="cpu")
    assert list(fresh) == ["aliked"] and fresh["aliked"](img).shape[1] == 2


# ------------------------------------------------------------- tracker


def test_encoders_match_jax(rng, tracker):
    img = rng.random((2, 64, 48, 3)).astype(np.float32)
    want = jax.jit(jtr.basic_encoder_forward)(_j(tracker["coarse_fnet"]),
                                              jnp.asarray(img))
    got = ttr.basic_encoder_forward(
        sfm_tracker_params_from_jax(tracker["coarse_fnet"]), _t(img))
    assert got.shape == (2, 16, 12, 128)
    _close(got.numpy(), want, 1e-5)
    patch = rng.random((5, 31, 31, 3)).astype(np.float32)
    want = jax.jit(jtr.shallow_encoder_forward)(_j(tracker["fine_fnet"]),
                                                jnp.asarray(patch))
    got = ttr.shallow_encoder_forward(
        sfm_tracker_params_from_jax(tracker["fine_fnet"]), _t(patch))
    assert got.shape == (5, 31, 31, 32)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_predictor_one_refinement_matches_jax(rng, tracker, which):
    """The coarse predictor (space attention, visibility; a 16 x 12 map
    whose 5-level pyramid reaches 1 x 1, where the size-1 axes collapse)
    and the fine one at full-scale random weights, one refinement."""
    jcfg = jtr.SfmTrackerConfig.coarse() if which == "coarse" else \
        jtr.SfmTrackerConfig.fine_cfg()
    tcfg = ttr.SfmTrackerConfig.coarse() if which == "coarse" else \
        ttr.SfmTrackerConfig.fine_cfg()
    p = tracker[f"{which}_predictor"]
    if which == "coarse":
        fm = rng.standard_normal((1, 3, 16, 12, 128)).astype(np.float32)
        qp = np.asarray([[[20.3, 30.1], [70.0, 9.5]]], np.float32)
        kw = {"down_ratio": 2}
    else:
        fm = rng.standard_normal((4, 3, 31, 31, 32)).astype(np.float32)
        qp = rng.uniform(14, 17, (4, 1, 2)).astype(np.float32)
        kw = {}
    want = jax.jit(lambda q, x, f: jtr.sfm_predictor_forward(
        q, jcfg, x, f, iters=1, **kw))(_j(p), jnp.asarray(qp),
                                       jnp.asarray(fm))
    got = ttr.sfm_predictor_forward(sfm_tracker_params_from_jax(p), tcfg,
                                    _t(qp), _t(fm), iters=1, **kw)
    _close(got[0][0].numpy(), want[0][0], 1e-5)
    if which == "coarse":
        _close(got[1].numpy(), want[1], 1e-5)
    else:
        assert got[1] is None and want[1] is None


def test_refine_track_matches_jax_and_clamps_by_height(rng, tracker):
    """``refine_track`` (one fine refinement) on a 48 x 96 image. Both
    packages clamp the patch corner by H in x too (the reference's H = W
    assumption): a track at x = 80 takes its patch from columns 17..47, so
    changing the image right of column 48 changes nothing, in the port as
    in JAX."""
    images = rng.random((1, 2, 48, 96, 3)).astype(np.float32)
    coarse = np.asarray([[[[80.4, 20.6], [30.2, 25.0]],
                          [[81.7, 22.1], [29.0, 24.3]]]], np.float32)
    tp = sfm_tracker_params_from_jax(tracker)

    def both(img):
        w = jax.jit(lambda i, a, b, c: jtr.refine_track(
            i, a, b, c, fine_iters=1))(
            jnp.asarray(img), _j(tracker["fine_fnet"]),
            _j(tracker["fine_predictor"]), jnp.asarray(coarse))
        g = ttr.refine_track(_t(img), tp["fine_fnet"], tp["fine_predictor"],
                             _t(coarse), fine_iters=1)
        return g.numpy(), np.asarray(w)

    got, want = both(images)
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(got[:, 0], coarse[:, 0])
    right = images.copy()                    # columns 48.. changed
    right[..., 48:, :] = rng.random(right[..., 48:, :].shape)
    got2, want2 = both(right)
    np.testing.assert_array_equal(got2[:, 1, 0], got[:, 1, 0])
    np.testing.assert_array_equal(want2[:, 1, 0], want[:, 1, 0])
    inside = images.copy()                   # the clamped patch changed
    inside[:, 1, 5:36, 17:48] = rng.random((31, 31, 3))
    got3, want3 = both(inside)
    assert not np.array_equal(got3[:, 1, 0], got[:, 1, 0])
    _close(got3, want3, 1e-5)


# JAX's tracker calls jitted once for the module: the whole-tracker test
# and ``predict_tracks``' first query frame share a compile
_JAX_TRACKER = jax.jit(jtr.sfm_tracker_forward, static_argnames=(
    "coarse_iters", "fine_tracking", "coarse_down_ratio"))
_JAX_FMAPS = jax.jit(jtr.compute_tracker_fmaps,
                     static_argnames=("coarse_down_ratio",))


def test_sfm_tracker_forward_matches_jax(rng, tracker):
    """The whole tracker (2 coarse refinements, the fine refinement) on 3
    frames of 128 x 128, coordinate heads damped; the port computes its
    own feature maps, JAX is given ``compute_tracker_fmaps``' (the same
    function its forward calls when given none); tracks to 1e-5 of the
    largest |track|; visibility to 1e-3 (its features take full-scale
    updates)."""
    damped = _damped(tracker)
    images = rng.random((1, 3, 128, 128, 3)).astype(np.float32)
    qp = _grid(images[0, 0])[None]
    jp, jim = _j(damped), jnp.asarray(images)
    want = _JAX_TRACKER(jp, jim, jnp.asarray(qp), coarse_iters=2,
                        fine_tracking=True, fmaps=_JAX_FMAPS(jp, jim))
    got = ttr.sfm_tracker_forward(sfm_tracker_params_from_jax(damped),
                                  _t(images), _t(qp), coarse_iters=2)
    _close(got[0].numpy(), want[0], 1e-5)
    _close(got[1].numpy(), want[1], 1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-3)
    assert np.abs(got[0].numpy() - qp[:, None]).max() > 0.1   # moved


# ------------------------------------------------------- predict_tracks


@pytest.fixture
def jax_tracker_jitted(monkeypatch):
    """JAX's ``predict_tracks`` with its tracker calls jitted (the same
    functions, compiled once per shape instead of run op by op)."""
    monkeypatch.setattr(jtp, "sfm_tracker_forward", _JAX_TRACKER)
    monkeypatch.setattr(jtp, "compute_tracker_fmaps", _JAX_FMAPS)


def _predict_both(tracker, images, **kw):
    damped = _damped(tracker)
    want = jtp.predict_tracks(_j(damped), images, **kw)
    got = ttp.predict_tracks(sfm_tracker_params_from_jax(damped), images,
                             device="cpu", **kw)
    return got, want


def _same_prediction(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w, 1e-4)
    np.testing.assert_array_equal(got[4], want[4])       # colours


def test_predict_tracks_matches_jax(rng, tracker, jax_tracker_jitted):
    """3 frames, 2 query frames of the grid extractor, the fine refinement,
    no augmentation: shapes, each query frame's rows pinned to its
    keypoints, and every output against JAX's."""
    images = rng.random((3, 128, 128, 3)).astype(np.float32)
    got, want = _predict_both(tracker, images, extract_fn=_grid,
                              query_frame_num=2, complete_non_vis=False,
                              coarse_iters=2)
    tracks, vis, confs, p3d, colors = got
    assert tracks.shape == (3, 32, 2) and vis.shape == (3, 32)
    assert confs is None and p3d is None and colors.shape == (32, 3)
    np.testing.assert_allclose(tracks[0, :16], _grid(images[0]), atol=1e-5)
    np.testing.assert_allclose(tracks[1, 16:], _grid(images[1]), atol=1e-5)
    _same_prediction(got, want)


def test_predict_tracks_conf_gating_matches_jax(rng, tracker,
                                                jax_tracker_jitted):
    """Confidence and 3D points read at the keypoints; keypoints under
    conf 1.2 dropped only when more than 512 survive (of 16, none are
    dropped; of 625, those on the low rows are)."""
    images = rng.random((2, 128, 128, 3)).astype(np.float32)
    conf = rng.uniform(1.25, 2.5, (2, 64, 64)).astype(np.float32)
    conf[0, ::8] = 0.5                         # an eighth under 1.2
    p3d = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    kw = dict(conf=conf, points_3d=p3d, query_frame_num=1,
              fine_tracking=False, complete_non_vis=False, coarse_iters=1)
    got, want = _predict_both(tracker, images, extract_fn=_grid, **kw)
    assert got[2].shape == (16,) and got[3].shape == (16, 3)
    _same_prediction(got, want)
    many = lambda img: _grid(img, 25)          # noqa: E731 (625 points)
    got, want = _predict_both(tracker, images, extract_fn=many, **kw)
    assert 512 < got[2].shape[0] < 625 and (got[2] > 1.2).all()
    _same_prediction(got, want)


def test_predict_tracks_augmentation_matches_jax(rng, tracker,
                                                 jax_tracker_jitted, capsys):
    """The non-visible-frame loop: every frame short of ``min_vis``, frame
    0 re-queried, then the final trial over every failing frame with the
    fresh extractor; without one, the same extractor and a warning."""
    images = rng.random((2, 128, 128, 3)).astype(np.float32)
    kw = dict(extract_fn=_grid, query_frame_num=1, fine_tracking=False,
              complete_non_vis=True, min_vis=10 ** 6, non_vis_thresh=2.0,
              coarse_iters=1)
    fresh = lambda img: _grid(img, 2) + 3.0   # noqa: E731
    got, want = _predict_both(tracker, images,
                              final_trial_extract_fn=fresh, **kw)
    # the query run, frame 0 again, then the final trial on frames 0 and 1
    assert got[0].shape == (2, 16 + 16 + 4 + 4, 2)
    np.testing.assert_allclose(got[0][1, -4:], fresh(images[1]), atol=1e-5)
    _same_prediction(got, want)
    got, want = _predict_both(tracker, images, **kw)
    assert got[0].shape == (2, 16 * 4, 2)
    assert "no final_trial_extract_fn" in capsys.readouterr().out
    _same_prediction(got, want)


# ----------------------------------------------------------- COLMAP


def test_colmap_files_equal_jax(tmp_path, rng):
    """``build_reconstruction`` with masks and with the reprojection gate,
    ``write_text``: cameras.txt, images.txt and points3D.txt byte for byte
    JAX's; the gate's masks and the per-frame minimum as JAX's."""
    n, p = 3, 90
    pts = rng.uniform(-1, 1, (p, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    a = rng.standard_normal((n, 3, 3))
    ext = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, r = np.linalg.qr(a[i])
        ext[i, :, :3] = q * np.sign(np.diag(r))
        ext[i, :, 3] = rng.uniform(-0.3, 0.3, 3)
    k = np.tile(np.array([[120, 0, 64], [0, 125, 48], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    p2d = np.asarray(jproj.project_3d_points(pts, ext, k)[0])
    tracks = p2d + rng.normal(0, 1.5, p2d.shape).astype(np.float32)
    masks = rng.random((n, p)) > 0.3
    rgb = rng.integers(0, 256, (p, 3))
    for kw in ({"masks": masks, "min_inlier_per_frame": 8},
               {"masks": masks, "max_reproj_error": 2.0,
                "min_inlier_per_frame": 8, "camera_type": "PINHOLE"},
               {"max_reproj_error": 2.0, "min_inlier_per_frame": 8,
                "shared_camera": True, "camera_type": "SIMPLE_RADIAL",
                "extra_params": rng.uniform(-0.1, 0.1, (n, 1))}):
        want, wvalid = jcol.build_reconstruction(
            pts, ext, k, tracks, (128, 96), points_rgb=rgb, **kw)
        got, gvalid = tcol.build_reconstruction(
            pts, ext, k, tracks, (128, 96), points_rgb=rgb, **kw)
        np.testing.assert_array_equal(gvalid, wvalid)
        want.write_text(str(tmp_path / "jax"))
        got.write_text(str(tmp_path / "port"))
        for name in ("cameras.txt", "images.txt", "points3D.txt"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    assert tcol.build_reconstruction(
        pts, ext, k, tracks, (128, 96), masks=masks,
        min_inlier_per_frame=p) == (None, None)
    np.testing.assert_array_equal(tcol.rotmat_to_qvec(ext[1, :, :3]),
                                  jcol.rotmat_to_qvec(ext[1, :, :3]))


# -------------------------------------------------------- converters


def test_convert_aliked_matches_jax():
    """The published N16 layout from the frozen manifest with random
    values: the tree equals JAX's conversion carried over, leaf for leaf;
    a missing and an unread key fail as JAX's do."""
    with open(os.path.join(FIX, "aliked_manifest.json")) as f:
        manifest = json.load(f)
    r = np.random.default_rng(17)
    sd = {k: r.standard_normal(s).astype(np.float32)
          for k, s in manifest.items()}
    got = tca.convert_aliked({k: _t(v) for k, v in sd.items()},
                             tal.ALIKEDConfig.n16(), device="cpu")
    want = aliked_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jca.convert_aliked(sd, jal.ALIKEDConfig.n16())))
    _assert_same(got, want)
    assert got["block3"]["bn1"]["var"].shape == (64,)
    tiny = jal.ALIKEDConfig.tiny()
    sd = aliked_to_torch_layout(_random(jal.init_aliked, 18, tiny))
    broken = {k: _t(np.asarray(v)) for k, v in sd.items()
              if k != "score_head.6.weight"}
    with pytest.raises(ValueError, match="missing key.*score_head"):
        tca.convert_aliked(broken, tal.ALIKEDConfig.tiny(), device="cpu")
    extra = {k: _t(np.asarray(v)) for k, v in sd.items()}
    extra["brand_new.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="never consumed"):
        tca.convert_aliked(extra, tal.ALIKEDConfig.tiny(), device="cpu")


def _res_sd(sd, name, p):
    _conv(sd, f"{name}.conv1", p["conv1"])
    _conv(sd, f"{name}.conv2", p["conv2"])
    if "down" in p:
        _conv(sd, f"{name}.downsample.0", p["down"])


def _predictor_sd(sd, pre, p):
    u = p["updateformer"]
    _lin(sd, f"{pre}.updateformer.input_transform", u["input_transform"])
    _lin(sd, f"{pre}.updateformer.flow_head", u["flow_head"])
    blocks = [("time_blocks", "time_blocks", "attn")]
    if "virtual" in u:
        sd[f"{pre}.updateformer.virual_tracks"] = np.asarray(u["virtual"])
        blocks += [("space_virtual", "space_virtual_blocks", "attn"),
                   ("v2p", "space_virtual2point_blocks", "cross_attn"),
                   ("p2v", "space_point2virtual_blocks", "cross_attn")]
    for key, name, attn in blocks:
        for i, blk in enumerate(u[key]):
            attn_block_sd(sd, f"{pre}.updateformer.{name}.{i}", blk, attn)
    _ln(sd, f"{pre}.norm", p["norm"])
    _lin(sd, f"{pre}.ffeat_updater.0", p["ffeat_updater"])
    if "vis_predictor" in p:
        _lin(sd, f"{pre}.vis_predictor.0", p["vis_predictor"])


def test_convert_sfm_tracker_and_superpoint_match_jax(tracker):
    """A synthetic upstream-layout VGGSfM tracker and SuperPoint, written
    from random trees: the port's conversions equal JAX's carried over and
    the source trees, leaf for leaf."""
    sd = {}
    cf = tracker["coarse_fnet"]
    for k in ("conv1", "conv2", "conv3"):
        _conv(sd, f"coarse_fnet.{k}", cf[k])
    for i in range(1, 5):
        _res_sd(sd, f"coarse_fnet.layer{i}.0", cf[f"layer{i}a"])
        _res_sd(sd, f"coarse_fnet.layer{i}.1", cf[f"layer{i}b"])
    ff = tracker["fine_fnet"]
    _conv(sd, "fine_fnet.conv1", ff["conv1"])
    _res_sd(sd, "fine_fnet.layer1", ff["layer1"])
    _res_sd(sd, "fine_fnet.layer2", ff["layer2"])
    _conv(sd, "fine_fnet.conv2", ff["conv2"])
    _predictor_sd(sd, "coarse_predictor", tracker["coarse_predictor"])
    _predictor_sd(sd, "fine_predictor", tracker["fine_predictor"])
    got = tcs.convert_sfm_tracker({k: _t(v) for k, v in sd.items()},
                                  device="cpu")
    want = sfm_tracker_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcs.convert_sfm_tracker(sd)))
    _assert_same(got, want)
    _assert_same(got, sfm_tracker_params_from_jax(tracker))
    cfg = jsp.SuperPointConfig.tiny()
    sp = _random(jsp.init_superpoint, 19, cfg)
    ssd = {}
    for name, p in sp.items():
        _conv(ssd, name, p)
    got = tsp.convert_superpoint({k: _t(v) for k, v in ssd.items()},
                                 tsp.SuperPointConfig.tiny(), device="cpu")
    want = superpoint_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jsp.convert_superpoint(ssd, cfg)))
    _assert_same(got, want)
    _assert_same(got, superpoint_params_from_jax(sp))


# ------------------------------------------------------------ splat


@pytest.mark.parametrize("round_first", [False, True])
def test_splat_nearest_round_first_matches_jax(round_first):
    """Points at u = -0.4, W - 0.4 and W - 0.6 (and v likewise): the two
    border rules, as JAX's."""
    h, w = 6, 8
    u = np.asarray([-0.4, w - 0.4, w - 0.6, 3.0, 2.2, -0.6], np.float64)
    v = np.asarray([2.0, 3.0, 1.0, h - 0.4, -0.3, 4.0], np.float64)
    z = np.asarray([2.0, 3.0, 1.5, 2.5, 1.0, 2.0])
    pc = np.stack([u * z, v * z, z]).astype(np.float32)      # K = I
    colors = np.arange(18, dtype=np.float32).reshape(6, 3)
    want = jsplat.splat_nearest(jnp.asarray(pc), jnp.asarray(colors),
                                jnp.eye(3), jnp.ones(6, bool), h=h, w=w,
                                round_first=round_first)
    got = tsplat.splat_nearest(_t(pc), _t(colors), np.eye(3, dtype=np.float32),
                               torch.ones(6, dtype=torch.bool), h=h, w=w,
                               round_first=round_first)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert bool(got[1][2, 0]) == round_first      # u = -0.4 in column 0


def test_render_points_nearest_matches_jax(rng):
    """The numpy renderer's fallback: the round-first splat, the 3x3 close
    and griddata colours in the closed cracks; image and mask equal."""
    h, w = 40, 56
    n = 500
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(3.0, 4.0, n)], -1)
    feats = rng.random((n, 3)).astype(np.float32)
    ext = np.eye(4)
    ext[:3, 3] = [0.05, -0.02, 0.1]
    k = np.array([[30.0, 0, 28], [0, 30.0, 20], [0, 0, 1]])
    gi, gm = tsplat.render_points_nearest(pts, feats, ext, k, h, w,
                                          device="cpu")
    wi, wm = jsplat.render_points_nearest(pts, feats, ext, k, h, w)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gi, wi)
    assert 0 < gm.mean() < 1 and ((gm > 0) & ~(gi > 0).any(-1)).sum() < 5
