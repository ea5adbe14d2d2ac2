"""The port's DepthCrafter (video 4D) warp against the JAX package's, on
the CPU.

The trajectories (every direction, the stable schedule, zoom in and out,
the circle), the unprojection, the disk splat (masks and frames bit-equal:
the 3x3 products are the JAX CPU dot's FMA chain, ``warp/geometry._mat3``),
the depth-edge point filter, ``warp_video`` with the edge filter on and off
(masks and frames bit-equal) and the point-cloud export, on seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.warp import cameras as jcam
from worldforge_tpu.warp import dc_warp as jwarp
from worldforge_tpu.warp import edge_filter as jedge
from worldforge_tpu.warp import geometry as jgeo
from worldforge_tpu.warp import pcd as jpcd
from worldforge_tpu.warp import splat as jsplat
from worldforge_tpu_torch.warp import cameras as tcam
from worldforge_tpu_torch.warp import dc_warp as twarp
from worldforge_tpu_torch.warp import edge_filter as tedge
from worldforge_tpu_torch.warp import geometry as tgeo
from worldforge_tpu_torch.warp import pcd as tpcd
from worldforge_tpu_torch.warp import splat as tsplat

torch.set_num_threads(2)


def _video(seed=0, t=4, h=400, w=432):
    """Normalised depth with a sharp step (so the edge filter drops
    points) drifting over the frames, and textured frames. At 400 rows the
    splat's radius is 1 px (0.005 of half the shorter side), so the points
    cover the pixels they move over; at a smaller size they leave holes
    that the 5x5 open turns into empty masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / 10
    depth = []
    for i in range(t):
        d = 0.3 + 0.004 * xx + 0.002 * yy
        d = np.where((xx - 2 * i > 20) & (xx - 2 * i < 38) & (yy > 10)
                     & (yy < 30), d + 0.45, d)
        depth.append(d + 0.0005 * rng.standard_normal((h, w)))
    depth = np.stack(depth).astype(np.float32)
    depth = (depth - depth.min()) / (depth.max() - depth.min())
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    return frames, depth


CAMERA_CASES = [
    dict(direction=d) for d in ("up", "down", "left", "right")
] + [
    dict(direction="up", stable=True, stable_frame=5),
    dict(direction="left", stable=True, stable_frame=20),
    dict(direction="right", zoom="zoom_in", rate=0.8),
    dict(direction="down", zoom="zoom_out", rate=0.6, stable=True,
         stable_frame=4),
    dict(direction="right", circle_radius=0.2),
    dict(direction="left", circle_radius=0.35),
]


@pytest.mark.parametrize("kw", CAMERA_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_dc_camera_seq_matches_jax(kw):
    want = jcam.dc_camera_seq(degree=20.0, frame_num=9, look_at_depth=1.7,
                              **kw)
    got = tcam.dc_camera_seq(degree=20.0, frame_num=9, look_at_depth=1.7,
                             **kw)
    assert got.shape == (9, 4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_dc_unproject_matches_jax(rng):
    inv = (1.0 / (rng.random((13, 21)) + 0.1)).astype(np.float32)
    want = jgeo.dc_unproject(jnp.asarray(inv), f=525.0)
    got = tgeo.dc_unproject(torch.from_numpy(inv), f=525.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tgeo.dc_intrinsic(13, 21),
                                  jgeo.dc_intrinsic(13, 21))


@pytest.mark.parametrize("radius_ndc", [0.005, 0.05])
def test_splat_disk_matches_jax(rng, radius_ndc):
    """Points in front of and behind the camera, out of frame, and on ties
    in z (the lowest point id wins) under a trajectory camera."""
    h, w, n = 24, 32, 900
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                    rng.choice([-1.0, 0.5, 1.0, 1.5, 2.0], n)],
                   axis=-1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    cam = jcam.dc_camera_seq("right", 10.0, 5, 1.2)[3]
    k = jgeo.dc_intrinsic(h, w, 30.0)
    want = jsplat.splat_disk(jnp.asarray(pts), jnp.asarray(cols),
                             jnp.asarray(cam, jnp.float32), jnp.asarray(k),
                             h=h, w=w, radius_ndc=radius_ndc)
    got = tsplat.splat_disk(torch.from_numpy(pts), torch.from_numpy(cols),
                            cam, k, h=h, w=w, radius_ndc=radius_ndc)
    assert got[1].any()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    m = np.asarray(want[1]).astype(np.uint8)
    np.testing.assert_array_equal(tsplat.morph_open(m, 5),
                                  jsplat.morph_open(m, 5))


def test_edge_point_mask_matches_jax():
    _, depth = _video()
    inv = (1.0 / (depth[1] + 0.1)).astype(np.float64)
    for kw in ({}, dict(edge_threshold=0.3, edge_dilation=0),
               dict(depth_jump_threshold=0.0), dict(neighbor_check_radius=4)):
        want = jedge.edge_point_mask(inv, **kw)
        got = tedge.edge_point_mask(inv, **kw)
        np.testing.assert_array_equal(got, want)
    assert not want.all()


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("direction,extra", [
    ("up", {}), ("left", dict(zoom="zoom_in", rate=0.9)),
    ("right", dict(circle_radius=0.1)),
])
def test_warp_video_matches_jax(direction, extra, edge):
    frames, depth = _video()
    kw = dict(direction=direction, degree=12.0, look_at_depth=1.0,
              enable_edge_filter=edge, focal=400.0, **extra)
    wi, wm = jwarp.warp_video(frames, depth, **kw)
    gi, gm = twarp.warp_video(frames, depth, device="cpu", **kw)
    assert len(gi) == len(gm) == len(wi) == 4
    for a, b in zip(gm, wm):
        assert a.dtype == b.dtype and a.shape == (400, 432, 1)
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gi, wi):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert all(m.mean() > 0.05 for m in gm) and any(m.mean() < 1 for m in gm)


def test_pcd_matches_jax(tmp_path, rng):
    disp = (rng.random((3, 12, 20)) * 4 + 1).astype(np.float32)
    frame = rng.integers(0, 256, (12, 20, 3), np.uint8)
    dn_t, dn_j = tpcd.normalize_disparity(disp), jpcd.normalize_disparity(disp)
    np.testing.assert_array_equal(dn_t, dn_j)
    np.testing.assert_array_equal(tpcd.normalize_disparity(np.ones((2, 2))),
                                  jpcd.normalize_disparity(np.ones((2, 2))))
    for ds in (1, 8):
        pt, ct = tpcd.disparity_to_pointcloud(dn_t[1], frame, ds)
        pj, cj = jpcd.disparity_to_pointcloud(dn_j[1], frame, ds)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(ct, cj)
    path_t, path_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tpcd.write_ply(path_t, pt, ct)
    jpcd.write_ply(path_j, pj, cj)
    assert open(path_t, "rb").read() == open(path_j, "rb").read()
    back_p, back_c = tpcd.read_ply(path_j)
    np.testing.assert_array_equal(back_p, pj)
    np.testing.assert_array_equal(back_c, cj)
