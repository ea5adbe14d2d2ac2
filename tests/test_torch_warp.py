"""The port's VGGT warp against the JAX package's, on the CPU.

Geometry, the camera trajectories and the z-buffer splat against their
JAX counterparts, and ``warp_single_image`` end to end on a seeded 48x64
depth map and image for all 10 directions of ``vggt_camera_seq``, with and
without the depth-aware crack fill: the masks bit-identical, the frames
equal or within one uint8 step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.warp import cameras as jcam
from worldforge_tpu.warp import geometry as jgeo
from worldforge_tpu.warp import splat as jsplat
from worldforge_tpu.warp import vggt_warp as jwarp
from worldforge_tpu_torch.warp import cameras as tcam
from worldforge_tpu_torch.warp import geometry as tgeo
from worldforge_tpu_torch.warp import splat as tsplat
from worldforge_tpu_torch.warp import vggt_warp as twarp

torch.set_num_threads(2)

DIRECTIONS = ("up", "down", "left", "right", "forward", "backward",
              "up_pan", "down_pan", "left_pan", "right_pan")


def _scene(seed=0, h=48, w=64):
    """A smooth depth map (a slanted plane with a bump) with a few invalid
    pixels, its confidence, a textured image and a pinhole camera."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (2.0 + 0.01 * xx + 0.02 * yy
             + 0.5 * np.exp(-((xx - 40) ** 2 + (yy - 20) ** 2) / 60.0))
    depth = (depth + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    depth[rng.random((h, w)) < 0.01] = np.nan
    conf = (1.0 + rng.random((h, w)) * 4).astype(np.float32)
    image = rng.random((h, w, 3)).astype(np.float32)
    f = 0.9 * w
    intrinsic = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                         np.float64)
    extrinsic = np.eye(4)[:3].copy()
    extrinsic[:, 3] = rng.standard_normal(3) * 0.1
    return depth, conf, image, intrinsic, extrinsic


def test_geometry_matches_jax(rng):
    """Bit for bit: the port's 3x3 products are the JAX CPU dot's FMA
    chain."""
    depth, _, _, k, e = _scene()
    d = np.nan_to_num(depth)
    want = np.asarray(jgeo.unproject_depth(jnp.asarray(d), jnp.asarray(k)))
    got = tgeo.unproject_depth(torch.from_numpy(d), k)
    np.testing.assert_array_equal(got.numpy(), want)
    e44 = np.eye(4)
    e44[:3] = e
    pts = (rng.standard_normal((3, 50)) + [[0], [0], [3]]).astype(np.float32)
    for jf, tf in ((jgeo.cam_to_world, tgeo.cam_to_world),
                   (jgeo.world_to_cam, tgeo.world_to_cam)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(pts), e44).numpy(),
            np.asarray(jf(jnp.asarray(pts), jnp.asarray(e44))))
    uv_j, z_j = jgeo.project(jnp.asarray(pts), jnp.asarray(k))
    uv_t, z_t = tgeo.project(torch.from_numpy(pts), k)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_camera_seq_matches_jax(direction):
    e = _scene()[4]
    np.testing.assert_array_equal(
        tcam.vggt_camera_seq(e, direction, 15.0, 9, 2.5),
        jcam.vggt_camera_seq(e, direction, 15.0, 9, 2.5))


def test_splat_nearest_matches_jax(rng):
    """Points in front of and behind the camera, out of frame, on ties in
    z (the lower point index wins) and on the border."""
    h, w, n = 12, 16, 600
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1, 1, n),
                    rng.choice([-1.0, 0.0, 1.0, 2.0, 2.5], n)]
                   ).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    k = np.array([[8.0, 0, 8], [0, 8.0, 6], [0, 0, 1]], np.float32)
    want = jsplat.splat_nearest(jnp.asarray(pts), jnp.asarray(cols),
                                jnp.asarray(k), jnp.asarray(valid), h=h, w=w)
    got = tsplat.splat_nearest(torch.from_numpy(pts), torch.from_numpy(cols),
                               k, torch.from_numpy(valid), h=h, w=w)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the same points as two frames of one call
    two = tsplat.splat_nearest(torch.from_numpy(np.stack([pts, pts])),
                               torch.from_numpy(cols), k,
                               torch.from_numpy(valid), h=h, w=w)
    for a, b in zip(two, got):
        np.testing.assert_array_equal(a[1].numpy(), b.numpy())


@pytest.mark.parametrize("depth_aware", [True, False])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_warp_single_image_matches_jax(direction, depth_aware):
    depth, conf, image, k, e = _scene()
    kw = dict(direction=direction, degree=15.0, conf_threshold=0.8,
              frame_num=9, look_at_depth=1.0,
              disable_depth_aware_fill=not depth_aware)
    wi, wm, winfo = jwarp.warp_single_image(e, k, image, depth, conf, **kw)
    gi, gm, ginfo = twarp.warp_single_image(e, k, image, depth, conf,
                                            device="cpu", **kw)
    assert ginfo == winfo and len(gm) == len(wm) == 9
    for a, b in zip(gm, wm):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gi, wi):
        assert a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
