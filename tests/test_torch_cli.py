"""The port's guided repaint CLI on the CPU, end to end, at a tiny size."""

import os

import numpy as np
import pytest
import torch

from worldforge_tpu_torch.cli import infer_worldforge as cli
from worldforge_tpu_torch.io import frames as tframes
from worldforge_tpu_torch.warp import masks as tmasks

torch.set_num_threads(2)


@pytest.fixture
def warp_dir(tmp_path):
    """A synthesized warp-stage directory: 5 frames + 5 masks, 40x56."""
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (40, 56, 3), np.uint8) for _ in range(5)]
    masks = [np.zeros((40, 56), np.uint8) for _ in range(5)]
    for i, m in enumerate(masks):
        m[8:32, 8 + i:40 + i] = 1
    d = str(tmp_path / "warp")
    tframes.save_warp_outputs(d, images, masks)
    return d


def test_cli_random_init_guided_on_cpu(warp_dir, tmp_path):
    out = str(tmp_path / "out.mp4")
    cli.main(["--video-ref", warp_dir, "--random-init", "--device", "cpu",
              "--guided", "--resize", "16", "16", "--num-frames", "5",
              "--num-inference-steps", "2", "--resample-steps", "2",
              "--guide-steps", "2", "--resample-round", "2",
              "--soften-mask", "--transition-distance", "3", "--save-png",
              "--output", out])
    assert os.path.getsize(out) > 0
    pngs = sorted(os.listdir(str(tmp_path / "out_frames")))
    assert len(pngs) == 5


def test_cli_streaming_vae_on_cpu(warp_dir, tmp_path):
    """``--streaming-vae`` runs the streaming encode and decode."""
    out = str(tmp_path / "stream.mp4")
    cli.main(["--video-ref", warp_dir, "--random-init", "--device", "cpu",
              "--guided", "--resize", "16", "16", "--num-frames", "5",
              "--num-inference-steps", "2", "--streaming-vae",
              "--output", out])
    assert os.path.getsize(out) > 0


def test_cli_later_slices_raise(warp_dir, tmp_path):
    """``--fused`` (the whole-loop runner) runs on the CPU with FLF on, and
    so does the host loop without it."""
    out = str(tmp_path / "x.mp4")
    base = ["--video-ref", warp_dir, "--random-init", "--device", "cpu",
            "--guided", "--resize", "16", "16", "--num-frames", "5",
            "--num-inference-steps", "2", "--resample-steps", "2",
            "--guide-steps", "2", "--resample-round", "2",
            "--use-pca-channel-selection", "--output", out]
    for extra in (["--fused"], []):
        if os.path.exists(out):
            os.unlink(out)
        cli.main(base + extra)
        assert os.path.getsize(out) > 0, extra


def test_cli_flf_on_cpu(warp_dir, tmp_path):
    """``--use-pca-channel-selection`` through guided steps 0-2, so FLF
    computes its scores at step 2."""
    out = str(tmp_path / "flf.mp4")
    cli.main(["--video-ref", warp_dir, "--random-init", "--device", "cpu",
              "--guided", "--use-pca-channel-selection", "--resize", "32",
              "32", "--num-frames", "5", "--num-inference-steps", "3",
              "--resample-steps", "2", "--guide-steps", "3",
              "--resample-round", "3", "--output", out])
    assert os.path.getsize(out) > 0


def test_run_longcat_cli_on_cpu(warp_dir, tmp_path):
    """``run_longcat`` guided with FLF on the distill schedule, at 16x16 on
    5 frames (the reduced random-init LongCat), writes a video and PNGs."""
    from worldforge_tpu_torch.cli import run_longcat
    out = str(tmp_path / "lc.mp4")
    run_longcat.main(["--video-ref", warp_dir, "--random-init",
                      "--device", "cpu", "--guided",
                      "--use-pca-channel-selection", "--use_distill",
                      "--resize", "16", "16", "--num-frames", "5",
                      "--num-inference-steps", "3", "--resample-steps", "2",
                      "--guide-steps", "3", "--resample-round", "3",
                      "--soften-mask", "--transition-distance", "3",
                      "--max-replace", "2", "--save-png", "--output", out])
    assert os.path.getsize(out) > 0
    assert len(os.listdir(str(tmp_path / "lc_frames"))) == 5
    up = str(tmp_path / "lc_up.mp4")
    run_longcat.main(["--video-ref", warp_dir, "--random-init",
                      "--device", "cpu", "--guided", "--resize", "16", "16",
                      "--num-frames", "5", "--num-inference-steps", "2",
                      "--enable-upscale", "--output", up])
    assert os.path.getsize(up) > 0
    with pytest.raises(NotImplementedError, match="parallel layer"):
        run_longcat.main(["--video-ref", warp_dir, "--random-init",
                          "--device", "cpu", "--context_parallel_size", "2",
                          "--output", out])


def test_upscale_cli_random_init_on_cpu(tmp_path):
    """``run_upscale`` on a directory of 5 frames at 16x16, refined to
    32x32 (the reduced random-init LongCat, 2 steps), writes a video."""
    from PIL import Image

    from worldforge_tpu_torch.cli import run_upscale
    rng = np.random.default_rng(1)
    d = tmp_path / "stage1"
    d.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).save(
            str(d / f"{i:02d}.png"))
    d = str(d)
    out = str(tmp_path / "up.mp4")
    run_upscale.main(["--input", d, "--random-init",
                      "--device", "cpu", "--spatial-refine-only",
                      "--target-height", "32", "--target-width", "32",
                      "--num-inference-steps", "2", "--prompt", "a street",
                      "--output", out])
    assert os.path.getsize(out) > 0
    with pytest.raises(NotImplementedError):
        run_upscale.main(["--input", d, "--random-init", "--device", "cpu",
                          "--context_parallel_size", "2"])


def test_load_frames_matches_jax(warp_dir):
    """``io/frames.load_frames`` is a copy of the JAX package's
    ``cli/warp_depthcrafter.py::_load_frames``."""
    from worldforge_tpu.cli.warp_depthcrafter import _load_frames
    np.testing.assert_array_equal(tframes.load_frames(warp_dir),
                                  _load_frames(warp_dir))


def test_host_side_copies_match_jax(warp_dir):
    """The port keeps its own copies of the JAX package's host helpers."""
    from worldforge_tpu.io import frames as jframes
    from worldforge_tpu.utils import prompts as jprompts
    from worldforge_tpu.warp import masks as jmasks
    from worldforge_tpu_torch.utils import prompts as tprompts

    jf, jm, _ = jframes.read_frames_from_directory(warp_dir)
    tf, tm, _ = tframes.read_frames_from_directory(warp_dir)
    np.testing.assert_array_equal(np.stack(tf), np.stack(jf))
    np.testing.assert_array_equal(np.stack(tm), np.stack(jm))
    for decay in ("linear", "exponential", "sine", "cosine"):
        np.testing.assert_array_equal(
            tmasks.soften_mask(np.stack(tm), 3, decay),
            jmasks.soften_mask(np.stack(jm), 3, decay))
    assert tprompts.SCENE_PROMPTS == jprompts.SCENE_PROMPTS
    assert tprompts.get_negative_prompt(True) == \
        jprompts.get_negative_prompt(True)


def _warp_inputs(tmp_path, h, w, dh=None, dw=None, seed=3):
    """An image file and an npz of depth, conf and cameras (depth at
    dh x dw, the image's size by default)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    dh, dw = dh or h, dw or w
    img = str(tmp_path / "image.png")
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(img)
    yy, xx = np.mgrid[0:dh, 0:dw].astype(np.float32)
    depth = (2.0 + 0.02 * xx + 0.03 * yy).astype(np.float32)
    f = 0.8 * dw
    cams = {"depth": depth,
            "conf": (1.0 + rng.random((dh, dw))).astype(np.float32),
            "extrinsic": np.eye(4),
            "intrinsic": np.array([[f, 0, dw / 2], [0, f, dh / 2],
                                   [0, 0, 1]])}
    return img, cams


def test_run_warp_cli_on_cpu(tmp_path):
    """``run_warp --depth_npz`` writes the warp-stage contract, equal to the
    JAX CLI's output from the same inputs."""
    from worldforge_tpu.cli import run_warp as jrun
    from worldforge_tpu_torch.cli import run_warp as trun
    img, cams = _warp_inputs(tmp_path, 24, 40)
    npz = str(tmp_path / "depth.npz")
    np.savez(npz, **cams)
    common = ["--image_path", img, "--depth_npz", npz, "--frame_single", "5",
              "--direction", "left", "--degree", "10"]
    trun.main(common + ["--output_path", str(tmp_path / "t"), "--device",
                        "cpu"])
    jrun.main(common + ["--output_path", str(tmp_path / "j")])
    out = tmp_path / "t" / "warped_images"
    names = sorted(os.listdir(out))
    assert names == sorted([f"warp_{i:02d}.png" for i in range(5)]
                           + [f"mask_{i:02d}.png" for i in range(5)])
    assert os.path.getsize(tmp_path / "t" / "warp_preview.mp4") > 0
    info = (tmp_path / "t" / "camera_info.txt").read_text()
    assert info == (tmp_path / "j" / "camera_info.txt").read_text()
    assert info.splitlines()[1].startswith("left_4.00_deg")
    tf, tm, _ = tframes.read_frames_from_directory(str(out))
    jf, jm, _ = tframes.read_frames_from_directory(
        str(tmp_path / "j" / "warped_images"))
    np.testing.assert_array_equal(np.stack(tm), np.stack(jm))
    np.testing.assert_array_equal(np.stack(tf), np.stack(jf))
    with pytest.raises(SystemExit, match="VGGT weights required"):
        trun.main(["--image_path", img, "--device", "cpu"])


def test_run_warp_vggt_depth_at_preprocessed_size(tmp_path, monkeypatch):
    """The VGGT branch warps the image at its own size with depth at the
    preprocessed size (518 wide, ``vggt_estimate``); neither CLI rescales
    one to the other. Here a 20 x 40 image meets 14 x 28 depth: both
    CLIs run, agree, and splat the depth grid into the top-left 14 x 28 of
    a 20 x 40 frame with the image's first 14 * 28 pixels as colours -- the
    JAX package's behaviour, kept (ROADMAP Queue C)."""
    from worldforge_tpu.cli import run_warp as jrun
    from worldforge_tpu.models.vggt import inference as jinf
    from worldforge_tpu_torch.cli import run_warp as trun
    from worldforge_tpu_torch.models.vggt import inference as tinf
    img, cams = _warp_inputs(tmp_path, 20, 40, 14, 28)
    est = (cams["depth"], cams["conf"], cams["extrinsic"], cams["intrinsic"])
    monkeypatch.setattr(jinf, "vggt_estimate", lambda *a, **k: est)
    monkeypatch.setattr(tinf, "vggt_estimate", lambda *a, **k: est)
    common = ["--image_path", img, "--frame_single", "3", "--degree", "0",
              "--vggt_checkpoint", "weights.npz"]
    trun.main(common + ["--output_path", str(tmp_path / "t"), "--device",
                        "cpu"])
    jrun.main(common + ["--output_path", str(tmp_path / "j")])
    tf, tm, _ = tframes.read_frames_from_directory(
        str(tmp_path / "t" / "warped_images"))
    jf, jm, _ = tframes.read_frames_from_directory(
        str(tmp_path / "j" / "warped_images"))
    np.testing.assert_array_equal(np.stack(tm), np.stack(jm))
    np.testing.assert_array_equal(np.stack(tf), np.stack(jf))
    assert tm[1].shape == (20, 40)
    assert not tm[1][14:].any() and not tm[1][:, 28:].any()
    assert tm[1][:14, :28].mean() > 0.9
    from PIL import Image
    pixels = np.asarray(Image.open(img)).reshape(-1, 3)[:14 * 28]
    same = (tf[1][:14, :28].reshape(-1, 3) == pixels).all(axis=-1)
    assert same.mean() > 0.8


def test_warp_depthcrafter_cli_on_cpu(tmp_path, monkeypatch):
    """``warp_depthcrafter --depth_npz --device cpu`` writes the same images
    and masks as the JAX CLI from the same frames directory and depth (at a
    smaller size than the frames: both resize the frames to the depth's),
    with the edge filter on; without ``--device`` it needs the card."""
    from PIL import Image
    from worldforge_tpu.cli import warp_depthcrafter as jcli
    from worldforge_tpu_torch.cli import warp_depthcrafter as tcli
    rng = np.random.default_rng(7)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (450, 500, 3), np.uint8)).save(
            frames_dir / f"f{i:02d}.png")
    yy, xx = np.mgrid[0:400, 0:448].astype(np.float32) / 10
    depth = np.stack([0.2 + 0.01 * xx + 0.005 * yy
                      + 0.4 * ((xx - i > 15) & (xx - i < 30) & (yy > 12))
                      for i in range(4)]).astype(np.float32)
    npz = str(tmp_path / "depth.npz")
    np.savez(npz, depth=depth / depth.max())
    common = ["--video_path", str(frames_dir), "--depth_npz", npz,
              "--direction", "right", "--degree", "8",
              "--enable_edge_filter"]
    tcli.main(common + ["--output_path", str(tmp_path / "t"), "--device",
                        "cpu"])
    jcli.main(common + ["--output_path", str(tmp_path / "j")])
    out = tmp_path / "t" / "imgs"
    assert sorted(os.listdir(out)) == sorted(
        [f"rendered_image_{i:02d}.png" for i in range(4)]
        + [f"mask_{i:02d}.png" for i in range(4)])
    for name in ("video.mp4", "mask.mp4"):
        assert os.path.getsize(tmp_path / "t" / name) > 0
    tf, tm, _ = tframes.read_frames_from_directory(str(out))
    jf, jm, _ = tframes.read_frames_from_directory(
        str(tmp_path / "j" / "imgs"))
    assert tf[0].shape == (400, 448, 3)
    assert 0 < np.mean(tm[2]) < 1
    np.testing.assert_array_equal(np.stack(tm), np.stack(jm))
    np.testing.assert_array_equal(np.stack(tf), np.stack(jf))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(common + ["--output_path", str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="DepthCrafter weights required"):
        tcli.main(["--video_path", str(frames_dir), "--output_path",
                   str(tmp_path / "n"), "--device", "cpu"])
