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
    """``--fused`` (the TPU scan runner) raises; FLF
    (``--use-pca-channel-selection``) is ported and runs."""
    out = str(tmp_path / "x.mp4")
    base = ["--video-ref", warp_dir, "--random-init", "--device", "cpu",
            "--guided", "--resize", "16", "16", "--num-frames", "5",
            "--num-inference-steps", "1", "--output", out]
    with pytest.raises(NotImplementedError):
        cli.main(base + ["--fused"])
    cli.main(base + ["--use-pca-channel-selection"])
    assert os.path.getsize(out) > 0


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
