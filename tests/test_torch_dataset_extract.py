"""The port's benchmark dataset extraction against the JAX package's, on
the CPU: the depth readers on synthetic files, and each of the five
extract walks on the synthetic trees of ``tests/test_dataset_extract.py``
(npz arrays and CSV rows equal, the mp4s written), plus the CLI."""

import csv
import os

import numpy as np
import pytest

from worldforge_tpu.benchmark import dataset_extract as jde
from worldforge_tpu_torch.benchmark import dataset_extract as tde
from tests.test_dataset_extract import _write_dpt, _write_png16, _write_rgb


def test_readers_match_jax(tmp_path, rng):
    d = rng.uniform(0.1, 80.0, (12, 20)).astype(np.float32)
    _write_dpt(str(tmp_path / "x.dpt"), d)
    np.testing.assert_array_equal(tde.sintel_depth_read(str(tmp_path /
                                                            "x.dpt")),
                                  jde.sintel_depth_read(str(tmp_path /
                                                            "x.dpt")))
    raw = rng.integers(256, 60000, (8, 10)).astype(np.uint16)
    raw[0, 0], raw[1, 1] = 0, 60001
    p = str(tmp_path / "d.png")
    _write_png16(p, raw)
    np.testing.assert_array_equal(tde.kitti_depth_read(p),
                                  jde.kitti_depth_read(p))
    for factor, zero_invalid in ((5000.0, True), (1000.0, False)):
        np.testing.assert_array_equal(
            tde.png_depth_read(p, factor, zero_invalid=zero_invalid),
            jde.png_depth_read(p, factor, zero_invalid=zero_invalid))


def _tree(tmp_path, rng, dataset):
    """The dataset's synthetic tree (as in tests/test_dataset_extract.py)
    and the extractor's arguments after the output ones."""
    if dataset == "sintel":
        root, droot = tmp_path / "clean", tmp_path / "depth"
        for seq in ("alley_1", "cave_2"):
            (root / seq).mkdir(parents=True)
            (droot / seq).mkdir(parents=True)
            for i in range(4):
                _write_rgb(str(root / seq / f"frame_{i:04d}.png"), rng,
                           (32, 48))
                _write_dpt(str(droot / seq / f"frame_{i:04d}.dpt"),
                           rng.uniform(1, 10, (32, 48)).astype(np.float32))
        return (str(root), str(droot)), {"sample_len": 2}
    if dataset == "kitti":
        seq = "2011_09_26_drive_0002_sync"
        img = tmp_path / "raw" / seq[0:10] / seq / "image_02/data"
        dep = tmp_path / "depth" / seq / "proj_depth/groundtruth/image_02"
        img.mkdir(parents=True)
        dep.mkdir(parents=True)
        for i in range(3):
            _write_rgb(str(img / f"{i:010d}.png"), rng, (33, 45))
            d = rng.integers(0, 60000, (33, 45)).astype(np.uint16)
            d[0, 0] = 60001
            _write_png16(str(dep / f"{i:010d}.png"), d)
        return (str(tmp_path / "raw"), str(tmp_path / "depth")), {}
    if dataset == "bonn":
        seq = tmp_path / "bonn" / "rgbd_bonn_balloon"
        for sub in ("rgb", "depth"):
            (seq / sub).mkdir(parents=True)
        for i in range(3):
            _write_rgb(str(seq / "rgb" / f"f_{i:04d}.png"), rng, (24, 32))
            _write_png16(str(seq / "depth" / f"f_{i:04d}.png"),
                         rng.integers(0, 30000, (24, 32)).astype(np.uint16))
        return ((str(tmp_path / "bonn"), str(tmp_path / "bonn")),
                {"start_frame": 0, "end_frame": 110})
    if dataset == "scannet":
        seq = tmp_path / "scan" / "scene0000_00"
        for sub in ("color", "depth"):
            (seq / sub).mkdir(parents=True)
        for i in range(3):
            _write_rgb(str(seq / "color" / f"{i}.jpg"), rng, (64, 80))
            _write_png16(str(seq / "depth" / f"{i}.png"),
                         rng.integers(0, 8000, (64, 80)).astype(np.uint16))
        return (str(tmp_path / "scan"),), {}
    (tmp_path / "nyu" / "rgb").mkdir(parents=True)
    (tmp_path / "nyu" / "depth").mkdir(parents=True)
    _write_rgb(str(tmp_path / "nyu" / "rgb" / "img_0001.png"), rng,
               (480, 640))
    _write_png16(str(tmp_path / "nyu" / "depth" / "d_0001.png"),
                 rng.integers(0, 9000, (480, 640)).astype(np.uint16))
    (tmp_path / "list.txt").write_text("rgb/img_0001.png x depth/d_0001.png\n")
    return ((str(tmp_path / "nyu"), str(tmp_path / "nyu")),
            {"filename_ls_path": str(tmp_path / "list.txt")})


def _rows(csv_path):
    with open(csv_path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("dataset", sorted(jde.EXTRACTORS))
def test_extract_walk_matches_jax(tmp_path, rng, dataset):
    """Both extractors on one tree: the samples, the CSV rows and every
    disparity npz equal; every mp4 written and non-empty."""
    args, kw = _tree(tmp_path, rng, dataset)
    outs = {}
    for name, mod in (("j", jde), ("t", tde)):
        out = str(tmp_path / f"out_{name}") + "/"
        samples = mod.EXTRACTORS[dataset](
            *args, csv_save_path=out + f"{dataset}.csv", saved_rgb_dir=out,
            saved_disp_dir=out, **kw)
        outs[name] = (out, samples, _rows(out + f"{dataset}.csv"))
    (tout, tsamples, trows), (jout, jsamples, jrows) = outs["t"], outs["j"]
    assert tsamples == jsamples and trows == jrows and trows
    for row in trows:
        got = np.load(tout + row["filepath_disparity"])["disparity"]
        want = np.load(jout + row["filepath_disparity"])["disparity"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert os.path.getsize(tout + row["filepath_left"]) > 0


def test_cli_matches_jax(tmp_path, rng):
    """``extract_dataset --dataset bonn`` with the protocol's defaults
    overridden, on both CLIs."""
    from worldforge_tpu.cli import extract_dataset as jcli
    from worldforge_tpu_torch.cli import extract_dataset as tcli
    (root, _), _ = _tree(tmp_path, rng, "bonn")
    for name, cli in (("j", jcli), ("t", tcli)):
        cli.main(["--dataset", "bonn", "--root", root, "--start-frame", "1",
                  "--end-frame", "3", "--out", str(tmp_path / name)])
    rows = _rows(tmp_path / "t" / "bonn.csv")
    assert rows == _rows(tmp_path / "j" / "bonn.csv") and len(rows) == 1
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / rows[0]["filepath_disparity"])["disparity"],
        np.load(tmp_path / "j" / rows[0]["filepath_disparity"])["disparity"])
