"""The kernel build's cache key (``ops/_build.py::_target``): a library is
rebuilt when its source, a shared header or the flags change. Needs no
``nvcc``: only the target paths are computed."""

from __future__ import annotations

import shutil

import pytest

from worldforge_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.CUDA_SOURCES + _build.HOST_SOURCES)
def test_header_edit_changes_target(csrc, name):
    before = _build._target(name)
    header = csrc / "attention_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target(name) != before


def test_source_and_flags_change_target(csrc, monkeypatch):
    before = _build._target("bsa")
    assert _build._target("bsa") == before          # stable
    src = csrc / "bsa.cu"
    src.write_text(src.read_text() + "\n")
    after_src = _build._target("bsa")
    assert after_src != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build._target("bsa") != after_src


def test_new_header_changes_target(csrc):
    before = _build._target("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("flash_attention") != before
