"""The port's checkpoint reader and layout helpers
(``worldforge_tpu_torch/io/torch_load.py``) against the ``safetensors``
package and the JAX package's reader (``worldforge_tpu/io/torch_load.py``),
on the CPU.

The reader parses ``.safetensors`` itself and keeps each tensor's stored
dtype, so every comparison is exact: against ``safetensors`` bit for bit
in the stored dtype, against the JAX reader after its bf16 -> fp32 upcast.
The casts a converter makes (``to_leaf``) equal JAX's ``jnp.asarray(x,
dtype)`` bit for bit, ties to even included.
"""

import json
import os
import struct

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from worldforge_tpu.io import torch_load as jload
from worldforge_tpu_torch.io import torch_load as tload

DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).contiguous().view(torch.uint8)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _sample(dtype, shape, gen):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape,
                         generator=gen).to(dtype)


def _tensors(seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        name = str(dt).split(".")[-1]
        out[f"{name}.matrix"] = _sample(dt, (3 + i % 3, 5), gen)
        out[f"{name}.scalar"] = _sample(dt, (), gen)
        out[f"{name}.empty"] = _sample(dt, (0, 4), gen)
    return out


def test_reader_matches_safetensors_every_dtype(tmp_path):
    """Every dtype the reader takes, matrices, scalars and empty tensors,
    and the ``__metadata__`` entry: equal to ``safetensors``' own reading,
    bit for bit and in the stored dtype."""
    ts = _tensors()
    path = str(tmp_path / "all.safetensors")
    meta = {"format": "pt", "note": "every dtype"}
    save_file(ts, path, metadata=meta)
    sd = tload.load_state_dict(path)
    f = tload.SafetensorsFile(path)
    assert f.metadata == meta
    with safe_open(path, framework="pt") as ref:
        assert ref.metadata() == meta
        assert sorted(sd) == sorted(ref.keys()) == sorted(ts)
        for name in ref.keys():
            got, want = sd[name], ref.get_tensor(name)
            assert _same(got, want), name
            assert _same(got, ts[name]), name
    assert len(sd) == len(ts) and "float32.scalar" in sd
    assert "missing" not in sd


def test_writer_output_reads_in_safetensors(tmp_path):
    """``save_safetensors`` (LoRA files, ``chip_smoke.py``'s checkpoint
    export): every dtype, scalars, empty tensors and non-contiguous views,
    read back by ``safetensors`` itself and by the port's reader, bit for
    bit and in the stored dtype; the returned size is the file's."""
    ts = _tensors(1)
    ts["int8.col_major"] = _sample(torch.int8, (6, 4),
                                   torch.Generator().manual_seed(2)).t()
    path = str(tmp_path / "written.safetensors")
    assert tload.save_safetensors(path, ts) == os.path.getsize(path)
    sd = tload.load_state_dict(path)
    with safe_open(path, framework="pt") as ref:
        assert list(ref.keys()) == sorted(ts)
        for name, t in ts.items():
            assert _same(ref.get_tensor(name), t.contiguous()), name
            assert _same(sd[name], t.contiguous()), name


def test_reader_reads_each_tensor_on_access(tmp_path):
    """A lookup reads the file: nothing is kept, each read is a tensor of
    its own, and a tensor written after the header was parsed is read as it
    stands on disk."""
    path = str(tmp_path / "one.safetensors")
    save_file({"w": torch.arange(6, dtype=torch.float32)}, path)
    sd = tload.load_state_dict(path)
    a, b = sd["w"], sd["w"]
    assert a.data_ptr() != b.data_ptr()
    a.zero_()
    assert torch.equal(sd["w"], torch.arange(6, dtype=torch.float32))
    with open(path, "r+b") as fh:                     # last float -> 99.0
        fh.seek(-4, os.SEEK_END)
        fh.write(struct.pack("<f", 99.0))
    assert float(sd["w"][-1]) == 99.0


def _raw_file(path, entries, data=b""):
    header = json.dumps(entries).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + data)


def test_reader_refuses_other_dtypes_and_bad_sizes(tmp_path):
    path = str(tmp_path / "fp8.safetensors")
    _raw_file(path, {"x": {"dtype": "F8_E4M3", "shape": [2],
                           "data_offsets": [0, 2]},
                     "y": {"dtype": "F32", "shape": [1],
                           "data_offsets": [2, 6]}}, b"\0" * 6)
    sd = tload.load_state_dict(path)
    with pytest.raises(ValueError, match="F8_E4M3"):
        sd["x"]
    assert float(sd["y"]) == 0.0
    bad = str(tmp_path / "short.safetensors")
    _raw_file(bad, {"x": {"dtype": "F32", "shape": [4],
                          "data_offsets": [0, 8]}}, b"\0" * 8)
    with pytest.raises(ValueError, match="need 16"):
        tload.load_state_dict(bad)["x"]
    cut = str(tmp_path / "cut.safetensors")
    _raw_file(cut, {"x": {"dtype": "F32", "shape": [4],
                          "data_offsets": [0, 16]}}, b"\0" * 8)
    with pytest.raises(ValueError, match="past the end"):
        tload.load_state_dict(cut)["x"]


def _jax_equal(port_sd, jax_sd):
    """The port's tensors against the JAX reader's numpy: same names, and
    equal after JAX's bf16 -> fp32 upcast."""
    assert sorted(port_sd) == sorted(jax_sd)
    for k, v in jax_sd.items():
        t = port_sd[k]
        want = np.asarray(v)
        got = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("with_index", [True, False])
def test_sharded_directory_matches_jax_reader(tmp_path, with_index):
    """A directory of shards, through ``model.safetensors.index.json`` or
    taking every weight file in sorted order (a ``.pth`` among them), reads
    the same names and values as the JAX reader."""
    ts = {k: v for k, v in _tensors(1).items() if not k.startswith("bool")}
    names = sorted(ts)
    shards = [names[:10], names[10:20], names[20:]]
    for i, part in enumerate(shards):
        save_file({k: ts[k] for k in part},
                  str(tmp_path / f"model-{i:05d}-of-00003.safetensors"))
    if with_index:
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": {
                k: f"model-{i:05d}-of-00003.safetensors"
                for i, part in enumerate(shards) for k in part}}, f)
        # a stray file beside an index is not read, as in JAX
        torch.save({"stray": torch.ones(2)}, str(tmp_path / "extra.pth"))
    else:
        torch.save({"state_dict": {"extra.w": torch.ones(2, 3)}},
                   str(tmp_path / "extra.pth"))
    sd = tload.load_state_dict(str(tmp_path))
    _jax_equal(sd, jload.load_state_dict(str(tmp_path)))
    assert ("extra.w" in sd) != with_index and "stray" not in sd
    for k in names:
        assert _same(sd[k], ts[k]), k


@pytest.mark.parametrize("wrapped", [True, False])
def test_pth_with_and_without_state_dict(tmp_path, wrapped):
    """``.pth`` through ``torch.load(mmap=True, weights_only=True)``; a
    ``{"state_dict": ...}`` wrapper is taken off. The leaves ``to_leaf``
    makes own their memory (no view of the mapped file)."""
    gen = torch.Generator().manual_seed(3)
    ts = {"a.weight": torch.randn(4, 3, generator=gen).bfloat16(),
          "a.bias": torch.randn(4, generator=gen),
          "b.gamma": torch.randn(2, 1, 1, generator=gen).half()}
    path = str(tmp_path / ("wrapped.pth" if wrapped else "plain.pt"))
    torch.save({"state_dict": ts} if wrapped else ts, path)
    sd = tload.load_state_dict(path)
    _jax_equal(sd, jload.load_state_dict(path))
    for k, v in ts.items():
        assert _same(sd[k], v), k
    leaf = tload.to_leaf(sd["a.bias"], torch.float32, "cpu")
    assert _same(leaf, ts["a.bias"])
    assert leaf.untyped_storage().data_ptr() != \
        sd["a.bias"].untyped_storage().data_ptr()


def _ties(n=4096, seed=0):
    """fp32 values exactly halfway between two bf16 (and fp16) numbers, and
    random ones: the cases where round-to-nearest-even decides."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0x3000, 0x4f00, n).astype(np.uint32) << 16
    ties = (hi | 0x8000).view(np.float32)             # bf16 halfway points
    half = (rng.integers(0x1000, 0x7000, n).astype(np.uint16)).view(
        np.float16).astype(np.float32)
    half_ties = half + np.float32(2.0 ** -24) * np.abs(half)  # near fp16 ties
    return np.concatenate([ties, -ties, half_ties,
                           rng.standard_normal(n).astype(np.float32) * 7])


@pytest.mark.parametrize("src,dst", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float16", "float32"), ("float32", "bfloat16"),
    ("float16", "bfloat16"), ("float32", "float16"),
    ("float64", "float32")])
def test_to_leaf_casts_as_jax(tmp_path, src, dst):
    """A leaf cast from its stored dtype equals JAX's path (the reader's
    fp32 upcast of bf16, then ``jnp.asarray(x, dtype)``) bit for bit: exact
    widenings, and round to nearest even for fp32 -> bf16, fp16 -> bf16
    and fp32 -> fp16 on values at the ties."""
    x = torch.from_numpy(_ties())
    stored = {"x": x.to(getattr(torch, src))}
    path = str(tmp_path / "x.safetensors")
    save_file(stored, path)
    got = tload.to_leaf(tload.load_state_dict(path)["x"],
                        getattr(torch, dst), "cpu")
    want = np.asarray(jnp.asarray(jload.load_state_dict(path)["x"],
                                  getattr(jnp, dst)))
    if dst == "bfloat16":
        assert want.dtype == ml_dtypes.bfloat16
        want_t = torch.from_numpy(want.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        want_t = torch.from_numpy(want)
    assert _same(got, want_t)
    if src == "float32" and dst == "bfloat16":   # the ties really round
        up = (got.float() != stored["x"]).sum()
        assert int(up) > 1000


def test_layout_helpers_match_jax():
    """``linear_w``, ``conv3d_to_patch_dense``, ``conv_to_hwio`` (2-D and
    3-D) and ``deconv_to_hwio`` (with its spatial flip) equal the JAX
    helpers on the same arrays."""
    rng = np.random.default_rng(4)
    lin = rng.standard_normal((6, 5)).astype(np.float32)
    c3 = rng.standard_normal((7, 3, 1, 2, 2)).astype(np.float32)
    c2 = rng.standard_normal((4, 3, 3, 5)).astype(np.float32)
    c3k = rng.standard_normal((4, 3, 3, 3, 3)).astype(np.float32)
    dc = rng.standard_normal((3, 5, 4, 2)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        tload.linear_w({"w": t(lin)}, "w").numpy(),
        jload.linear_w({"w": lin}, "w"))
    np.testing.assert_array_equal(tload.conv3d_to_patch_dense(t(c3)).numpy(),
                                  jload.conv3d_to_patch_dense(c3))
    for w in (c2, c3k):
        np.testing.assert_array_equal(tload.conv_to_hwio(t(w)).numpy(),
                                      jload.conv_to_hwio(w))
    got = tload.deconv_to_hwio(t(dc)).numpy()
    np.testing.assert_array_equal(got, jload.deconv_to_hwio(dc))
    assert not np.array_equal(got, np.transpose(dc, (2, 3, 0, 1)))


def test_strict_state_dict_matches_jax():
    """A missing name raises the JAX wording; ``in`` does not consume;
    ``unused`` lists what the converter never read."""
    sd = {"a": torch.ones(1), "b": torch.ones(1)}
    t = tload.StrictStateDict(sd, "see the manifest")
    j = jload.StrictStateDict({k: v.numpy() for k, v in sd.items()},
                              "see the manifest")
    for s in (t, j):
        with pytest.raises(ValueError) as e:
            s["c"]
        assert str(e.value) == ("checkpoint layout mismatch: missing key "
                                "'c' (see the manifest)")
    assert "b" in t and t["a"] is sd["a"]
    assert t.unused() == ["b"] and sorted(set(j.sd) - j.used) == ["a", "b"]
