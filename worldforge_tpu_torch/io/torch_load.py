"""Checkpoint reading: state dicts as torch tensors in their stored dtype.

Counterpart of ``worldforge_tpu/io/torch_load.py``. ``load_state_dict``
takes what the JAX reader takes (a ``.safetensors`` file, a ``.pth`` /
``.pt`` / ``.bin`` file, or a directory of them, sharded through
``model.safetensors.index.json`` or not) and returns the same names, with
two differences:

- the tensors keep their stored dtype (the JAX reader upcasts bf16 to fp32
  numpy, which for the 14B Wan DiT is about 60 GiB of host memory);
- nothing is read until a name is looked up, and then only that tensor, so
  a converter that moves each converted leaf to its device as it makes it
  holds one tensor on the host at a time.

``.safetensors`` files are parsed here (an 8-byte little-endian header
length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets`` relative
to the end of the header and an optional ``__metadata__``, then the raw
little-endian bytes), without the ``safetensors`` package. ``.pth`` files go
through ``torch.load(mmap=True, weights_only=True)``.

The layout helpers (``linear_w``, ``conv3d_to_patch_dense``,
``conv_to_hwio``, ``deconv_to_hwio``, ``StrictStateDict``) are the JAX
module's on torch tensors; ``to_leaf`` is the one way a converter makes a
parameter: the stored tensor moved to the device as it is, laid out there,
then cast (round to nearest even, as JAX's cast) into memory of its own.
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Optional

import torch

WEIGHT_SUFFIXES = (".safetensors", ".pth", ".pt", ".bin")

SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


class SafetensorsFile:
    """One ``.safetensors`` file: the header is parsed when it is opened,
    each tensor is read from disk when it is asked for."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
        self.data_start = 8 + n
        self.metadata = header.pop("__metadata__", None)
        self.entries = header

    def keys(self):
        return self.entries.keys()

    def read(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        code = e["dtype"]
        if code not in SAFETENSORS_DTYPES:
            raise ValueError(f"{self.path}: tensor '{name}' has dtype "
                             f"{code}, which the reader does not take "
                             f"({', '.join(SAFETENSORS_DTYPES)})")
        dtype = SAFETENSORS_DTYPES[code]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{self.path}: tensor '{name}' holds "
                             f"{end - begin} bytes, its shape {shape} and "
                             f"dtype {code} need {numel * dtype.itemsize}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(end - begin)
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{self.path}: tensor '{name}' runs past "
                                 f"the end of the file")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


class LazyStateDict(Mapping):
    """name -> tensor, read from its file each time it is looked up (nothing
    is kept). Iterates in the order of the files, then of each file's
    names."""

    def __init__(self):
        self._read: Dict[str, Callable[[], torch.Tensor]] = {}

    def add_safetensors(self, path: str) -> None:
        f = SafetensorsFile(path)
        for name in f.keys():
            self._read[name] = (lambda f=f, name=name: f.read(name))

    def add_torch(self, path: str) -> None:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        for name, t in sd.items():
            self._read[name] = (lambda t=t: t)

    def add_file(self, path: str) -> None:
        if path.endswith(".safetensors"):
            self.add_safetensors(path)
        else:
            self.add_torch(path)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._read[name]()

    def __contains__(self, name) -> bool:
        return name in self._read

    def __iter__(self) -> Iterator[str]:
        return iter(self._read)

    def __len__(self) -> int:
        return len(self._read)


def load_state_dict(path: str) -> LazyStateDict:
    """A single file or a directory -> {name: tensor in its stored dtype},
    read on access. A directory goes through its
    ``model.safetensors.index.json`` (every shard it names, in sorted
    order) or else takes every weight file in sorted order, as the JAX
    reader does (``worldforge_tpu/io/torch_load.py:26-40``)."""
    sd = LazyStateDict()
    if os.path.isdir(path):
        idx = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
        else:
            files = [f for f in sorted(os.listdir(path))
                     if f.endswith(WEIGHT_SUFFIXES)]
        for f in files:
            sd.add_file(os.path.join(path, f))
    else:
        sd.add_file(path)
    return sd


# ------------------------------------------------------------ layouts


def linear_w(sd, name: str) -> torch.Tensor:
    """torch Linear weight [out, in] -> the dense kernel [in, out]."""
    return sd[name].t().contiguous()


def conv3d_to_patch_dense(w: torch.Tensor) -> torch.Tensor:
    """Conv3d kernel [out, in, kt, kh, kw] with kernel == stride -> dense
    [kt*kh*kw*in, out] in the patchify feature order (pt, ph, pw, c)."""
    return w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0])


def conv_to_hwio(w: torch.Tensor) -> torch.Tensor:
    """Conv2d/3d [out, in, *k] -> [*k, in, out]."""
    nd = w.dim() - 2
    return w.permute(*range(2, 2 + nd), 1, 0).contiguous()


def deconv_to_hwio(w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d [in, out, kh, kw] -> HWIO [kh, kw, in, out],
    spatially FLIPPED, as the JAX helper: its transposed conv is a
    fractionally strided forward conv, torch's the conv's gradient, which
    agree only with the kernel mirrored. The port's VGGT heads take the
    JAX layout."""
    return w.permute(2, 3, 0, 1).flip(0, 1)


def to_leaf(t: torch.Tensor, dtype: torch.dtype, device,
            layout: Optional[Callable] = None) -> torch.Tensor:
    """A stored tensor -> a parameter: moved to ``device`` as stored, laid
    out there by ``layout``, cast to ``dtype`` (round to nearest even),
    contiguous and in memory of its own (never a view of the file)."""
    x = t.to(device)
    if layout is not None:
        x = layout(x)
    y = x.to(dtype=dtype, memory_format=torch.contiguous_format)
    if y.data_ptr() == t.data_ptr():
        y = y.clone()
    return y


def dense(sd, name: str, dtype, device, bias: bool = True) -> dict:
    """A torch Linear -> {"w": [in, out], "b" (when the checkpoint has
    it)}."""
    p = {"w": to_leaf(sd[f"{name}.weight"], dtype, device, torch.t)}
    if bias and f"{name}.bias" in sd:
        p["b"] = to_leaf(sd[f"{name}.bias"], dtype, device)
    return p


def layer_norm(sd, name: str, dtype, device) -> dict:
    return {"scale": to_leaf(sd[f"{name}.weight"], dtype, device),
            "bias": to_leaf(sd[f"{name}.bias"], dtype, device)}


def rms_norm(sd, name: str, dtype, device) -> dict:
    return {"scale": to_leaf(sd[f"{name}.weight"], dtype, device)}


def conv(sd, name: str, dtype, device, bias: bool = True) -> dict:
    """A torch Conv -> {"w": (D)HWIO, "b" (required when ``bias``)}."""
    p = {"w": to_leaf(sd[f"{name}.weight"], dtype, device, conv_to_hwio)}
    if bias:
        p["b"] = to_leaf(sd[f"{name}.bias"], dtype, device)
    return p


class StrictStateDict(Mapping):
    """Wraps a state dict for converters: records the names consumed and
    turns a missing name into a layout-mismatch ``ValueError`` naming it and
    ``context`` (the frozen manifest to check), in the JAX wording."""

    def __init__(self, sd, context: str = ""):
        self.sd = sd
        self.context = context
        self.used = set()

    def __getitem__(self, k):
        if k not in self.sd:
            raise ValueError(
                f"checkpoint layout mismatch: missing key '{k}'"
                + (f" ({self.context})" if self.context else ""))
        self.used.add(k)
        return self.sd[k]

    def __contains__(self, k) -> bool:
        return k in self.sd

    def __iter__(self):
        return iter(self.sd)

    def __len__(self) -> int:
        return len(self.sd)

    def unused(self) -> list:
        return sorted(set(self.sd) - self.used)
