"""ALIKED checkpoint conversion from the lightglue / ALIKED torch layout.

Counterpart of ``worldforge_tpu/io/convert_aliked.py``: block1..block4
(blocks 3 and 4 with deformable ``conv1`` / ``conv2``: ``offset_conv`` with
a bias and ``regular_conv`` without), the BatchNorms' running statistics,
the neck ``conv1``..``conv4``, ``score_head.{0,2,4,6}`` and
``desc_head.{offset_conv.0, offset_conv.2, sf_conv, convM}``. The layout
is the manifest ``tests/fixtures/aliked_manifest.json``; a strict
conversion fails on a key it never read.
"""

from __future__ import annotations

import torch

from worldforge_tpu_torch.core.dtypes import resolve_device
from worldforge_tpu_torch.io.torch_load import (StrictStateDict, conv,
                                                conv_to_hwio, to_leaf)
from worldforge_tpu_torch.sfm.aliked import ALIKEDConfig

_ALIKED_CTX = ("expected the lightglue/ALIKED layout frozen in "
               "tests/fixtures/aliked_manifest.json")


def _bn(sd, name, dtype, dev):
    return {"scale": to_leaf(sd[f"{name}.weight"], dtype, dev),
            "bias": to_leaf(sd[f"{name}.bias"], dtype, dev),
            "mean": to_leaf(sd[f"{name}.running_mean"], dtype, dev),
            "var": to_leaf(sd[f"{name}.running_var"], dtype, dev)}


def _convlayer(sd, name, dtype, dev):
    """A block's conv1 / conv2: a plain 3x3 without bias or a
    DeformableConv2d."""
    if f"{name}.offset_conv.weight" in sd:
        return {"offset": conv(sd, f"{name}.offset_conv", dtype, dev),
                "w": to_leaf(sd[f"{name}.regular_conv.weight"], dtype, dev,
                             conv_to_hwio)}
    return conv(sd, name, dtype, dev, bias=False)


def _block(sd, pre, dtype, dev, res: bool):
    p = {"conv1": _convlayer(sd, f"{pre}.conv1", dtype, dev),
         "bn1": _bn(sd, f"{pre}.bn1", dtype, dev),
         "conv2": _convlayer(sd, f"{pre}.conv2", dtype, dev),
         "bn2": _bn(sd, f"{pre}.bn2", dtype, dev)}
    if res:
        p["downsample"] = conv(sd, f"{pre}.downsample", dtype, dev)
    return p


def convert_aliked(sd, cfg: ALIKEDConfig, dtype=torch.float32,
                   strict: bool = True, device=None) -> dict:
    """An ALIKED state dict -> ``sfm/aliked.py``'s tree (JAX :60)."""
    dev = resolve_device(device)
    sd = StrictStateDict(sd, _ALIKED_CTX)

    def c(name):
        return conv(sd, name, dtype, dev, bias=False)

    params = {
        "block1": _block(sd, "block1", dtype, dev, res=False),
        "block2": _block(sd, "block2", dtype, dev, res=True),
        "block3": _block(sd, "block3", dtype, dev, res=True),
        "block4": _block(sd, "block4", dtype, dev, res=True),
        "conv1": c("conv1"), "conv2": c("conv2"), "conv3": c("conv3"),
        "conv4": c("conv4"),
        "score_head": {k: c(f"score_head.{k}") for k in ("0", "2", "4", "6")},
        "desc_head": {
            "offset_conv1": conv(sd, "desc_head.offset_conv.0", dtype, dev),
            "offset_conv2": conv(sd, "desc_head.offset_conv.2", dtype, dev),
            "sf_conv": c("desc_head.sf_conv"),
            "convM": c("desc_head.convM")},
    }
    if strict:
        unused = sd.unused()
        if unused:
            raise ValueError(
                f"ALIKED checkpoint layout mismatch: {len(unused)} keys "
                f"never consumed (first 10: {unused[:10]})")
    return params
