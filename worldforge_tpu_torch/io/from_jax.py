"""Bring a JAX parameter tree into the port.

The JAX package keeps parameters as nested dicts of arrays; the Wan DiT
stacks its transformer blocks on a leading ``[L, ...]`` axis for
``lax.scan`` (``worldforge_tpu/models/wan/dit.py:129``). The port keeps the
same layouts (dense kernels ``[in, out]``, conv kernels spatial-first
``(D)HWIO``) and holds the blocks as a list of per-layer dicts, so the only
change is the unstacking. Leaves arrive as numpy arrays (``np.asarray`` of
each JAX leaf); bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``) are carried
over bit for bit. A Wan VAE tree needs no unstacking: ``tree_from_numpy``
carries it over as it is, as it does the SVD UNet and VAE trees, whose
blocks are lists in JAX too. Quantized trees (``ops/quant.py``) and trees
with unmerged LoRA terms come across with their dtypes kept, the stacked
leaves split per layer. A JAX gradient tree has its parameters' structure,
so the same functions carry it (``dit_params_from_jax``,
``longcat_dit_params_from_jax``, ``lora_from_jax``): the gradient of a
stacked ``[L, ...]`` leaf becomes the port's per-layer leaves, and tests
compare gradients and updated parameters leaf by leaf.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from worldforge_tpu_torch.ops.quant import is_quantized


def tensor_from_numpy(a, device: Optional[Union[str, torch.device]] = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy (or anything ``np.asarray`` takes) -> torch, bf16 bit-exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def tree_from_numpy(tree, device=None, dtype=None):
    """Map ``tensor_from_numpy`` over a nested dict/list tree. ``dtype``
    casts every leaf except those of a quantized dense or one with an
    attached LoRA: the integer codes, the fp32 scales and bias and the
    ``lora_*`` terms keep the dtypes they arrive in."""
    if isinstance(tree, dict):
        if is_quantized(tree) or "lora_down" in tree:
            dtype = None
        return {k: tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device, dtype) for v in tree]
    return tensor_from_numpy(tree, device, dtype)


def unstack_layers(stacked: dict) -> list:
    """``{name: [L, ...]}`` (nested) -> ``[{name: [...]}] * L``. A 0-d leaf
    (the ``lora_scale`` that JAX's ``apply_lora`` attaches to a stacked
    quantized leaf) holds for every layer and is given to each."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)

    walk(stacked)
    n = next(t.shape[0] for t in leaves if np.ndim(t))

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i] if np.ndim(t) else t

    return [take(stacked, i) for i in range(n)]


def dit_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` Wan DiT param tree -> the port's DiT params
    (``models/wan/dit.py``): same keys, blocks unstacked into a list."""
    return _unstack_keys(tree, ("blocks",), device, dtype)


def longcat_dit_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` LongCat DiT param tree -> the port's
    (``models/longcat/dit.py``): same keys, the ``[L, ...]`` blocks
    unstacked into a list, as for the Wan DiT."""
    return dit_params_from_jax(tree, device, dtype)


def _unstack_keys(tree: dict, keys, device, dtype) -> dict:
    out = tree_from_numpy({k: v for k, v in tree.items() if k not in keys},
                          device, dtype)
    for k in keys:
        out[k] = [tree_from_numpy(layer, device, dtype)
                  for layer in unstack_layers(tree[k])]
    return out


def vggt_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` VGGT tree (``init_vggt_full``) -> the port's
    (``models/vggt/inference.py``): the aggregator's stacked
    ``frame_blocks`` / ``global_blocks`` unstacked into lists; the DINO
    blocks and the camera trunk are lists on both sides."""
    out = tree_from_numpy({k: v for k, v in tree.items()
                           if k != "aggregator"}, device, dtype)
    out["aggregator"] = _unstack_keys(tree["aggregator"],
                                      ("frame_blocks", "global_blocks"),
                                      device, dtype)
    return out


def umt5_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` UMT5 tree -> the port's
    (``models/encoders/umt5.py``): the stacked ``blocks`` unstacked."""
    return _unstack_keys(tree, ("blocks",), device, dtype)


def clip_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` CLIP vision tree -> the port's
    (``models/encoders/clip_vision.py``): the stacked ``blocks``
    unstacked."""
    return _unstack_keys(tree, ("blocks",), device, dtype)


def svd_unet_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` SVD UNet tree (``init_svd_unet``) -> the port's
    (``models/depthcrafter/unet.py``): same keys; its blocks are lists on
    both sides, so nothing is unstacked."""
    return tree_from_numpy(tree, device, dtype)


def svd_vae_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` SVD VAE tree (``init_svd_vae``) -> the port's
    (``models/depthcrafter/vae.py``): same keys, lists kept."""
    return tree_from_numpy(tree, device, dtype)


def vace_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` VACE tree (``init_vace``) -> the port's
    (``models/wan/vace.py``): the base DiT's stacked ``blocks`` unstacked;
    ``vace_blocks`` (with ``before_proj`` / ``after_proj``) is a list on
    both sides, ``vace_patch_embedding`` a dense."""
    return _unstack_keys(tree, ("blocks",), device, dtype)


def avatar_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` avatar DiT tree (``init_avatar_dit``) -> the
    port's (``models/longcat/avatar.py``): the stacked blocks (the LongCat
    block with the audio extras) unstacked; ``audio_proj`` as it is."""
    return _unstack_keys(tree, ("blocks",), device, dtype)


def lora_from_jax(lora: dict, device=None) -> dict:
    """JAX adapters (``training/lora.py``: path -> {down, up}, stacked
    ``[L, ...]`` for the blocks) -> the same layout as torch tensors, which
    the port's ``training/lora.py`` reads."""
    return {path: tree_from_numpy(a, device) for path, a in lora.items()}


def wav2vec2_params_from_jax(tree: dict, device=None, dtype=None) -> dict:
    """A ``worldforge_tpu`` wav2vec2 tree (``init_wav2vec2``) -> the port's
    (``models/encoders/wav2vec2.py``): same keys; ``convs`` and ``layers``
    are lists on both sides, so nothing is unstacked."""
    return tree_from_numpy(tree, device, dtype)
