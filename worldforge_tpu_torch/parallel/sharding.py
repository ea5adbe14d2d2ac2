"""FSDP (ZeRO-3) for the port's parameter trees (counterpart of
``worldforge_tpu/parallel/sharding.py``).

JAX places each leaf with a ``NamedSharding`` on the ``fsdp`` axis and lets
XLA gather it where it is used. Here ``shard_params_fsdp`` keeps on each
rank only its chunk of every leaf along the axis ``fsdp_spec`` picks (the
largest one the axis size divides), and marks the chunk with that axis
(``fsdp_axis``); the forwards call ``gather_params`` on the tree outside the
blocks when they start and on each block just before it runs, so one
block's full weights live at a time (inside the block's remat scope, so the
backward gathers them again). The gather is a ``torch.autograd.Function``:
all-gather forward; backward a reduce-scatter of the gradient, averaged
over the fsdp ranks, which hold the same activations (the batch is cut on
``dp`` only, as in JAX). The optimizer built over the chunks keeps its
state sharded the same way.

The blocks are a list of per-layer dicts where JAX stacks them, so a block
leaf's spec is JAX's without the leading layer axis (``skip_axes=1`` there).
Quantized dense dicts stay whole on every rank: their int8 codes keep the
layout their products need.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.mesh import AXIS_DP, AXIS_FSDP, AXIS_SP, Mesh
from worldforge_tpu_torch.ops.quant import is_quantized


def fsdp_spec(shape, fsdp_size: int, *, skip_axes: int = 0
              ) -> Tuple[Optional[str], ...]:
    """JAX's ``fsdp_spec`` as a tuple (the PartitionSpec's entries): the
    largest axis after ``skip_axes`` that ``fsdp_size`` divides (ties to the
    later axis) gets ``"fsdp"``; () when none does or fsdp_size is 1."""
    if fsdp_size <= 1 or len(shape) == 0:
        return ()
    cand = [(dim, ax) for ax, dim in enumerate(shape)
            if ax >= skip_axes and dim % fsdp_size == 0]
    if not cand:
        return ()
    _, ax = max(cand)
    spec = [None] * len(shape)
    spec[ax] = AXIS_FSDP
    return tuple(spec)


def activation_spec(ndim: int, *, batch_axis: int = 0,
                    seq_axis: Optional[int] = 1) -> Tuple[Optional[str], ...]:
    """The activations' layout as JAX's spec entries: the batch on dp, the
    sequence on sp (``core/mesh.py`` cuts them: ``split_batch``,
    ``TokenSplit``)."""
    spec = [None] * ndim
    spec[batch_axis] = AXIS_DP
    if seq_axis is not None:
        spec[seq_axis] = AXIS_SP
    return tuple(spec)


def _map(fn, tree):
    """``P.tree_map`` that leaves quantized dense dicts whole."""
    if isinstance(tree, dict):
        if is_quantized(tree):
            return tree
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def shard_params_fsdp(params, mesh: Mesh):
    """This rank's FSDP chunks of a parameter tree (on ``mesh.device``):
    each leaf cut along its ``fsdp_spec`` axis, the chunk marked with
    ``fsdp_axis``; leaves no axis divides stay whole."""
    fsdp = mesh.shape.get(AXIS_FSDP, 1)

    def place(t):
        t = t.to(mesh.device)
        spec = fsdp_spec(t.shape, fsdp)
        if not spec:
            return t
        ax = spec.index(AXIS_FSDP)
        chunk = t.chunk(fsdp, dim=ax)[mesh.coord(AXIS_FSDP)].clone()
        chunk.fsdp_axis = ax
        return chunk

    return _map(place, params)


def replicate(tree, mesh: Mesh):
    """Every leaf whole on this rank's device."""
    return P.tree_map(lambda t: t.to(mesh.device), tree)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, axis, group):
        ctx.axis, ctx.group = axis, group
        size = dist.get_world_size(group)
        x = chunk.movedim(axis, 0).contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        g = g.movedim(ctx.axis, 0).contiguous()
        out = g.new_empty((g.shape[0] // size,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return (out / size).movedim(0, ctx.axis), None, None


def gather_params(tree, mesh: Optional[Mesh], skip: Tuple[str, ...] = ()):
    """The tree with every FSDP chunk gathered whole (differentiably);
    top-level keys in ``skip`` (the blocks) are passed through as they
    are. A tree with no chunks comes back unchanged."""
    group = None

    def gather(t):
        nonlocal group
        ax = getattr(t, "fsdp_axis", None)
        if ax is None:
            return t
        if mesh is None:
            raise ValueError("an FSDP-sharded parameter tree needs its mesh")
        if group is None:
            group = mesh.group(AXIS_FSDP)
        return _FsdpGather.apply(t, ax, group)

    if isinstance(tree, dict) and skip:
        return {k: (v if k in skip else _map(gather, v))
                for k, v in tree.items()}
    return _map(gather, tree)
