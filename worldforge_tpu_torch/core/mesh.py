"""Process meshes and the token exchanges of the parallel layer.

Counterpart of ``worldforge_tpu/core/mesh.py``. JAX builds one GSPMD mesh
over its devices and lets XLA insert the collectives; here one process runs
per rank and the mesh is a ``torch.distributed`` device mesh
(``init_device_mesh``) over the default process group: NCCL on
``cuda:{LOCAL_RANK}``, gloo on the CPU. The axes are JAX's:

  - ``dp``   -- data parallel (the batch),
  - ``fsdp`` -- fully sharded weights (``parallel/sharding.py``),
  - ``sp``   -- sequence / context parallel (tokens of one sample),
  - ``sp_h`` / ``sp_w`` -- the 2-D spatial split (``parallel/cp2d.py``).

The pipelines keep JAX's global view: every rank holds the same latents,
drawn from the same generator, and every DiT forward returns the global
output on every rank. Inside the forward the batch is cut on ``dp``
(``split_batch``) and the tokens on the sequence axes (``TokenSplit``),
after the patch embedding, and both are gathered after the head. These take
the place of JAX's ``shard_constraint`` / ``io_sharding``.

Token counts the group does not divide are padded at the end of the
sequence (XLA pads such a sharding silently); the exchanges drop the pad
rows, so no pad key ever enters an attention.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"
AXIS_SP_H = "sp_h"
AXIS_SP_W = "sp_w"


# ---------------------------------------------------------------- groups


def init_process_group(device: str = "cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Join the default process group (once per process) and return this
    rank's device. ``device="cuda"`` uses NCCL on ``cuda:{LOCAL_RANK}``,
    ``device="cpu"`` gloo. Rank and world size come from the arguments or
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``); ``init_method`` defaults to
    ``env://``. An existing group must use the backend the device asks for:
    there is no fallback from one to the other."""
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(device)
    if backend is None:
        raise ValueError(f"init_process_group: device {device!r} is not "
                         "'cuda' or 'cpu'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: device 'cuda' asked for "
                               "and torch.cuda.is_available() is false")
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else 0)) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"init_process_group: the default group uses "
                               f"{dist.get_backend()}, device {device!r} "
                               f"needs {backend}")
        return dev
    kw = {}
    if device == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=rank if rank is not None else int(os.environ.get("RANK", 0)),
        world_size=(world_size if world_size is not None
                    else int(os.environ.get("WORLD_SIZE", 1))), **kw)
    return dev


# the groups over more than one axis that the layer uses: the train step's
# gradient sum over the axes a forward cut (batch and tokens), and the 2-D
# split's exchanges
_AXIS_GROUPS = ((AXIS_DP, AXIS_SP), (AXIS_SP_H, AXIS_SP_W),
                (AXIS_DP, AXIS_SP_H, AXIS_SP_W))


class Mesh:
    """A named device mesh over every rank of the default group.

    ``shape`` maps each axis to its size (JAX's ``mesh.shape``); ``group(
    *axes)`` is the process group of the ranks that share this rank's
    coordinates on every other axis: one per axis and one per combination
    in ``_AXIS_GROUPS``, all made when the mesh is built, since every rank
    must make every group (a group's ranks are in row-major order of its
    axes); ``coord(axis)`` is this rank's index on an axis.

    ``cut_axes`` collects the axes a forward has cut its rows on and
    gathered its output over (``gather_batch`` on ``dp``, ``TokenSplit`` and
    ``cp2d.gather_cp_2d`` on the sequence axes): the gradients upstream of
    such a gather hold each rank's share, and the train step sums them over
    these axes after clearing the set before its forward."""

    def __init__(self, shape: Dict[str, int], device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        names = tuple(shape)
        dims = tuple(int(shape[a]) for a in names)
        n = math.prod(dims)
        if not dist.is_initialized():
            raise RuntimeError("Mesh: no process group; call "
                               "init_process_group(device) first")
        if n != dist.get_world_size():
            raise ValueError(f"mesh {dict(shape)} needs {n} ranks, the "
                             f"process group has {dist.get_world_size()}")
        self.axis_names = names
        self.shape = dict(zip(names, dims))
        self.size = n
        self.device = torch.device(device)
        self.device_mesh = init_device_mesh(self.device.type, dims,
                                            mesh_dim_names=names)
        grid = self.device_mesh.mesh            # [dims...] of global ranks
        me = dist.get_rank()
        pos = (grid == me).nonzero()[0].tolist()
        self._coord = dict(zip(names, pos))
        self.cut_axes = set()
        self._groups = {(a,): self.device_mesh.get_group(a) for a in names}
        for axes in _AXIS_GROUPS:
            if not all(a in names for a in axes):
                continue
            # the ranks that share every other axis' coordinate, in
            # row-major order of these axes (a group's rank order)
            keep = [i for i, a in enumerate(names) if a not in axes]
            moved = grid.permute(keep + [names.index(a) for a in axes])
            size = math.prod(self.shape[a] for a in axes)
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                moved.reshape(-1, size).tolist())

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise KeyError(f"mesh has no axis {unknown}: {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, *axes: str):
        axes = self._axes(axes)
        if axes not in self._groups:
            raise KeyError(f"mesh builds no group over {axes}; the groups "
                           f"are {sorted(self._groups)}")
        return self._groups[axes]

    def coord(self, axis: str) -> int:
        return self._coord[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, *,
              device: str = "cuda") -> Mesh:
    """The 3-axis (dp, fsdp, sp) mesh over every rank of the default group,
    which it joins first if needed (``init_process_group(device)``)."""
    dev = init_process_group(device)
    return Mesh({AXIS_DP: dp, AXIS_FSDP: fsdp, AXIS_SP: sp}, dev)


def single_device_mesh(device: str = "cuda") -> Mesh:
    return make_mesh(1, 1, 1, device=device)


def sp_size(mesh: Optional[Mesh]) -> int:
    return mesh.shape.get(AXIS_SP, 1) if mesh is not None else 1


# ---------------------------------------------------------------- exchanges


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal chunks of dim 0 ([size, ...]): chunk
    j goes to rank j, and chunk i of the result came from rank i. It is
    its own adjoint, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim (rank order)."""
    x = x.contiguous()
    size = dist.get_world_size(group)
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view((size,) + tuple(x.shape))


class _GatherReplicated(torch.autograd.Function):
    """All-gather on a new leading dim, for a result every rank then uses
    the same way (the DiT's output, gathered for a loss every rank computes
    alike): the backward keeps this rank's chunk of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return all_gather_stack(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _GatherSum(torch.autograd.Function):
    """All-gather on a new leading dim whose ranks use the result each in
    its own way (keys gathered for local queries): the backward is the
    adjoint, a reduce-scatter (sum) of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_stack(x, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(g.shape[1:])
        dist.reduce_scatter_tensor(
            out, g.contiguous().view((-1,) + tuple(g.shape[2:])),
            group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (rank order); the
    backward keeps this rank's part (see ``_GatherReplicated``)."""
    out = _GatherReplicated.apply(x, group)
    return torch.cat(out.unbind(0), dim=dim)


def gather_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``gather_replicated`` whose backward sums the ranks' gradients."""
    out = _GatherSum.apply(x, group)
    return torch.cat(out.unbind(0), dim=dim)


def dp_split_ok(mesh: Optional[Mesh], batch: int) -> bool:
    """Whether a batch of ``batch`` is cut on ``dp``: the axis is > 1 and
    divides it (otherwise every dp rank runs the whole batch)."""
    dp = mesh.shape.get(AXIS_DP, 1) if mesh is not None else 1
    return dp > 1 and batch % dp == 0


def split_batch(x, mesh: Optional[Mesh], batch: int):
    """This dp rank's rows of a global [batch, ...] tensor: ``x`` itself
    when ``dp_split_ok`` is false, x is None or its first dim is not
    ``batch`` (a tensor shared by the whole batch)."""
    if (x is None or not dp_split_ok(mesh, batch)
            or x.shape[0] != batch):
        return x
    n = batch // mesh.shape[AXIS_DP]
    return x.narrow(0, mesh.coord(AXIS_DP) * n, n)


def gather_batch(x: torch.Tensor, mesh: Optional[Mesh],
                 batch: int) -> torch.Tensor:
    """The inverse of ``split_batch`` for a global batch of ``batch``
    (marks ``dp`` in ``mesh.cut_axes`` when it gathers)."""
    if not dp_split_ok(mesh, batch):
        return x
    mesh.cut_axes.add(AXIS_DP)
    return gather_replicated(x, mesh.group(AXIS_DP), dim=0)


class TokenSplit:
    """A [B, N, ...] token sequence cut over the ranks of ``mesh`` along
    ``axes`` (their group, ``mesh.group(*axes)``).

    The sequence is taken in ``order`` (a permutation of range(N) as a
    LongTensor; None for the raster order), padded at its end to
    ``size * n_local`` rows, and rank r of the group holds rows
    ``r * n_local ... (r + 1) * n_local`` of it. ``index`` is the global
    token index of each local row (pad rows repeat the last token; their
    results are dropped by every exchange) and ``n_real`` the number of
    local rows that are not pad. ``frames(tokens_per_frame)``
    gives each local row's latent frame, for the per-frame modulations.

    The exchanges (all differentiable):
      - ``split(x)``: this rank's rows of a global tensor;
      - ``gather(x)``: the global [B, N, ...] from every rank's rows, for a
        result every rank uses alike (the DiT's output; marks ``axes`` in
        ``mesh.cut_axes``);
      - ``gather_keys(x)``: the same, for keys each rank uses for its own
        queries (its backward sums the ranks' gradients);
      - ``to_heads(x)``: Ulysses' first all-to-all, [B, n_local, H, D] ->
        [B, N, H / size, D] in the global order, pad rows dropped (head
        group r on rank r);
      - ``from_heads(o)``: its inverse."""

    def __init__(self, n: int, mesh: Mesh, axes: Sequence[str],
                 order: Optional[torch.Tensor] = None, device=None):
        self.n = n
        self.mesh = mesh
        self.axes = tuple(axes)
        self.group = group = mesh.group(*axes)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.n_local = -(-n // self.size)
        self.pad = self.size * self.n_local - n
        self.n_real = min(max(n - self.rank * self.n_local, 0), self.n_local)
        pos = torch.arange(self.rank * self.n_local,
                           (self.rank + 1) * self.n_local, device=device)
        base = (order.to(device=device, dtype=torch.long)
                if order is not None else torch.arange(n, device=device))
        self.index = base[pos.clamp(max=n - 1)]
        # global token -> its row in the padded split order, and the split
        # order padded with its last token
        self._to_global = torch.argsort(base)
        self._to_split = torch.cat([base, base[-1:].expand(self.pad)])
        self._identity = order is None and self.pad == 0

    def frames(self, tokens_per_frame: int) -> torch.Tensor:
        return torch.div(self.index, tokens_per_frame, rounding_mode="floor")

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if self._identity:
            return x.narrow(dim, self.rank * self.n_local, self.n_local)
        return x.index_select(dim, self.index.to(x.device))

    def _to_global_order(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self._identity:
            return x
        return x.index_select(dim, self._to_global.to(x.device))

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        self.mesh.cut_axes.update(self.axes)
        return self._to_global_order(gather_replicated(x, self.group, dim),
                                     dim)

    def gather_keys(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return self._to_global_order(gather_sum(x, self.group, dim), dim)

    def to_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h, d = x.shape
        s = self.size
        if h % s:
            raise ValueError(f"Ulysses: {h} heads do not divide over {s} "
                             "ranks")
        buf = x.reshape(b, n, s, h // s, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(buf, self.group)          # [s(src), b, n, h/s, d]
        full = got.permute(1, 0, 2, 3, 4).reshape(b, s * n, h // s, d)
        return self._to_global_order(full, 1)

    def from_heads(self, o: torch.Tensor) -> torch.Tensor:
        b, n, hl, d = o.shape
        s = self.size
        if not self._identity:
            o = o.index_select(1, self._to_split.to(o.device))
        buf = o.reshape(b, s, self.n_local, hl, d).permute(1, 0, 2, 3, 4)
        got = all_to_all(buf, self.group)          # [s(head grp), b, n, hl, d]
        return got.permute(1, 2, 0, 3, 4).reshape(b, self.n_local, s * hl, d)
