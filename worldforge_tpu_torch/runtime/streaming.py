"""Layer streaming: run a model whose layers live in pinned host memory,
copying each layer's weights to the card while the layer before it
computes.

Counterpart of ``worldforge_tpu/runtime/streaming.py``. On the card the
copies run on a side CUDA stream: the copy of layer i + prefetch + 1 is
issued before layer i's compute, an event orders each layer's compute
after its copy, and a layer's weights are released once its compute is
queued (``record_stream`` keeps the allocator from reusing them before the
compute stream is done). While layer i computes, layers i + 1 to
i + prefetch + 1 are on the card or on their way: ``prefetch + 2`` layers
at most, the JAX package's schedule (its docstring's "prefetch + 1" counts
the layers ahead of the one computing). Host memory must be pinned for the
copies to overlap the compute (``to_host_blocks``). On the CPU the layers
are used as they are.

``StreamingExecutor(host_blocks, L, layer_fn)(carry)`` runs ``carry =
layer_fn(layer, carry)`` over the layers (the JAX package's API);
``StreamedBlocks(...)`` iterates the device layers, so a DiT forward that
loops ``for layer in params["blocks"]`` streams them unchanged. The blocks
are the port's list of per-layer trees or, as in JAX, one tree of stacked
[L, ...] tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import torch

from worldforge_tpu_torch.core.params import tree_map


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _layer_slice(host_blocks, i: int):
    """Layer i of a list of layer trees or of a stacked [L, ...] tree (a
    view, no copy)."""
    if isinstance(host_blocks, (list, tuple)):
        return host_blocks[i]
    return tree_map(lambda a: a[i], host_blocks)


def to_host_blocks(blocks) -> Any:
    """The blocks in host memory. Where there is a card they are views into
    one pinned buffer, so the copies to the card can overlap compute and
    one allocation holds every layer (the pinned allocator rounds each
    allocation up to a power of two: per tensor, the Wan-14B blocks would
    take about 1.6 times their size)."""
    leaves = _leaves(blocks)
    if not torch.cuda.is_available():
        return tree_map(lambda t: t.detach().to("cpu"), blocks)
    offsets, total = [], 0
    for t in leaves:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // 64) * 64
    buf = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    views = iter(buf[o:o + t.numel() * t.element_size()].view(t.dtype)
                 .view(t.shape).copy_(t.detach())
                 for o, t in zip(offsets, leaves))
    return tree_map(lambda t: next(views), blocks)


class StreamingExecutor:
    """Runs ``carry = layer_fn(layer_params, carry)`` over ``num_layers``
    layers whose parameters live in host memory, on ``device`` (default:
    the current card, else the CPU), the copies ``prefetch + 1`` layers
    ahead of the compute. ``max_resident`` is the most layers that were on
    the device at once, the computing one included."""

    def __init__(self, host_blocks, num_layers: int,
                 layer_fn: Optional[Callable[[Any, Any], Any]] = None, *,
                 prefetch: int = 1, device=None):
        self.host_blocks = host_blocks
        self.num_layers = num_layers
        self.layer_fn = layer_fn
        self.prefetch = max(0, prefetch)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.max_resident = 0

    def _put(self, i: int, stream):
        layer = _layer_slice(self.host_blocks, i)
        if self.device.type != "cuda":
            return tree_map(lambda t: t.to(self.device), layer), None
        with torch.cuda.stream(stream):
            dev = tree_map(lambda t: t.to(self.device, non_blocking=True),
                           layer)
            ev = torch.cuda.Event()
            ev.record(stream)
        return dev, ev

    def layers(self) -> Iterator[Any]:
        """Yield each layer on the device, in order, ready to compute on the
        current stream."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        cur = torch.cuda.current_stream(self.device) if cuda else None
        n = self.num_layers
        window = [self._put(i, side)
                  for i in range(min(self.prefetch + 1, n))]
        for i in range(n):
            nxt = i + self.prefetch + 1
            if nxt < n:
                window.append(self._put(nxt, side))
            self.max_resident = max(self.max_resident, len(window))
            layer, ev = window.pop(0)
            if cuda:
                cur.wait_event(ev)
            yield layer
            if cuda:
                for t in _leaves(layer):
                    t.record_stream(cur)
            del layer

    def __call__(self, carry):
        for layer in self.layers():
            carry = self.layer_fn(layer, carry)
        return carry


class StreamedBlocks:
    """An iterable of the device layers (``StreamingExecutor.layers``),
    for a forward's ``params["blocks"]``; each loop over it streams the
    layers again."""

    def __init__(self, host_blocks, num_layers: int, *, prefetch: int = 1,
                 device=None):
        self.executor = StreamingExecutor(host_blocks, num_layers,
                                          prefetch=prefetch, device=device)

    def __iter__(self):
        return self.executor.layers()

    def __len__(self):
        return self.executor.num_layers


def stream_layers(host_blocks, num_layers: int,
                  layer_fn: Callable[[Any, Any], Any], carry, *,
                  prefetch: int = 1, device=None):
    """One call of a ``StreamingExecutor``."""
    return StreamingExecutor(host_blocks, num_layers, layer_fn,
                             prefetch=prefetch, device=device)(carry)
