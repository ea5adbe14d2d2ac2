"""The whole-loop runner on the card: each segment kind's step body
captured once as a CUDA graph and replayed, step after step.

The card's counterpart of the JAX package's one traced program
(``worldforge_tpu/sampling/engine.py::wan_denoise_scan``): after the
captures, a step is one graph launch plus two small copies, with no host
work per kernel.

- The carry lives in static buffers allocated before the captures; each
  graph reads them and writes the next step's carry back into them.
- The step's row of the tables (t, sigma, the solver coefficients, the
  step index, ...) is copied into a static buffer before each replay; the
  body reads it as 0-dim tensors.
- The IRR re-noise: with a ``torch.Generator`` (or the default one) the
  draws are captured in the graph and the generator is registered with it,
  so each replay draws the numbers an eager run would draw from the same
  state. With ``noise_fn`` (the tests' hook) the draws are made on the host
  before each replay and copied into static inputs. Those are allocated
  before the captures, at the shapes the warm-up drew: a tensor allocated
  during a capture may take the memory of a temporary the graph wrote
  earlier in the step, which would overwrite the copied draw.
- Every graph shares one memory pool; they are captured in the order the
  plan first runs them and replayed in that order.
- One warm-up step of each kind no other kind covers runs eagerly before
  the captures (on scratch copies of the carry), so kernels are built,
  Triton programs compiled and per-shape constants cached outside any
  capture.
- The kernels' launch counters count the launches on the card: a capture
  launches nothing, so the counts it adds are taken back and each replay
  adds them again.

A capture or replay that fails raises; the runner never falls back to an
eager run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_COUNTER_ATTRS = ("launches", "launches_by_instantiation",
                  "launches_by_shape")


def counted_wrappers() -> list:
    """Every kernel wrapper that counts its launches."""
    from worldforge_tpu_torch.ops import (bsa, conv3d, flash_attention,
                                          fused_norm, rope)
    return [flash_attention.flash_attention,
            flash_attention.flash_attention_backward,
            rope.apply_rope_qk, rope.apply_rope_qk_backward,
            fused_norm.modulated_layer_norm,
            fused_norm.modulated_layer_norm_backward,
            conv3d.conv3d_causal, conv3d.conv2d_3x3, bsa.bsa_bhsd]


def _snapshot() -> list:
    out = []
    for fn in counted_wrappers():
        for attr in _COUNTER_ATTRS:
            if hasattr(fn, attr):
                v = getattr(fn, attr)
                out.append((fn, attr, dict(v) if isinstance(v, dict) else v))
    return out


def _restore(snap) -> None:
    for fn, attr, v in snap:
        setattr(fn, attr, dict(v) if isinstance(v, dict) else v)


def _delta(before, after) -> list:
    """The counts a capture added, as (wrapper, attr, int or {key: n})."""
    out = []
    for (fn, attr, b), (_, _, a) in zip(before, after):
        if isinstance(a, dict):
            d = {k: n - b.get(k, 0) for k, n in a.items()
                 if n != b.get(k, 0)}
            if d:
                out.append((fn, attr, d))
        elif a != b:
            out.append((fn, attr, a - b))
    return out


def add_launches(delta) -> None:
    """Add one replay's launches to the wrappers' counters."""
    for fn, attr, d in delta:
        if isinstance(d, dict):
            cur = getattr(fn, attr)
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + n
        else:
            setattr(fn, attr, getattr(fn, attr) + d)


@dataclasses.dataclass
class StepGraph:
    """One segment kind's captured step."""
    graph: torch.cuda.CUDAGraph
    launches: list                        # counts one replay adds
    noise_bufs: List[torch.Tensor]        # static draws (noise_fn mode)
    aux: Optional[torch.Tensor]           # the step's FLF mask, or None


def _covered(kind, by) -> bool:
    return kind[0] <= by[0] and kind[1] <= by[1]


def _outputs_into(static, new) -> None:
    """Write a body's carry into the static buffers; an output that is one
    of the inputs (m1 <- m0) is copied out first."""
    new = [n.clone() if any(n is s for s in static) else n for n in new]
    for s, n in zip(static, new):
        s.copy_(n)


def run_plan_graphs(plan, make_body: Callable, carry, *,
                    generator: Optional[torch.Generator] = None,
                    noise_fn: Optional[Callable] = None,
                    on_step: Optional[Callable] = None,
                    on_chunk: Optional[Callable] = None):
    """``sampling/engine.py::run_plan_eager`` with every step a replay of
    its kind's captured graph. ``on_step(i, carry, aux)`` gets the static
    buffers (the next replay overwrites them: copy what you keep). The
    chunks of the plan end in a synchronize. Returns the final carry (the
    static buffers)."""
    dev = carry[0].device
    if dev.type != "cuda":
        raise ValueError(f"run_plan_graphs: the carry is on {dev}")
    static = tuple(t.clone() for t in carry)
    n_xs = len(plan[0][2])
    xs_buf = torch.zeros((n_xs,), dtype=torch.float32, device=dev)
    xs_views = xs_buf.unbind(0)
    kinds: List[Tuple[bool, bool]] = []
    first_row: Dict[Tuple[bool, bool], np.ndarray] = {}
    for seg_fuse, seg_irr, xs in plan:
        kind = (seg_fuse, seg_irr)
        if kind not in kinds:
            kinds.append(kind)
            first_row[kind] = np.asarray([t[0] for t in xs], np.float32)
    bodies = {k: make_body(*k) for k in kinds}

    side = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    warm_gen = torch.Generator(device=dev).manual_seed(0)
    drawn: List[tuple] = []

    def warm_draw(shape, like):
        drawn.append((tuple(shape), like.dtype))
        return torch.randn(shape, generator=warm_gen, dtype=like.dtype,
                           device=like.device)

    need: Dict[tuple, int] = {}
    with torch.cuda.stream(side):
        for kind in kinds:
            if any(k != kind and _covered(kind, k) for k in kinds):
                continue
            xs_buf.copy_(torch.from_numpy(first_row[kind]).to(dev))
            drawn.clear()
            bodies[kind](tuple(t.clone() for t in static), xs_views,
                         warm_draw)
            for key in set(drawn):
                need[key] = max(need.get(key, 0), drawn.count(key))
    cur.wait_stream(side)
    torch.cuda.synchronize(dev)
    # noise_fn's static inputs, shared by the kinds (one replay at a time)
    static_draws = {key: [torch.empty(key[0], dtype=key[1], device=dev)
                          for _ in range(n)] for key, n in need.items()}

    graphs: Dict[Tuple[bool, bool], StepGraph] = {}
    pool = None
    for kind in kinds:
        g = torch.cuda.CUDAGraph()
        noise_bufs: List[torch.Tensor] = []
        if noise_fn is None and generator is not None:
            # the device's default generator is registered by the capture
            g.register_generator_state(generator)

        def draw(shape, like, _bufs=noise_bufs):
            if noise_fn is None:
                return torch.randn(shape, generator=generator,
                                   dtype=like.dtype, device=like.device)
            key = (tuple(shape), like.dtype)
            used = sum(1 for b in _bufs
                       if (tuple(b.shape), b.dtype) == key)
            if used >= len(static_draws.get(key, ())):
                raise RuntimeError(f"run_plan_graphs: a draw of {key} that "
                                   "the warm-up step did not make")
            _bufs.append(static_draws[key][used])
            return _bufs[-1]

        before = _snapshot()
        aux_out = [None]
        try:
            # thread_local: a call another thread makes meanwhile (the NCCL
            # watchdog's) does not end the capture
            with torch.cuda.graph(g, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                new, aux = bodies[kind](static, xs_views, draw)
                _outputs_into(static, new)
                if aux is not None:
                    aux_out[0] = aux.clone()
                del new, aux
            after = _snapshot()
        finally:
            _restore(before)
        graphs[kind] = StepGraph(g, _delta(before, after), noise_bufs,
                                 aux_out[0])
        pool = g.pool()

    for ci, (seg_fuse, seg_irr, xs) in enumerate(plan):
        sg = graphs[(seg_fuse, seg_irr)]
        tab = torch.from_numpy(np.stack(xs, axis=1)).to(dev)
        for j in range(tab.shape[0]):
            xs_buf.copy_(tab[j])
            for buf in sg.noise_bufs:
                buf.copy_(torch.as_tensor(noise_fn(tuple(buf.shape)),
                                          dtype=buf.dtype))
            sg.graph.replay()
            add_launches(sg.launches)
            if on_step is not None:
                on_step(int(xs[-1][j]), static, sg.aux)
        torch.cuda.synchronize(dev)
        if on_chunk is not None:
            on_chunk(ci, tab.shape[0], seg_fuse, seg_irr, static[0])
    return static
