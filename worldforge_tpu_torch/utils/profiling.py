"""Per-phase wall timers with a device synchronize, and trace capture.

Counterpart of ``worldforge_tpu/utils/profiling.py``, with the same names
and the same report. ``phase(sync_on=...)`` synchronizes the CUDA devices
of the tensors it is given before it stops the clock (JAX's
``block_until_ready``); ``trace(logdir)`` records CPU and CUDA activity
with ``torch.profiler`` and writes a Chrome trace (open in Perfetto or
``chrome://tracing``) into ``logdir``; ``annotate`` names a region in such
a trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch

_PHASES: Dict[str, float] = {}
_COUNTS: Dict[str, int] = {}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _sync(x=None) -> None:
    """Synchronize every CUDA device that holds a tensor of ``x`` (a
    tensor or a nest of dicts, lists and tuples of them)."""
    if x is None:
        return
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase(name: str, sync_on=None):
    """Accumulating phase timer: ``with phase("denoise"): ...``. Pass the
    phase's output (or a container that will hold it) as ``sync_on`` for
    the device's time: the clock stops after its devices synchronize."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(sync_on)
        dt = time.perf_counter() - t0
        _PHASES[name] = _PHASES.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def phase_report(reset: bool = True) -> Dict[str, Dict[str, float]]:
    rep = {k: {"total_s": round(v, 4), "calls": _COUNTS[k],
               "mean_s": round(v / _COUNTS[k], 4)}
           for k, v in _PHASES.items()}
    if reset:
        _PHASES.clear()
        _COUNTS.clear()
    return rep


def print_phase_report(reset: bool = True) -> None:
    print(json.dumps(phase_report(reset), indent=2))


@contextlib.contextmanager
def trace(logdir: str = "worldforge_trace", cuda: bool = True):
    """Record the block with ``torch.profiler`` and write its Chrome trace
    to ``<logdir>/trace.json``; yields the profiler (its
    ``key_averages()`` is the table). ``cuda=False`` records CPU activity
    only, which the caller asks for explicitly; with ``cuda=True`` the
    card must be there."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("trace(cuda=True): no CUDA device; pass "
                               "cuda=False to record CPU activity only")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield
