"""Constants made on the host and kept on a device.

A step captured as a CUDA graph may not copy from host memory (the copy
synchronizes), so a table that a forward would build with numpy and move
to the card on every call is made once per key and device here, before any
capture, and the same tensor is handed out after. Callers must not change
it in place. It is made outside inference mode, so autograd may save it.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

_CACHE: Dict[Tuple[Hashable, str], torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], torch.Tensor],
                    device=None) -> torch.Tensor:
    """``make()`` (a host tensor) on ``device`` (None: the CPU), made once
    per ``(key, device)``."""
    dev = torch.device(device if device is not None else "cpu")
    k = (key, str(dev))
    t = _CACHE.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = make().to(dev)
        _CACHE[k] = t
    return t
