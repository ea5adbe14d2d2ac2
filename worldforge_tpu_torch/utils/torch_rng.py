"""torch.Generator noise handed out as numpy arrays.

Counterpart of ``worldforge_tpu/utils/torch_rng.py``: the reference draws its
noise from ``torch.manual_seed(42)`` / ``torch.Generator``; this class hands
out that stream in the order the pipeline consumes it, so two
implementations (or two devices) fed ``noise_fn=lambda s: rng.randn(*s)``
consume the same noise.
"""

from __future__ import annotations

import numpy as np
import torch


class TorchCompatibleRNG:
    """Stateful wrapper over a CPU ``torch.Generator`` producing numpy
    arrays."""

    def __init__(self, seed: int = 42):
        self._gen = torch.Generator().manual_seed(seed)

    def randn(self, *shape: int, dtype=np.float32) -> np.ndarray:
        t = torch.randn(shape, generator=self._gen)
        return t.numpy().astype(dtype)


def seed_torch_global(seed: int) -> None:
    """Seed torch's global generators (the CPU's and every card's), as
    ``transformers`` sampling reads them (``utils/prompt_extend.py``'s
    ``TransformersPromptExpander``)."""
    torch.manual_seed(seed % (2 ** 31))
