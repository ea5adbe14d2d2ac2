"""Dtype policy for mixed-precision inference, and device resolution.

Counterpart of ``worldforge_tpu/core/dtypes.py``: params and matmul inputs
bf16, norms / adaLN modulation / gated residual accumulation fp32 islands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy threaded through model apply functions."""

    param_dtype: torch.dtype = torch.bfloat16    # storage dtype of weights
    compute_dtype: torch.dtype = torch.bfloat16  # matmul input dtype
    norm_dtype: torch.dtype = torch.float32      # layernorm/rmsnorm internals
    mod_dtype: torch.dtype = torch.float32       # adaLN + gated residuals


DEFAULT_POLICY = Policy()

# Full-fp32 policy (the VAE and parity tests run fp32).
FP32_POLICY = Policy(
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    norm_dtype=torch.float32,
    mod_dtype=torch.float32,
)


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the card: resolve to ``cuda`` and raise when no GPU is
    present. The CPU is used only when the caller asks for it by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
