"""worldforge_tpu_torch: the PyTorch/CUDA port of worldforge_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The package mirrors the JAX package's module paths and public names
(``models/wan/dit.py::wan_dit_forward``, ``pipelines/wan_i2v.py::
WanI2VPipeline.generate``, ...). It imports ``torch`` and never ``jax`` or
``worldforge_tpu``. Every TPU kernel on the ported path is a hand-written
Hopper kernel under ``ops/`` (CUDA C++ sources in ``csrc/``, Triton kernels
inline), each with a plain PyTorch version beside it that the wrapper uses
only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"
