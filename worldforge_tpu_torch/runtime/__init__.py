"""The runtime layer: the CUDA graph step runner, layer streaming, the
fresh-process decode and the (empty) layout choice."""

from worldforge_tpu_torch.runtime.streaming import (StreamedBlocks,
                                                    StreamingExecutor,
                                                    stream_layers,
                                                    to_host_blocks)
from worldforge_tpu_torch.runtime.subproc import (decode_in_subprocess,
                                                  save_params_host)

__all__ = ["StreamedBlocks", "StreamingExecutor", "stream_layers",
           "to_host_blocks", "decode_in_subprocess", "save_params_host"]
