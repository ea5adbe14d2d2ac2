"""Training of the port: the flow-matching step (``step.py``) and LoRA
adapters over a frozen base (``lora.py``)."""

from worldforge_tpu_torch.training.lora import (LORA_TARGETS, apply_lora,
                                                export_reference_lora,
                                                init_lora, load_lora,
                                                make_lora_train_step,
                                                save_lora)
from worldforge_tpu_torch.training.step import (flow_match_loss,
                                                longcat_forward,
                                                make_train_step,
                                                trainable_leaves)

__all__ = ["LORA_TARGETS", "apply_lora", "export_reference_lora",
           "flow_match_loss", "init_lora", "load_lora", "longcat_forward",
           "make_lora_train_step", "make_train_step", "save_lora",
           "trainable_leaves"]
