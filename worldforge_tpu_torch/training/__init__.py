"""Training-side modules of the port: LoRA adapters (``lora.py``). The
training steps (``make_train_step``, ``make_lora_train_step``) belong to a
later slice of the port."""

from worldforge_tpu_torch.training.lora import (LORA_TARGETS, apply_lora,
                                                export_reference_lora,
                                                init_lora, load_lora,
                                                save_lora)

__all__ = ["LORA_TARGETS", "apply_lora", "export_reference_lora",
           "init_lora", "load_lora", "save_lora"]
