"""The parallel layer on ``torch.distributed``: Ulysses, ring attention,
block-sparse ring context parallelism, the 2-D spatial split, FSDP and the
multi-rank dry run (counterpart of ``worldforge_tpu/parallel``)."""
