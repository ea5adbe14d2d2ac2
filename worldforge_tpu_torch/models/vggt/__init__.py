"""VGGT: DINOv2 backbone, alternating-attention aggregator, camera and DPT depth heads."""
