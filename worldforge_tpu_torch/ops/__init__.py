"""Ops of the port: attention, RoPE, modulated LayerNorm and the causal
conv3d, each with its hand-written Hopper kernel and plain PyTorch version.
"""
