"""Conditioning encoders: UMT5 text and CLIP-H vision."""
