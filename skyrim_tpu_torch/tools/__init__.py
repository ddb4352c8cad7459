"""Measurement tools for the port's kernels; each runs on a CUDA card."""
