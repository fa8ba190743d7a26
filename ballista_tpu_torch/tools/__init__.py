"""Measurement tools for the port's kernels on a CUDA card."""
