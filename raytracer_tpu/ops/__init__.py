"""Pallas-Triton kernels for NVIDIA GPUs (the native compute tier)."""
