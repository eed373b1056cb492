"""Precision pinning and CUDA-event timing."""
