"""Compute on canonical frame planes: PyTorch ops and the CUDA kernels."""
