"""Command-line tools for working on the port's CUDA kernels."""
