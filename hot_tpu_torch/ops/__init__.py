"""Small-matrix numerics, transfers and the fused CUDA kernels."""
