"""Tensor ops of the port: quantization, W8A8 matmul, rope, attention,
and the wrappers of the hand-written CUDA kernels."""
