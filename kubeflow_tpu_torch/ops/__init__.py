"""Tensor ops of the port: plain PyTorch math and the CUDA kernel
wrappers (quant_matmul, flash_decode, flash_prefill, flash_attention)."""
