"""kubeflow_tpu_torch: the PyTorch/CUDA port of kubeflow_tpu for NVIDIA
Hopper (H100).

The JAX package `kubeflow_tpu` stays the reference; this package keeps its
module names (`ops.quant`, `models.llama`, `serving.llm`, ...) so each
counterpart is easy to find, and never imports JAX or `kubeflow_tpu`.
Every TPU Pallas kernel on a ported path is a hand-written CUDA kernel
here (`csrc/`), built for sm_90a on first use. Entry points run on the GPU
unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
