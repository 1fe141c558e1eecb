"""KV memory of the port (counterpart of kubeflow_tpu/kvcache): the block
pool of paged serving. The radix prefix cache is not ported yet."""

from kubeflow_tpu_torch.kvcache.pool import BlockPool

__all__ = ["BlockPool"]
