"""KV memory of the port (counterpart of kubeflow_tpu/kvcache): the block
pool of paged serving and the radix prefix index both engines bank
prompt prefixes into. The stage-partitioned index of the stage-sharded
engine is not ported."""

from kubeflow_tpu_torch.kvcache.pool import BlockPool
from kubeflow_tpu_torch.kvcache.radix import Block, MatchResult, RadixKVCache

__all__ = ["Block", "BlockPool", "MatchResult", "RadixKVCache"]
