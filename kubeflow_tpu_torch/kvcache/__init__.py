"""KV memory of the port (counterpart of kubeflow_tpu/kvcache): the block
pool of paged serving and the radix prefix index both engines bank
prompt prefixes into, and its stage-partitioned view, the stage-sharded
engine's store."""

from kubeflow_tpu_torch.kvcache.pool import BlockPool
from kubeflow_tpu_torch.kvcache.radix import (Block, MatchResult,
                                              RadixKVCache, StageMatchResult,
                                              StagePartitionedKVCache)

__all__ = ["Block", "BlockPool", "MatchResult", "RadixKVCache",
           "StageMatchResult", "StagePartitionedKVCache"]
