"""Training data (counterpart of kubeflow_tpu/training/data.py): the
dataset spec and the synthetic token stream of the Llama family. The
generator makes the same numpy `default_rng` calls as the JAX package, so
the two yield byte-equal batches from one seed. The token_file and
array_file loaders are queued in ROADMAP.md."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

LLAMA_FAMILY = ("llama",)


@dataclasses.dataclass
class DatasetConfig:
    """What a job trains on (the `dataset` key of a trainer config)."""

    type: str = "synthetic"
    path: str | None = None
    seq_len: int = 128
    seed: int | None = None   # falls back to TrainerConfig.seed
    prefer_native: bool = True   # token_file
    shuffle: bool = True   # array_file


def synthetic_tokens(batch_size: int, seq_len: int, vocab_size: int,
                     seed: int = 0) -> Iterator[dict[str, Any]]:
    """Infinite LM batches with a learnable structure (repeating n-grams
    with 2% noise) so the loss can fall: {"tokens": int32 [B, seq_len]}."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab_size, size=(64,))
    while True:
        starts = rng.integers(0, 64, size=(batch_size,))
        tokens = np.stack([np.resize(np.roll(base, -s), seq_len)
                           for s in starts])
        noise = rng.random(tokens.shape) < 0.02
        tokens = np.where(noise, rng.integers(0, vocab_size, tokens.shape),
                          tokens)
        yield {"tokens": tokens.astype(np.int32)}


def make_dataset(ds: DatasetConfig, model: str, model_cfg, batch_size: int,
                 fallback_seed: int = 0) -> Iterator[dict[str, Any]]:
    """A DatasetConfig as a batch iterator, for one process."""
    seed = ds.seed if ds.seed is not None else fallback_seed
    if ds.type == "synthetic":
        if model not in LLAMA_FAMILY:
            raise KeyError(f"no synthetic data recipe for model {model!r}")
        return synthetic_tokens(batch_size, ds.seq_len, model_cfg.vocab_size,
                                seed)
    if ds.type in ("token_file", "array_file"):
        raise NotImplementedError(
            f"dataset.type={ds.type} is not ported yet (ROADMAP.md, queue "
            "A: the token_file/array_file loaders)")
    raise ValueError(f"unknown dataset type {ds.type!r} "
                     "(expected synthetic | token_file | array_file)")
