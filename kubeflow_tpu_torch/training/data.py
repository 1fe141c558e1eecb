"""Training data (counterpart of kubeflow_tpu/training/data.py): the
dataset spec and its three sources,

  synthetic   each registered model's generator (`for_model`, the
              default): token streams for the decoders, labelled
              images for the vision families, marked text for BERT;
  token_file  a flat uint32 token corpus through the C++ prefetching
              loader (`training/loader.py`);
  array_file  an .npz of named arrays, epoch-cycled minibatches.

Each makes the same numpy calls as the JAX package, so the two yield
byte-equal batches from one seed. The port runs one process, so a
process's share is the whole batch (process count 1, index 0)."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

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


def synthetic_images(batch_size: int, image_size: int, channels: int,
                     n_classes: int, seed: int = 0) -> Iterator[dict[str, Any]]:
    """Class-conditional gaussian blobs, a learnable classification:
    {"image": f32 [B, H, W, C], "label": int32 [B]}."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, image_size, image_size, channels))
    while True:
        labels = rng.integers(0, n_classes, size=(batch_size,))
        images = protos[labels] + 0.5 * rng.normal(
            size=(batch_size, image_size, image_size, channels))
        yield {"image": images.astype(np.float32),
               "label": labels.astype(np.int32)}


def synthetic_classification_text(batch_size: int, seq_len: int,
                                  vocab_size: int, n_classes: int = 2,
                                  seed: int = 0) -> Iterator[dict[str, Any]]:
    """BERT-style: token 0 is [CLS] and token 1 marks the label (label +
    1); the rest are random ids past the markers."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, n_classes, size=(batch_size,))
        tokens = rng.integers(n_classes + 1, vocab_size,
                              size=(batch_size, seq_len))
        tokens[:, 1] = labels + 1
        tokens[:, 0] = 0
        yield {"tokens": tokens.astype(np.int32),
               "label": labels.astype(np.int32)}


def array_dataset(arrays: dict[str, np.ndarray], batch_size: int,
                  shuffle: bool = True, seed: int = 0,
                  drop_remainder: bool = True) -> Iterator[dict[str, Any]]:
    """Epoch-cycling minibatches over in-memory arrays."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - batch_size + 1 if drop_remainder else n
        for i in range(0, stop, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}


def for_model(model: str, model_cfg, batch_size: int, seq_len: int = 128,
              seed: int = 0) -> Iterator[dict[str, Any]]:
    """The synthetic stream of a registered model."""
    if model in ("llama", "llama_lora", "mixtral"):
        return synthetic_tokens(batch_size, seq_len, model_cfg.vocab_size,
                                seed)
    if model == "bert":
        return synthetic_classification_text(
            batch_size, min(seq_len, model_cfg.max_seq_len),
            model_cfg.vocab_size, model_cfg.n_classes, seed)
    if model == "mnist_cnn":
        return synthetic_images(batch_size, 28, 1, model_cfg.n_classes, seed)
    if model == "resnet":
        return synthetic_images(batch_size, model_cfg.image_size, 3,
                                model_cfg.n_classes, seed)
    if model in ("nas_cnn", "darts_supernet", "vit"):
        return synthetic_images(batch_size, model_cfg.image_size,
                                model_cfg.in_channels, model_cfg.n_classes,
                                seed)
    raise KeyError(f"no synthetic data recipe for model {model!r}")


def make_dataset(ds: DatasetConfig, model: str, model_cfg, batch_size: int,
                 fallback_seed: int = 0) -> Iterator[dict[str, Any]]:
    """A DatasetConfig as this process's batch iterator. batch_size is the
    global batch, as in the JAX package; with one process (count 1, index
    0) its share is all of it. A token_file loader holds a file and a
    thread: close it when done."""
    pc, pi = 1, 0
    if batch_size % pc:
        raise ValueError(
            f"batch_size {batch_size} not divisible by {pc} processes")
    local = batch_size // pc
    seed = ds.seed if ds.seed is not None else fallback_seed
    if ds.type == "synthetic":
        return for_model(model, model_cfg, local, seq_len=ds.seq_len,
                         seed=seed + pi)
    if ds.type == "token_file":
        if not ds.path:
            raise ValueError("dataset.type=token_file requires dataset.path")
        from kubeflow_tpu_torch.training.loader import token_file_dataset

        return token_file_dataset(ds.path, local, ds.seq_len, seed=seed + pi,
                                  prefer_native=ds.prefer_native)
    if ds.type == "array_file":
        if not ds.path:
            raise ValueError("dataset.type=array_file requires dataset.path")
        with np.load(ds.path) as z:
            arrays = {k: z[k][pi::pc] for k in z.files}
        return array_dataset(arrays, local, shuffle=ds.shuffle, seed=seed)
    raise ValueError(f"unknown dataset type {ds.type!r} "
                     "(expected synthetic | token_file | array_file)")
