"""MNIST CNN (counterpart of kubeflow_tpu/models/mnist_cnn.py; BASELINE
config #1, the minimum end-to-end slice): two 3x3 SAME conv + ReLU +
2x2 max-pool blocks, then two dense layers. Images are NHWC, kernels
HWIO, and the flatten is in NHWC order, as in the JAX model, so its
params carry over leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.common import (classification_loss, conv_same,
                                              he, init_tree, meta_tree, nchw,
                                              nhwc, set_dtypes)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    n_classes: int = 10
    c1: int = 32
    c2: int = 64
    hidden: int = 128
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        set_dtypes(self, "dtype")


def _spec(cfg: MnistConfig) -> Params:
    """(shape, fill) of each leaf: He-normal weights, zero biases."""
    flat = 7 * 7 * cfg.c2

    def layer(shape, fan_in):
        return {"w": (shape, he(fan_in)), "b": ((shape[-1],), "zeros")}

    return {"conv1": layer((3, 3, 1, cfg.c1), 9),
            "conv2": layer((3, 3, cfg.c1, cfg.c2), 9 * cfg.c1),
            "fc1": layer((flat, cfg.hidden), flat),
            "fc2": layer((cfg.hidden, cfg.n_classes), cfg.hidden)}


def init(cfg: MnistConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """Random f32 params from `seed` (`_spec`)."""
    return init_tree(_spec(cfg), seed=seed, device=device, keep=keep)


def logical_axes(cfg: MnistConfig) -> Params:
    return {
        "conv1": {"w": (None, None, "conv_in", "conv_out"), "b": (None,)},
        "conv2": {"w": (None, None, "conv_in", "conv_out"), "b": (None,)},
        "fc1": {"w": ("embed", "mlp"), "b": (None,)},
        "fc2": {"w": ("mlp", None), "b": (None,)},
    }


def abstract_params(cfg: MnistConfig) -> Params:
    return meta_tree(_spec(cfg))


def _conv_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    x = F.relu(conv_same(x, p["w"]) + p["b"][:, None, None])
    return F.max_pool2d(x, 2, 2)   # VALID


def apply(params: Params, images: torch.Tensor,
          cfg: MnistConfig) -> torch.Tensor:
    """images [B, 28, 28, 1] -> logits [B, n_classes]."""
    x = nchw(images, cfg.dtype)
    x = _conv_block(x, params["conv1"])
    x = _conv_block(x, params["conv2"])
    x = nhwc(x).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: MnistConfig):
    return classification_loss(apply(params, batch["image"], cfg),
                               batch["label"])
