"""NAS-searchable CNN and the DARTS supernet (counterpart of
kubeflow_tpu/models/nas_cnn.py), Katib's two NAS modes:

1. Trial-based search: `NasCnnConfig.ops` picks one op of OP_NAMES per
   layer (`nas_cnn`); each architecture trains as an ordinary trial.
2. Differentiable search (`darts_supernet`): every layer runs all the
   ops and mixes them by softmax(alpha); `derive` reads the argmax
   architecture off trained alphas.

Ops are shape-preserving: conv3/conv5 (SAME) + ReLU; sep3, a depthwise
3x3 (HWIO [3, 3, 1, C], PyTorch's [C, 1, 3, 3] with groups=C) then a
pointwise 1x1, + ReLU; 3x3 stride-1 SAME max and average pools (the
average divides by 9 at the borders too, XLA's zero-padded window sum);
identity. After every `reduce_every`-th layer a VALID 2x2 stride-2 max
pool halves the map (flooring odd sizes) while it is wider than 2.
Images are NHWC and kernels HWIO, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.common import (classification_loss, conv_same,
                                              he, init_tree, meta_tree, nchw,
                                              set_dtypes)

Params = dict[str, Any]

OP_NAMES: tuple[str, ...] = ("conv3", "conv5", "sep3", "maxpool", "avgpool",
                             "identity")


@dataclasses.dataclass(frozen=True)
class NasCnnConfig:
    n_classes: int = 10
    channels: int = 16
    image_size: int = 16
    in_channels: int = 3
    ops: tuple[str, ...] = ("conv3", "conv3", "conv3")   # one per layer
    reduce_every: int = 2      # stride-2 pool after every k-th layer
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "ops", tuple(self.ops))
        for op in self.ops:
            if op not in OP_NAMES:
                raise ValueError(f"unknown op {op!r}; known: {OP_NAMES}")
        set_dtypes(self, "dtype")


def _op_spec(op: str, c: int) -> Params:
    """(shape, fill) of each leaf of one op: He-normal kernels, a zero
    bias; parameter-free ops have none."""
    if op in ("conv3", "conv5"):
        k = 3 if op == "conv3" else 5
        return {"w": ((k, k, c, c), he(k * k * c)), "b": ((c,), "zeros")}
    if op == "sep3":
        return {"dw": ((3, 3, 1, c), he(9)), "pw": ((1, 1, c, c), he(c)),
                "b": ((c,), "zeros")}
    return {}


def _spec(cfg: NasCnnConfig, layers: list) -> Params:
    c = cfg.channels
    return {"stem": {"w": ((3, 3, cfg.in_channels, c),
                           he(9 * cfg.in_channels)),
                     "b": ((c,), "zeros")},
            "layers": layers,
            "head": {"w": ((c, cfg.n_classes), he(c)),
                     "b": ((cfg.n_classes,), "zeros")}}


def _apply_op(op: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    """One op on NCHW x."""
    if op in ("conv3", "conv5"):
        return F.relu(conv_same(x, p["w"]) + p["b"][:, None, None])
    if op == "sep3":
        y = conv_same(x, p["dw"], groups=x.shape[1])
        y = conv_same(y, p["pw"])
        return F.relu(y + p["b"][:, None, None])
    if op == "maxpool":
        return F.max_pool2d(x, 3, 1, padding=1)
    if op == "avgpool":
        return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)
    return x   # identity


def _reduce(x: torch.Tensor, i: int, cfg: NasCnnConfig) -> torch.Tensor:
    if (i + 1) % cfg.reduce_every == 0 and x.shape[2] > 2:
        return F.max_pool2d(x, 2, 2)   # VALID: odd sizes floor
    return x


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = x.mean(dim=(2, 3))   # global average pool
    return x @ params["head"]["w"] + params["head"]["b"]


# -- mode 1: a fixed architecture (one trial) ---------------------------------

def _trial_spec(cfg: NasCnnConfig) -> Params:
    return _spec(cfg, [_op_spec(op, cfg.channels) for op in cfg.ops])


def init(cfg: NasCnnConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    return init_tree(_trial_spec(cfg), seed=seed, device=device, keep=keep)


def _op_axes(op: str) -> Params:
    """Logical sharding axes of one op's params (the trial model's and
    the supernet's)."""
    if op in ("conv3", "conv5"):
        return {"w": (None, None, "conv_in", "conv_out"), "b": (None,)}
    if op == "sep3":
        return {"dw": (None, None, None, "conv_out"),
                "pw": (None, None, "conv_in", "conv_out"), "b": (None,)}
    return {}


def logical_axes(cfg: NasCnnConfig) -> Params:
    return {
        "stem": {"w": (None, None, "conv_in", "conv_out"), "b": (None,)},
        "layers": [_op_axes(op) for op in cfg.ops],
        "head": {"w": ("embed", None), "b": (None,)},
    }


def abstract_params(cfg: NasCnnConfig) -> Params:
    return meta_tree(_trial_spec(cfg))


def apply(params: Params, images: torch.Tensor,
          cfg: NasCnnConfig) -> torch.Tensor:
    x = _apply_op("conv3", params["stem"], nchw(images, cfg.dtype))
    for i, op in enumerate(cfg.ops):
        x = _reduce(_apply_op(op, params["layers"][i], x), i, cfg)
    return _head(params, x)


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: NasCnnConfig):
    return classification_loss(apply(params, batch["image"], cfg),
                               batch["label"])


# -- mode 2: the DARTS supernet -----------------------------------------------

def _darts_spec(cfg: NasCnnConfig) -> Params:
    spec = _spec(cfg, [{op: _op_spec(op, cfg.channels) for op in OP_NAMES}
                       for _ in cfg.ops])
    spec["alpha"] = ((len(cfg.ops), len(OP_NAMES)), "zeros")
    return spec


def darts_init(cfg: NasCnnConfig, *, seed: int = 0,
               device="cuda", keep=None) -> Params:
    """Every layer holds every op's params, plus architecture logits
    alpha [n_layers, n_ops] at 0 (a uniform mixture)."""
    return init_tree(_darts_spec(cfg), seed=seed, device=device, keep=keep)


def darts_logical_axes(cfg: NasCnnConfig) -> Params:
    fixed = logical_axes(cfg)
    layers = [{op: _op_axes(op) for op in OP_NAMES} for _ in cfg.ops]
    return {"stem": fixed["stem"], "layers": layers,
            "alpha": (None, None), "head": fixed["head"]}


def darts_abstract_params(cfg: NasCnnConfig) -> Params:
    return meta_tree(_darts_spec(cfg))


def darts_apply(params: Params, images: torch.Tensor,
                cfg: NasCnnConfig) -> torch.Tensor:
    """Every op of every layer runs; the layer's output is the
    softmax(alpha)-weighted sum of its ops' outputs."""
    x = _apply_op("conv3", params["stem"], nchw(images, cfg.dtype))
    weights = torch.softmax(params["alpha"], dim=-1)
    for i, layer_ops in enumerate(params["layers"]):
        outs = torch.stack([_apply_op(op, layer_ops[op], x)
                            for op in OP_NAMES])
        x = _reduce(torch.tensordot(weights[i], outs, dims=1), i, cfg)
    return _head(params, x)


def darts_loss_fn(params: Params, batch: dict[str, torch.Tensor],
                  cfg: NasCnnConfig):
    return classification_loss(darts_apply(params, batch["image"], cfg),
                               batch["label"])


def derive(alpha) -> tuple[str, ...]:
    """The discrete architecture of trained alphas: the argmax op of each
    layer (the first on ties)."""
    idx = torch.as_tensor(alpha).argmax(dim=-1)
    return tuple(OP_NAMES[int(i)] for i in idx)
