"""ResNet, v1.5 bottleneck with GroupNorm (counterpart of
kubeflow_tpu/models/resnet.py; BASELINE config #4, the Katib sweep over
ResNet-50).

As in the JAX model: NHWC images, HWIO kernels, convolutions with XLA's
SAME padding (`models/common.py` `conv_same`: a stride-2 window pads one
more row and column on the high side than on the low, where PyTorch's
`padding=` is symmetric), the stem's 3x3 stride-2 max pool padded the
same way with -inf, GroupNorm with f32 statistics and the population
variance (the group count lowered until it divides the channels), and
f32 logits after a head in the compute dtype. The activations run in
PyTorch's channels_last layout (the NHWC images permuted), so cuDNN takes
its NHWC kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.common import (classification_loss, conv_same,
                                              he, init_tree, max_pool_same,
                                              meta_tree, nchw, set_dtypes)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)   # resnet-50
    width: int = 64
    n_classes: int = 1000
    groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # the synthetic data's image size (training/data.py for_model); the
    # convolutions take any size
    image_size: int = 64

    def __post_init__(self):
        object.__setattr__(self, "stage_sizes", tuple(self.stage_sizes))
        set_dtypes(self, "dtype", "param_dtype")

    @staticmethod
    def resnet50(n_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), n_classes=n_classes)

    @staticmethod
    def tiny(n_classes: int = 10) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), width=16, n_classes=n_classes,
                            groups=4)


def _spec(cfg: ResNetConfig) -> Params:
    """(shape, fill) of each leaf: He-normal conv kernels, unit norms, a
    0.01-normal head."""
    def conv(shape):
        c = shape[-1]
        return {"w": (shape, he(shape[0] * shape[1] * shape[2])),
                "norm": {"w": ((c,), "ones"), "b": ((c,), "zeros")}}

    spec: Params = {"stem": conv((7, 7, 3, cfg.width)), "stages": []}
    c_in = cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        c_mid = cfg.width * 2 ** i
        c_out = c_mid * 4
        stage = []
        for j in range(n_blocks):
            block = {"conv1": conv((1, 1, c_in, c_mid)),
                     "conv2": conv((3, 3, c_mid, c_mid)),
                     "conv3": conv((1, 1, c_mid, c_out))}
            if j == 0:
                block["proj"] = conv((1, 1, c_in, c_out))
            stage.append(block)
            c_in = c_out
        spec["stages"].append(stage)
    spec["fc"] = {"w": ((c_in, cfg.n_classes), 0.01),
                  "b": ((cfg.n_classes,), "zeros")}
    return spec


def init(cfg: ResNetConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """Random params from `seed` in cfg.param_dtype (`_spec`)."""
    return init_tree(_spec(cfg), seed=seed, device=device, keep=keep,
                     dtype=cfg.param_dtype)


def logical_axes(cfg: ResNetConfig) -> Params:
    def conv_ax():
        return {"w": (None, None, "conv_in", "conv_out"),
                "norm": {"w": (None,), "b": (None,)}}

    axes: Params = {"stem": conv_ax(), "stages": []}
    for n_blocks in cfg.stage_sizes:
        stage = []
        for j in range(n_blocks):
            block = {"conv1": conv_ax(), "conv2": conv_ax(),
                     "conv3": conv_ax()}
            if j == 0:
                block["proj"] = conv_ax()
            stage.append(block)
        axes["stages"].append(stage)
    axes["fc"] = {"w": ("embed", None), "b": (None,)}
    return axes


def abstract_params(cfg: ResNetConfig) -> Params:
    return meta_tree(_spec(cfg), cfg.param_dtype)


def _groups(groups: int, c: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _group_norm(x: torch.Tensor, norm: Params, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NCHW x in f32 (population variance, eps inside the
    rsqrt), the affine in f32, cast back to x's dtype."""
    c = x.shape[1]
    out = F.group_norm(x.float(), _groups(groups, c), norm["w"].float(),
                       norm["b"].float(), eps)
    return out.to(x.dtype)


def _conv_norm(x, p, groups, stride=1):
    return _group_norm(conv_same(x, p["w"], stride), p["norm"], groups)


def _bottleneck(x: torch.Tensor, block: Params, cfg: ResNetConfig,
                stride: int) -> torch.Tensor:
    g = cfg.groups
    h = F.relu(_conv_norm(x, block["conv1"], g))
    h = F.relu(_conv_norm(h, block["conv2"], g, stride))
    h = _conv_norm(h, block["conv3"], g)
    residual = (_conv_norm(x, block["proj"], g, stride) if "proj" in block
                else x)
    return F.relu(h + residual)


def apply(params: Params, images: torch.Tensor,
          cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] -> logits [B, n_classes] f32."""
    x = nchw(images, cfg.dtype)
    x = F.relu(_conv_norm(x, params["stem"], cfg.groups, stride=2))
    x = max_pool_same(x, 3, 2)
    for i, stage in enumerate(params["stages"]):
        for j, block in enumerate(stage):
            x = _bottleneck(x, block, cfg, 2 if (i > 0 and j == 0) else 1)
    x = x.mean(dim=(2, 3))
    dt = cfg.dtype
    logits = x @ params["fc"]["w"].to(dt) + params["fc"]["b"].to(dt)
    return logits.float()


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: ResNetConfig):
    return classification_loss(apply(params, batch["image"], cfg),
                               batch["label"])
