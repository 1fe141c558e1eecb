"""Vision Transformer (counterpart of kubeflow_tpu/models/vit.py): patchify
as a reshape, a [CLS] token and learned positions, pre-norm blocks with
RMSNorm, bidirectional flash attention (B1 forward, B2/B3 backward on the
card: `flash_attention(..., causal=False)`, as the JAX model calls its
flash kernel) and a tanh-approximate GELU MLP, the head in f32.

At ViT-B/16 (`ViTConfig.vit_b16`) a 224-pixel image is 196 patches and
the [CLS] token, S = 197 at head dim 64: the kernels run a ragged last
tile with no causal mask. `attention_impl="xla"` raises, as the port's
LlamaConfig does: a CUDA tensor always takes the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.common import (classification_loss, he,
                                              init_tree, meta_tree,
                                              set_dtypes, unstack_layers)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.norms import rms_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    n_classes: int = 10
    d_model: int = 192
    n_layers: int = 6
    n_heads: int = 3
    d_ff: int = 768
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-6
    remat: bool = False
    attention_impl: str = "flash"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("patch_size must divide image_size")
        if self.d_model % self.n_heads:
            raise ValueError("n_heads must divide d_model")
        if self.attention_impl == "xla":
            raise ValueError(
                "attention_impl='xla': the port has no plain-version path "
                "on the card; CUDA tensors always take the kernels "
                "(ROADMAP.md north star, rule 4)")
        if self.attention_impl != "flash":
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}")
        set_dtypes(self, "dtype", "param_dtype")

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_b16(n_classes: int = 1000) -> "ViTConfig":
        """ViT-B/16 at 224 pixels: 12 layers of width 768, 12 heads."""
        return ViTConfig(image_size=224, patch_size=16, n_classes=n_classes,
                         d_model=768, n_layers=12, n_heads=12, d_ff=3072)


def _spec(cfg: ViTConfig) -> Params:
    """(shape, fill) of each leaf, the JAX init's scheme: He-normal
    matmuls, 0.02-normal positions, a zero [CLS] and head, unit norms."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    pdim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    return {
        "patch_embed": {"w": ((pdim, d), he(pdim)), "b": ((d,), "zeros")},
        "pos_embed": ((cfg.n_patches + 1, d), 0.02),
        "cls": ((d,), "zeros"),
        "layers": {
            "attn_norm": ((L, d), "ones"),
            "wq": ((L, d, d), he(d)), "wk": ((L, d, d), he(d)),
            "wv": ((L, d, d), he(d)), "wo": ((L, d, d), he(d)),
            "mlp_norm": ((L, d), "ones"),
            "w_up": ((L, d, f), he(d)), "w_down": ((L, f, d), he(f)),
        },
        "final_norm": ((d,), "ones"),
        "head": {"w": ((d, cfg.n_classes), "zeros"),
                 "b": ((cfg.n_classes,), "zeros")},
    }


def init(cfg: ViTConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """Random params from `seed` in cfg.param_dtype (`_spec`)."""
    return init_tree(_spec(cfg), seed=seed, device=device, keep=keep,
                     dtype=cfg.param_dtype)


def logical_axes(cfg: ViTConfig) -> Params:
    return {
        "patch_embed": {"w": (None, "embed"), "b": ("embed",)},
        "pos_embed": (None, "embed"),
        "cls": ("embed",),
        "layers": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", None),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": (None,),
        "head": {"w": ("embed", None), "b": (None,)},
    }


def abstract_params(cfg: ViTConfig) -> Params:
    return meta_tree(_spec(cfg), cfg.param_dtype)


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, patch_dim], row-major patches."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _layer_body(cfg: ViTConfig, x: torch.Tensor,
                layer: Params) -> torch.Tensor:
    b, s, d = x.shape
    nh, dt = cfg.n_heads, cfg.dtype
    hd = d // nh
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = ((h @ layer[n].to(dt)).reshape(b, s, nh, hd)
               for n in ("wq", "wk", "wv"))
    out = flash_attention(q, k, v, causal=False)
    x = x + out.reshape(b, s, d) @ layer["wo"].to(dt)
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    h = F.gelu(h @ layer["w_up"].to(dt), approximate="tanh")
    return x + h @ layer["w_down"].to(dt)


def apply(params: Params, images: torch.Tensor,
          cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] float images -> [B, n_classes] f32 logits."""
    b = images.shape[0]
    dt = cfg.dtype
    x = _patchify(images.to(dt), cfg)
    x = x @ params["patch_embed"]["w"].to(dt) \
        + params["patch_embed"]["b"].to(dt)
    cls = params["cls"].to(dt).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dt)

    def body(x, layer):
        return _layer_body(cfg, x, layer)

    for layer in unstack_layers(params["layers"]):
        x = (checkpoint(body, x, layer, use_reentrant=False) if cfg.remat
             else body(x, layer))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, 0].float() @ params["head"]["w"].float() \
        + params["head"]["b"]


def loss_fn(params: Params, batch: dict[str, torch.Tensor], cfg: ViTConfig):
    return classification_loss(apply(params, batch["image"], cfg),
                               batch["label"])
