"""BERT-style bidirectional encoder for fine-tuning (counterpart of
kubeflow_tpu/models/bert.py; BASELINE config #2): a classification head
over the pooled [CLS] token.

Attention is ops/attention.py `mha` (non-causal, the attention mask as
segment ids, so padding attends only to padding), as the JAX model calls
its XLA `mha`, not a Pallas kernel. GELU is the tanh approximation
(`jax.nn.gelu`'s default).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.common import (classification_loss,
                                              init_tree, meta_tree,
                                              set_dtypes, unstack_layers)
from kubeflow_tpu_torch.ops.attention import mha
from kubeflow_tpu_torch.ops.norms import layer_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    n_classes: int = 2
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    def __post_init__(self):
        set_dtypes(self, "dtype", "param_dtype")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=8,
                          d_ff=128, max_seq_len=64)


def _spec(cfg: BertConfig) -> Params:
    """(shape, fill) of each leaf: dense weights and embeddings normal
    with std 0.02 (BERT's convention), norms ones, biases zeros."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def norm(*lead):
        return {"w": ((*lead, d), "ones"), "b": ((*lead, d), "zeros")}

    return {
        "embed": ((cfg.vocab_size, d), 0.02),
        "pos_embed": ((cfg.max_seq_len, d), 0.02),
        "type_embed": ((cfg.type_vocab, d), 0.02),
        "embed_norm": norm(),
        "layers": {
            "wqkv": ((L, d, 3 * d), 0.02), "bqkv": ((L, 3 * d), "zeros"),
            "wo": ((L, d, d), 0.02), "bo": ((L, d), "zeros"),
            "w1": ((L, d, f), 0.02), "b1": ((L, f), "zeros"),
            "w2": ((L, f, d), 0.02), "b2": ((L, d), "zeros"),
            "norm1": norm(L), "norm2": norm(L),
        },
        "pooler": {"w": ((d, d), 0.02), "b": ((d,), "zeros")},
        "classifier": {"w": ((d, cfg.n_classes), 0.02),
                       "b": ((cfg.n_classes,), "zeros")},
    }


def init(cfg: BertConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """Random params from `seed` in cfg.param_dtype (`_spec`)."""
    return init_tree(_spec(cfg), seed=seed, device=device, keep=keep,
                     dtype=cfg.param_dtype)


def logical_axes(cfg: BertConfig) -> Params:
    return {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        "type_embed": (None, "embed"),
        "embed_norm": {"w": ("embed_no_fsdp",), "b": ("embed_no_fsdp",)},
        "layers": {
            "wqkv": ("layers", "embed", "qkv"),
            "bqkv": ("layers", "qkv"),
            "wo": ("layers", "qkv", "embed"),
            "bo": ("layers", "embed_no_fsdp"),
            "w1": ("layers", "embed", "mlp"),
            "b1": ("layers", "mlp"),
            "w2": ("layers", "mlp", "embed"),
            "b2": ("layers", "embed_no_fsdp"),
            "norm1": {"w": ("layers", "embed_no_fsdp"),
                      "b": ("layers", "embed_no_fsdp")},
            "norm2": {"w": ("layers", "embed_no_fsdp"),
                      "b": ("layers", "embed_no_fsdp")},
        },
        "pooler": {"w": ("embed", "mlp"), "b": (None,)},
        "classifier": {"w": ("embed", None), "b": (None,)},
    }


def abstract_params(cfg: BertConfig) -> Params:
    """init's tree as meta tensors."""
    return meta_tree(_spec(cfg), cfg.param_dtype)


def _layer_body(cfg: BertConfig, x: torch.Tensor, layer: Params,
                seg: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    nh, hd, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
    qkv = x @ layer["wqkv"].to(dt) + layer["bqkv"].to(dt)
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(d, dim=-1))
    out = mha(q, k, v, causal=False, segment_ids=seg)
    out = out.reshape(b, s, d) @ layer["wo"].to(dt) + layer["bo"].to(dt)
    x = layer_norm(x + out, layer["norm1"]["w"], layer["norm1"]["b"],
                   cfg.norm_eps)
    h = F.gelu(x @ layer["w1"].to(dt) + layer["b1"].to(dt),
               approximate="tanh")
    h = h @ layer["w2"].to(dt) + layer["b2"].to(dt)
    return layer_norm(x + h, layer["norm2"]["w"], layer["norm2"]["b"],
                      cfg.norm_eps)


def apply(params: Params, tokens: torch.Tensor, cfg: BertConfig, *,
          attention_mask: torch.Tensor | None = None,
          token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, S] -> pooled classification logits [B, n_classes] f32.
    attention_mask [B, S] of 1/0 is taken as segment ids (0 = padding)."""
    tokens = tokens.long()
    b, s = tokens.shape
    dt = cfg.dtype
    x = params["embed"][tokens].to(dt)
    x = x + params["pos_embed"][None, :s].to(dt)
    tt = (token_type_ids.long() if token_type_ids is not None
          else torch.zeros_like(tokens))
    x = x + params["type_embed"][tt].to(dt)
    x = layer_norm(x, params["embed_norm"]["w"], params["embed_norm"]["b"],
                   cfg.norm_eps)
    seg = (attention_mask if attention_mask is not None
           else torch.ones((b, s), dtype=torch.int32, device=x.device))

    def body(x, layer):
        return _layer_body(cfg, x, layer, seg)

    for layer in unstack_layers(params["layers"]):
        x = (checkpoint(body, x, layer, use_reentrant=False) if cfg.remat
             else body(x, layer))
    cls = x[:, 0]   # the [CLS] token
    pooled = torch.tanh(cls @ params["pooler"]["w"].to(dt)
                        + params["pooler"]["b"].to(dt))
    logits = pooled @ params["classifier"]["w"].to(dt) \
        + params["classifier"]["b"].to(dt)
    return logits.float()


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: BertConfig):
    logits = apply(params, batch["tokens"], cfg,
                   attention_mask=batch.get("attention_mask"))
    return classification_loss(logits, batch["label"])
