"""Mixtral-style MoE transformer (counterpart of
kubeflow_tpu/models/moe_llama.py): the Llama attention block (flash
attention, B1 forward and B2/B3 backward on the card) and top-k-routed
SwiGLU experts (ops/moe.py), the router's aux loss carried through the
layers.

The tree is the JAX one: the Llama leaves less the dense MLP, plus
router [L, D, E] and stacked experts w_gate/w_up [L, E, D, F], w_down
[L, E, F, D]. `logical_axes` is the JAX one. On a mesh (the trainer's
`active_mesh`) the attention, embedding, lm_head and cross-entropy take
llama's tensor split and its sequence split (a rank's columns, ring or
Ulysses attention), the experts the `expert` and `tensor` splits of
ops/moe.py, and the routing is the global batch's (every rank's tokens
in the global [B, S] order); the loss is then the global batch's too (a masked-token mean over every shard's tokens plus
the global aux), which the registry's `needs_global_batch` tells the
trainer not to scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.common import (init_tree, meta_tree,
                                              unstack_layers)
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops.moe import MoEArgs, moe_mlp
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.parallel import sharding

Params = dict[str, Any]

ATTN_LEAVES = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class MoELlamaConfig(llama.LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3

    @property
    def moe_args(self) -> MoEArgs:
        return MoEArgs(self.n_experts, self.top_k, self.capacity_factor,
                       self.aux_loss_coef, self.router_z_coef)

    @staticmethod
    def mixtral_8x7b() -> "MoELlamaConfig":
        return MoELlamaConfig(vocab_size=32000, d_model=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, d_ff=14336,
                              max_seq_len=32768, rope_theta=1e6,
                              n_experts=8, top_k=2)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MoELlamaConfig":
        return MoELlamaConfig(vocab_size=vocab_size, d_model=64, n_layers=2,
                              n_heads=8, n_kv_heads=4, d_ff=96,
                              max_seq_len=128, rope_theta=10000.0,
                              n_experts=4, top_k=2)


def _spec(cfg: MoELlamaConfig) -> Params:
    """(shape, fill) of each leaf: matmul weights and the embedding
    normal / sqrt(fan_in) (the embedding's fan-in is d_model), unit
    norms."""
    d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    layers = {n: ((L, *s), s[0] ** -0.5)
              for n, s in llama.matmul_shapes(cfg).items()
              if n in ATTN_LEAVES}
    layers.update(router=((L, d, E), d ** -0.5),
                  w_gate=((L, E, d, f), d ** -0.5),
                  w_up=((L, E, d, f), d ** -0.5),
                  w_down=((L, E, f, d), f ** -0.5),
                  attn_norm=((L, d), "ones"), mlp_norm=((L, d), "ones"))
    return {"embed": ((cfg.vocab_size, d), d ** -0.5), "layers": layers,
            "final_norm": ((d,), "ones"),
            "lm_head": ((d, cfg.vocab_size), d ** -0.5)}


def init(cfg: MoELlamaConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """Random params from `seed` in cfg.param_dtype (`_spec`)."""
    return init_tree(_spec(cfg), seed=seed, device=device, keep=keep,
                     dtype=cfg.param_dtype)


def logical_axes(cfg: MoELlamaConfig) -> Params:
    axes = llama.logical_axes(cfg)
    axes["layers"]["router"] = ("layers", "embed", None)
    axes["layers"]["w_gate"] = ("layers", "expert", "embed", "mlp")
    axes["layers"]["w_up"] = ("layers", "expert", "embed", "mlp")
    axes["layers"]["w_down"] = ("layers", "expert", "mlp", "embed")
    return axes


def abstract_params(cfg: MoELlamaConfig) -> Params:
    return meta_tree(_spec(cfg), cfg.param_dtype)


def _layer_body(cfg: MoELlamaConfig, x, aux, layer, rope, segment_ids,
                regions=None, tp=None):
    x = llama._attention(cfg, x, layer, rope, segment_ids, tp)
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    out, layer_aux = moe_mlp(h, layer["router"], layer["w_gate"],
                             layer["w_up"], layer["w_down"], cfg.moe_args,
                             dtype=cfg.dtype, regions=regions)
    return x + out, aux + layer_aux


def apply(params: Params, tokens: torch.Tensor, cfg: MoELlamaConfig, *,
          positions: torch.Tensor | None = None,
          segment_ids: torch.Tensor | None = None,
          return_aux: bool = False):
    """[B, S] tokens -> [B, S, vocab] f32 logits (and the summed router
    aux loss with return_aux), each layer under cfg's remat policy. On a
    mesh (module doc) the logits are this rank's vocabulary columns."""
    if positions is None:
        positions = llama.global_positions(tokens)
    regions = sharding.regions()
    tp = llama.tensor_split(cfg)
    rope = llama._rope(cfg, positions)
    x = llama._embed(params, tokens.long(), cfg, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = llama._remat(cfg, lambda x, aux, layer: _layer_body(
        cfg, x, aux, layer, rope, segment_ids, regions, tp))
    for layer in unstack_layers(params["layers"]):
        x, aux = body(x, aux, layer)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        x = tp.copy_in(x, "tensor")
    logits = quant.matmul_f32_out(x, params["lm_head"], cfg.dtype)
    return (logits, aux) if return_aux else logits


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: MoELlamaConfig):
    """Next-token cross-entropy plus the router aux loss: (ce + aux,
    {"loss": ce, "aux_loss", "tokens"}). On a mesh both are the global
    batch's (ce the masked-token mean over every shard's tokens; its
    gradient this shard's part) and `tokens` is this shard's count."""
    tokens = batch["tokens"].long()
    logits, aux = apply(params, tokens, cfg,
                        segment_ids=batch.get("segment_ids"),
                        return_aux=True)
    logits, targets, mask = llama.next_token_terms(logits, batch, tokens)
    token_loss = llama._token_loss(logits, targets, llama.tensor_split(cfg))
    n = mask.sum()
    regions = sharding.regions()
    total = regions.sum_batch(n.detach())
    ce = regions.sum_batch((token_loss * mask).sum() / total.clamp_min(1.0))
    return ce + aux, {"loss": ce, "aux_loss": aux, "tokens": n}


def flops_per_token(cfg: MoELlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token counting only the active experts (top_k
    of E), as the JAX function does."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nh, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    attn_params = L * (d * nh * hd + 2 * d * nkv * hd + nh * hd * d)
    moe_params = L * (cfg.top_k * 3 * d * f + d * cfg.n_experts)
    embed_params = cfg.vocab_size * d
    attn_flops = 12 * L * nh * hd * seq_len
    return 6.0 * (attn_params + moe_params + embed_params) + attn_flops
