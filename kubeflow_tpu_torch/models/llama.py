"""Llama-family decoder (counterpart of kubeflow_tpu/models/llama.py):
config, init and quantize_params; the training forward (apply_hidden,
apply, loss_fn with its chunked cross-entropy, flops_per_token); and the
serving path (the KV cache, prefill, prefill_continue, decode_step and
verify_step).

Layout follows the JAX package so parameters convert one to one
(models/interop.py): weights are [in, out] applied as x @ W, every
per-layer tensor is stacked on a leading [L, ...] axis, and a quantized
leaf is {"q": int8 [..., in, out], "s": f32 [..., out]}. The lax.scan over
layers is a Python loop. Attention goes through the kernel wrappers of
ops/flash_attention.py (training), ops/flash_prefill.py and
ops/flash_decode.py (serving), which launch the CUDA kernels for CUDA
tensors and run their plain versions for CPU tensors.

The KV cache is updated IN PLACE by verify_step/decode_step (the JAX
functions return a new cache): at 8B width the cache is about a gigabyte,
and rewriting it per step would double the step's memory traffic.

On a mesh with a `tensor` axis past one rank (the trainer's
`active_mesh`, read through `sharding.regions`) the training forward
runs Megatron splits on the rank's blocks: wq/wk/wv and w_gate/w_up
column-parallel (a rank's nh/T query and nkv/T kv heads, counted from
its block's width), wo and w_down row-parallel with an all-reduce of
their f32 partial sums, the embedding vocab-parallel (a masked lookup
of the rank's vocabulary rows, all-reduced), the lm_head
column-parallel and the cross-entropy vocab-parallel
(`sharding.vocab_parallel_ce`: the [B, S, vocab] logits are never
gathered). B1-B3 run unchanged on the local heads. Rank r's query heads
use kv heads [r·nkv/T, (r+1)·nkv/T), the GQA grouping only when nkv
divides by T; otherwise the forward raises (ROADMAP.md queue A6a-iii).
The serving functions take whole params and no split.

On a mesh with a `sequence` axis past one rank each rank holds its
columns of the batch (the trainer's `to_device`): RoPE takes each
column's global position, the attention runs across the ranks (`attend`:
ring attention for attention_impl "ring" and "flash", Ulysses for
"ulysses"; on the rank's tensor heads when a tensor split is on too),
and the loss reads its next-token targets and their weights by global
position from the batch (`targets`, `target_mask`), so a shard's last
column takes the next shard's first token and only the global last has
no target.

On a mesh with a `stage` axis past one rank `loss_fn` runs the GPipe
schedule (`parallel/pipeline.py` `pipelined_llama_loss`): each stage
applies its slab of the stacked layers (`_layer_body` under `_remat`)
to microbatches of the rank's rows, the first stage embeds and the last
runs the loss tail; the splits above hold inside each stage.

Multi-adapter serving: every serving function takes the JAX `lora`/`ids`
pair. lora = {target: {"a": [L, A, d_in, r], "b": [L, A, r, d_out]}}
(f32, adapter 0 all zeros, b pre-scaled by alpha / rank) and ids [B] the
adapter of each row; each target's matmul then adds the row's low-rank
bypass (`_adapted`): two batched f32 products beside the kernel's x @ W.
Without `lora` the functions run exactly the base path.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import safetensors
from kubeflow_tpu_torch.models.common import set_dtypes, unstack_layers
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.flash_decode import flash_decode_attention
from kubeflow_tpu_torch.ops.flash_prefill import flash_prefill_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.ring_attention import ring_attention
from kubeflow_tpu_torch.ops.rope import apply_rope_tables, rope_tables
from kubeflow_tpu_torch.ops.ulysses import ulysses_attention
from kubeflow_tpu_torch.parallel import sharding

Params = dict[str, Any]

QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: the matmul leaves a tensor split makes row-parallel (split over their
#: input rows, the partial sums all-reduced); the others are
#: column-parallel
ROW_PARALLEL = ("wo", "w_down")
REMAT_POLICIES = ("none", "minimal", "full")
#: the training attention bodies (`attend`)
ATTENTION_IMPLS = ("flash", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # activation checkpointing of each layer in the training forward:
    # "none" saves everything, "minimal" saves only the weight-matmul
    # outputs (JAX's checkpoint_dots_with_no_batch_dims), "full" saves
    # only the layer's input
    remat: bool = True
    remat_policy: str = "minimal"
    # >0: the loss projects and normalizes ce_chunk tokens at a time under
    # checkpoint, so the [B, S, vocab] f32 logits never exist whole
    ce_chunk: int = 0
    # The JAX config's implementation keys, so a job's model_overrides
    # carry over. Attention always runs the kernel wrappers (the plain
    # version only for CPU tensors): attention_impl picks the body on a
    # `sequence` axis past one rank (`attend`) and nothing else; the
    # layer loop is JAX's unrolled one, whose results equal the scan's,
    # so any scan_layers describes it.
    attention_impl: str = "flash"
    scan_layers: bool = True
    # the GPipe schedule's microbatches on a `stage` axis past one rank
    # (0: one per stage); nothing off one
    pipeline_microbatches: int = 0
    decode_attention_impl: str = "auto"
    prefill_attention_impl: str = "auto"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        for name in ("attention_impl", "decode_attention_impl",
                     "prefill_attention_impl"):
            value = getattr(self, name)
            allowed = (ATTENTION_IMPLS if name == "attention_impl"
                       else ("auto", "flash"))
            if value in allowed:
                continue
            if value == "xla":
                raise ValueError(
                    f"{name}='xla': the port has no plain-version path on "
                    "the card; CUDA tensors always take the kernels "
                    "(ROADMAP.md north star, rule 4)")
            raise ValueError(f"unknown {name} {value!r}")
        set_dtypes(self, "dtype", "param_dtype")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336,
                           rope_theta=500000.0)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """Test-size config: real structure, toy dims."""
        return LlamaConfig(vocab_size=vocab_size, d_model=64, n_layers=2,
                           n_heads=8, n_kv_heads=4, d_ff=128,
                           max_seq_len=128, rope_theta=10000.0)


def matmul_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """Each layer's matmul weight as [in, out] (its fan-in is `in`)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": (d, nh * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
            "wo": (nh * hd, d), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}


def init(cfg: LlamaConfig, *, seed: int = 0, device="cuda",
         quantize: str | None = None, keep=None) -> Params:
    """Random params (normal / sqrt(fan_in), unit norms) from `seed`,
    built layer by layer on the device. With quantize="int8" each layer's
    matmul weights are quantized as they are made, so the f32 model never
    exists whole (at 8B it would be 32 GB). Non-quantized leaves are kept
    in cfg.param_dtype. `keep(path, tensor, layer=None)`, when given,
    takes each leaf (a stacked leaf one layer at a time) as it is made
    and returns what the tree holds: a sharded trainer keeps its block,
    and None for a layer outside its `stage` slab."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if keep is not None and quantize:
        raise ValueError("keep= builds training params: no quantize")
    if keep is None:
        def keep(path, t, layer=None):
            return t
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, L, pd = cfg.d_model, cfg.n_layers, cfg.param_dtype

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5

    def leaf(shape, fan_in):
        w = dense(shape, fan_in)
        return quant.quantize_int8(w) if quantize else w.to(pd)

    shapes = {name: (shape, shape[0])
              for name, shape in matmul_shapes(cfg).items()}
    layers: Params = {}
    if quantize:
        for name, (shape, _) in shapes.items():
            layers[name] = {
                "q": torch.empty((L, *shape), dtype=torch.int8, device=dev),
                "s": torch.empty((L, shape[1]), dtype=torch.float32,
                                 device=dev)}
    else:   # the layers the tree holds (None: of another stage's slab)
        for name, (shape, _) in shapes.items():
            probe = torch.empty(shape, dtype=pd, device="meta")
            held = [b for b in (keep(f"layers/{name}", probe, i)
                                for i in range(L)) if b is not None]
            layers[name] = torch.empty((len(held), *held[0].shape),
                                       dtype=pd, device=dev)
    filled = dict.fromkeys(shapes, 0)
    for i in range(L):
        for name, (shape, fan_in) in shapes.items():
            w = leaf(shape, fan_in)
            if quantize:
                layers[name]["q"][i] = w["q"]
                layers[name]["s"][i] = w["s"]
                continue
            w = keep(f"layers/{name}", w, i)
            if w is not None:
                layers[name][filled[name]] = w
                filled[name] += 1
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = keep(f"layers/{name}",
                            torch.ones((L, d), dtype=pd, device=dev))
    embed = keep("embed", dense((cfg.vocab_size, d), d).to(pd))
    return {"embed": embed,
            "layers": layers,
            "final_norm": keep("final_norm",
                               torch.ones((d,), dtype=pd, device=dev)),
            "lm_head": (leaf((d, cfg.vocab_size), d) if quantize else
                        keep("lm_head", leaf((d, cfg.vocab_size), d)))}


def logical_axes(cfg: LlamaConfig) -> Params:
    """The logical sharding axes of init's tree, leaf for leaf
    (parallel/sharding.py)."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "wq": ("layers", "embed", "qkv"),
            "wk": ("layers", "embed", "qkv"),
            "wv": ("layers", "embed", "qkv"),
            "wo": ("layers", "qkv", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "attn_norm": ("layers", "embed_no_fsdp"),
            "mlp_norm": ("layers", "embed_no_fsdp"),
        },
        "final_norm": ("embed_no_fsdp",),
        "lm_head": ("embed", "vocab"),
    }


def abstract_params(cfg: LlamaConfig) -> Params:
    """init's tree (without quantize) as meta tensors: every leaf's shape
    and dtype, no memory and no random numbers. A checkpoint restores
    into tensors allocated from it."""
    meta, pd = torch.device("meta"), cfg.param_dtype
    d, L = cfg.d_model, cfg.n_layers

    def t(*shape):
        return torch.empty(shape, dtype=pd, device=meta)

    layers: Params = {name: t(L, *shape)
                      for name, shape in matmul_shapes(cfg).items()}
    layers["attn_norm"] = t(L, d)
    layers["mlp_norm"] = t(L, d)
    return {"embed": t(cfg.vocab_size, d), "layers": layers,
            "final_norm": t(d), "lm_head": t(d, cfg.vocab_size)}


def quantize_params(params: Params) -> Params:
    """Weight-only int8 for serving: every matmul weight becomes
    {"q", "s"}; embed and the norms stay as they are. A stage's slab
    (parallel/pipeline.py) may hold no lm_head."""
    out = dict(params)
    out["layers"] = {k: (quant.quantize_int8(v) if k in QUANT_LEAVES
                         and not quant.is_quantized(v) else v)
                     for k, v in params["layers"].items()}
    if "lm_head" in params and not quant.is_quantized(params["lm_head"]):
        out["lm_head"] = quant.quantize_int8(params["lm_head"])
    return out


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def _attention(cfg: LlamaConfig, x: torch.Tensor, layer: Params, rope,
               segment_ids, tp=None) -> torch.Tensor:
    """Pre-norm causal GQA self-attention block with its residual; the
    attention itself is `attend` (B1 forward, B2/B3 backward).
    With `tp` (the Regions of a tensor split) the layer's blocks are this
    rank's and the block's partial sum is all-reduced over `tensor`."""
    if tp is not None:
        h = tp.copy_in(rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                       "tensor")
        part = attention_partial(cfg, h, layer, rope, segment_ids)
        return x + tp.reduce_out(part, "tensor").to(x.dtype)
    q, k, v = _project_qkv(cfg, layer, x, rope)
    b, s = x.shape[:2]
    out = attend(cfg, q, k, v, segment_ids)
    return x + quant.matmul(out.reshape(b, s, -1), layer["wo"], cfg.dtype)


def attend(cfg: LlamaConfig, q, k, v, segment_ids) -> torch.Tensor:
    """Causal GQA attention of one layer's q [B, S, H, D] and k/v
    [B, S, Hkv, D] (a tensor rank's heads under a tensor split): flash
    attention (B1-B3) off a `sequence` split; on one (the active mesh's
    `sequence` axis past one rank, S this rank's columns), Ulysses for
    attention_impl "ulysses" and ring attention for "ring" and "flash"
    (the counterpart of the JAX `_attention`'s dispatch)."""
    group = sharding.regions().groups.get("sequence")
    if group is None:
        return flash_attention(q, k, v, causal=True,
                               segment_ids=segment_ids)
    if cfg.attention_impl == "ulysses":
        return ulysses_attention(q, k, v, group=group, causal=True,
                                 segment_ids=segment_ids)
    return ring_attention(q, k, v, group=group, causal=True,
                          segment_ids=segment_ids)


def attention_partial(cfg: LlamaConfig, h: torch.Tensor, layer: Params,
                      rope, segment_ids) -> torch.Tensor:
    """One tensor rank's share of the attention block: the normed input h
    [B, S, D] through its column blocks of wq/wk/wv (the heads counted
    from the blocks' widths), `attend` on those heads and its row
    block of wo -> its f32 partial sum [B, S, D] of the block's output
    (the ranks' partials sum to the unsplit block's)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = quant.matmul(h, layer["wq"], cfg.dtype).reshape(b, s, -1, hd)
    k = quant.matmul(h, layer["wk"], cfg.dtype).reshape(b, s, -1, hd)
    v = quant.matmul(h, layer["wv"], cfg.dtype).reshape(b, s, -1, hd)
    q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
    out = attend(cfg, q, k, v, segment_ids)
    return quant.matmul_f32_out(out.reshape(b, s, -1), layer["wo"],
                                cfg.dtype)


def mlp_partial(cfg: LlamaConfig, h: torch.Tensor,
                layer: Params) -> torch.Tensor:
    """One tensor rank's share of the SwiGLU MLP: the normed input h
    through its column blocks of w_gate/w_up and its row block of w_down
    -> its f32 partial sum of the MLP's output."""
    gate = quant.matmul(h, layer["w_gate"], cfg.dtype)
    up = quant.matmul(h, layer["w_up"], cfg.dtype)
    return quant.matmul_f32_out(F.silu(gate) * up, layer["w_down"],
                                cfg.dtype)


def _layer_body(cfg: LlamaConfig, x: torch.Tensor, layer: Params, rope,
                segment_ids, tp=None) -> torch.Tensor:
    x = _attention(cfg, x, layer, rope, segment_ids, tp)
    if tp is not None:
        h = tp.copy_in(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                       "tensor")
        return x + tp.reduce_out(mlp_partial(cfg, h, layer),
                                 "tensor").to(x.dtype)
    return _mlp(cfg, x, layer)


def tensor_split(cfg: LlamaConfig):
    """The Regions of the active mesh when its `tensor` axis splits the
    layer (more than one rank), else None. Raises where the split would
    not keep whole query groups: the kv heads must divide by the tensor
    size (ROADMAP.md queue A6a-iii), as must the query heads."""
    tp = sharding.regions()
    if tp.size("tensor") == 1:
        return None
    t = tp.size("tensor")
    if cfg.n_heads % t:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by the "
                         f"tensor axis {t}")
    if cfg.n_kv_heads % t:
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} not divisible by the tensor axis "
            f"{t}: a rank's query heads would need kv heads of another "
            "rank (ROADMAP.md queue A6a-iii, kv heads replicated past "
            "the tensor size)")
    return tp


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "minimal" policy: keep the outputs of the 2-D weight products
    (x @ W folds to mm), recompute everything else in the backward."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: LlamaConfig, body):
    """`body` under the config's activation checkpointing."""
    if not cfg.remat or cfg.remat_policy == "none":
        return body
    if cfg.remat_policy == "full":
        return lambda *a: checkpoint(body, *a, use_reentrant=False)
    return lambda *a: checkpoint(
        body, *a, use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(
            _save_matmuls))


def apply_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                 positions: torch.Tensor | None = None,
                 segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S] tokens -> [B, S, d_model] after the final norm (no lm_head),
    each layer under cfg's remat policy."""
    if positions is None:
        positions = global_positions(tokens)
    tp = tensor_split(cfg)
    rope = _rope(cfg, positions)
    x = _embed(params, tokens, cfg, tp)
    body = _remat(cfg, lambda x, layer: _layer_body(cfg, x, layer, rope,
                                                    segment_ids, tp))
    for layer in unstack_layers(params["layers"]):
        x = body(x, layer)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # the lm_head's input enters the rank's vocabulary columns
    return x if tp is None else tp.copy_in(x, "tensor")


def global_positions(tokens: torch.Tensor) -> torch.Tensor:
    """The global position of each of tokens' S columns: rank * S +
    arange(S) on the active mesh's `sequence` rank, arange(S) off one."""
    s = tokens.shape[1]
    return (sharding.regions().rank("sequence") * s
            + torch.arange(s, device=tokens.device))


def apply(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
          positions: torch.Tensor | None = None,
          segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S] tokens -> [B, S, vocab] f32 logits (under a tensor split,
    this rank's vocabulary columns of them)."""
    x = apply_hidden(params, tokens, cfg, positions=positions,
                     segment_ids=segment_ids)
    return quant.matmul_f32_out(x, params["lm_head"], cfg.dtype)


def _token_loss(logits: torch.Tensor, targets: torch.Tensor,
                tp=None) -> torch.Tensor:
    """-log softmax(logits)[target] per position; under a tensor split
    `logits` are the rank's vocabulary columns and the loss is the
    vocab-parallel cross-entropy."""
    if tp is not None:
        v = logits.shape[-1]
        return sharding.vocab_parallel_ce(logits, targets,
                                          tp.rank("tensor") * v,
                                          tp.groups["tensor"])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: LlamaConfig):
    """Next-token cross-entropy: batch has tokens [B, S] and optionally
    loss_mask [B, S] (1 where the target counts) and segment_ids [B, S];
    on a sequence shard also the targets by global position (module
    doc). The forward runs on the full sequence and the logits shift
    after. Returns (loss, {"loss", "tokens"}). On the active mesh's
    `stage` axis past one rank the forward and loss run as the GPipe
    schedule instead (`parallel/pipeline.py` `pipelined_llama_loss`: the
    same loss; ce_chunk is not read there, as in JAX)."""
    if sharding.regions().size("stage") > 1:
        from kubeflow_tpu_torch.parallel.mesh import get_active_mesh
        from kubeflow_tpu_torch.parallel.pipeline import pipelined_llama_loss

        return pipelined_llama_loss(params, batch, cfg, get_active_mesh(),
                                    cfg.pipeline_microbatches or None)
    if cfg.ce_chunk:
        return _chunked_ce_loss(params, batch, cfg)
    tokens = batch["tokens"].long()
    logits = apply(params, tokens, cfg, segment_ids=batch.get("segment_ids"))
    logits, targets, mask = next_token_terms(logits, batch, tokens)
    token_loss = _token_loss(logits, targets, tensor_split(cfg))
    total = (token_loss * mask).sum()
    n = mask.sum()
    loss = total / n.clamp_min(1.0)
    return loss, {"loss": loss, "tokens": n}


def next_token_terms(logits: torch.Tensor, batch: dict, tokens):
    """(logits, targets, weights) of the next-token loss: with the
    batch's `targets` and `target_mask` (a sequence shard's, by global
    position) every position as given; otherwise the logits of every
    position but the last against the next tokens, weighted by the
    loss_mask at the target (or 1)."""
    if "targets" in batch:
        return logits, batch["targets"].long(), batch["target_mask"].float()
    mask = batch.get("loss_mask")
    return (logits[:, :-1], tokens[:, 1:],
            torch.ones(tokens[:, 1:].shape, device=tokens.device)
            if mask is None else mask[:, 1:].float())


def shifted_targets(batch: dict, tokens: torch.Tensor):
    """(targets, weights) [B, S] of every position: the next token,
    weighted by the loss_mask at it, and 0 at the last position, which
    has none; a sequence shard's as the batch gives them."""
    if "targets" in batch:
        return batch["targets"].long(), batch["target_mask"].float()
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones(b, s, device=tokens.device)
    valid[:, -1] = 0.0
    mask = batch.get("loss_mask")
    if mask is not None:   # by target position, as the plain path
        valid = valid * torch.cat(
            [mask[:, 1:].float(), torch.zeros(b, 1, device=tokens.device)],
            dim=1)
    return targets, valid


def _chunk_loss(h, targets, valid, lm_head, dtype, tp=None):
    logits = quant.matmul_f32_out(h, lm_head, dtype)
    return (_token_loss(logits, targets, tp) * valid).sum()


def _chunked_ce_loss(params: Params, batch: dict[str, torch.Tensor],
                     cfg: LlamaConfig):
    """The loss with the lm_head and log-softmax run per ce_chunk tokens
    under checkpoint, so one [B, C, vocab] block of logits is live at a
    time, forward and backward. The same loss as the plain path; S (a
    sequence shard's columns) must divide by ce_chunk."""
    tokens = batch["tokens"].long()
    s = tokens.shape[1]
    c = cfg.ce_chunk
    if s % c:
        raise ValueError(f"seq_len {s} must divide by ce_chunk {c}")
    h = apply_hidden(params, tokens, cfg,
                     segment_ids=batch.get("segment_ids"))
    targets, valid = shifted_targets(batch, tokens)
    tp = tensor_split(cfg)
    total = torch.zeros((), device=tokens.device)
    for i in range(0, s, c):
        total = total + checkpoint(
            _chunk_loss, h[:, i:i + c], targets[:, i:i + c],
            valid[:, i:i + c], params["lm_head"], cfg.dtype, tp,
            use_reentrant=False)
    n = valid.sum()
    loss = total / n.clamp_min(1.0)
    return loss, {"loss": loss, "tokens": n}


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token, 6 * matmul params + 12 * L * H * hd * S
    (the PaLM-appendix convention the JAX package uses: the causal
    attention term is not halved)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nh, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    matmul_params = L * (d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                         + 3 * d * f)
    embed_params = cfg.vocab_size * d
    return 6.0 * (matmul_params + embed_params) + 12 * L * nh * hd * seq_len


# ---------------------------------------------------------------------------
# KV cache: slab [L, slots, max_len, kv, hd], int8 with per-token scales
# [L, slots, max_len, kv], or cfg.dtype.
# ---------------------------------------------------------------------------


def init_cache(cfg: LlamaConfig, n_slots: int, max_len: int,
               kv_quantize: str | None = None, device="cuda") -> Params:
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:-1], device=dev),
                "v_s": torch.zeros(shape[:-1], device=dev)}
    if kv_quantize is not None:
        raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric int8 over head_dim: [..., hd] ->
    (int8 [..., hd], f32 scale [...]). Divides in f32 and rounds half to
    even, so the bytes equal the JAX package's."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * s[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Serving forward
# ---------------------------------------------------------------------------


def _rope(cfg: LlamaConfig, positions: torch.Tensor):
    """The (cos, sin) tables of one forward, shared by every layer."""
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _adapted(h: torch.Tensor, layer: Params, t: str, lora_layer, ids,
             dtype: torch.dtype) -> torch.Tensor:
    """One weight matmul with the optional per-row LoRA bypass (the JAX
    `_adapted`): h [B, S, d_in] @ W, plus, when `lora_layer` (this layer's
    {target: {"a": [A, d_in, r], "b": [A, r, d_out]}}) holds the target,
    (h @ a[ids]) @ b[ids] in f32, added in the output dtype."""
    y = quant.matmul(h, layer[t], dtype)
    if lora_layer is None or t not in lora_layer:
        return y
    a = lora_layer[t]["a"][ids]                       # [B, d_in, r]
    b = lora_layer[t]["b"][ids]                       # [B, r, d_out]
    z = torch.bmm(h.float(), a)
    return y + torch.bmm(z, b).to(y.dtype)


def _lora_layers(lora: Params | None, n_layers: int) -> list:
    """The adapter stack as one {target: {"a", "b"}} of views per layer
    (None each without adapters)."""
    if lora is None:
        return [None] * n_layers
    parts = {t: (ab["a"].unbind(0), ab["b"].unbind(0))
             for t, ab in lora.items()}
    return [{t: {"a": a[i], "b": b[i]} for t, (a, b) in parts.items()}
            for i in range(n_layers)]


def _project_qkv(cfg: LlamaConfig, layer: Params, x: torch.Tensor, rope,
                 lora_layer=None, ids=None):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _adapted(h, layer, "wq", lora_layer, ids, cfg.dtype).reshape(
        b, s, nh, hd)
    k = _adapted(h, layer, "wk", lora_layer, ids, cfg.dtype).reshape(
        b, s, nkv, hd)
    v = _adapted(h, layer, "wv", lora_layer, ids, cfg.dtype).reshape(
        b, s, nkv, hd)
    return apply_rope_tables(q, *rope), apply_rope_tables(k, *rope), v


def _mlp(cfg: LlamaConfig, x: torch.Tensor, layer: Params,
         lora_layer=None, ids=None) -> torch.Tensor:
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = _adapted(h, layer, "w_gate", lora_layer, ids, cfg.dtype)
    up = _adapted(h, layer, "w_up", lora_layer, ids, cfg.dtype)
    return x + _adapted(F.silu(gate) * up, layer, "w_down", lora_layer, ids,
                        cfg.dtype)


def _wo(cfg: LlamaConfig, out: torch.Tensor, layer: Params,
        lora_layer=None, ids=None) -> torch.Tensor:
    return _adapted(out, layer, "wo", lora_layer, ids, cfg.dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
           tp=None) -> torch.Tensor:
    """The token embeddings in cfg.dtype; under a tensor split the table
    is this rank's vocabulary rows: a masked lookup, summed over
    `tensor` in the table's dtype (one rank holds each row: exact)."""
    table = params["embed"]
    if tp is None:
        return table[tokens].to(cfg.dtype)
    part = embed_partial(table, tokens, tp.rank("tensor") * table.shape[0])
    return tp.reduce_out(part, "tensor").to(cfg.dtype)


def embed_partial(table: torch.Tensor, tokens: torch.Tensor,
                  start: int) -> torch.Tensor:
    """One tensor rank's share of the embedding: the rows of its block
    `table` of vocabulary rows [start, start + V_r) for the tokens inside
    it, zeros for the others (the ranks' shares sum to the lookup in the
    whole table)."""
    v = table.shape[0]
    local = tokens - start
    inside = (local >= 0) & (local < v)
    return table[local.clamp(0, v - 1)] * inside[..., None].to(table.dtype)


def prefill_attention(cfg: LlamaConfig, q, k, v, cks=None, cvs=None, *,
                      q_offset: int = 0,
                      tables: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA chunk attention: q [B, S, nh, hd] at absolute rows
    q_offset + i against k/v [B, T, kv, hd] (cfg.dtype, or int8 with
    cks/cvs [B, T, kv] f32 scales). Returns [B, S, nh, hd]. With `tables`
    [B, T // bt] int32, k/v are a pool layer [N, bt, kv, hd] (cks/cvs
    [N, bt, kv]) and slot b's T keys are its table's blocks (K3's paged
    mode; its plain version gathers them into the slab view)."""
    return flash_prefill_attention(q, k, v, q_offset=q_offset,
                                   k_scale=cks, v_scale=cvs,
                                   scale=1.0 / (cfg.head_dim ** 0.5),
                                   tables=tables)


def decode_attention(cfg: LlamaConfig, q, ck, cv, cks, cvs,
                     lengths: torch.Tensor,
                     tables: torch.Tensor | None = None,
                     split_slots: int | None = None) -> torch.Tensor:
    """GQA decode/verify attention over a span-sliced slab: q [B, S_v, nh,
    hd]; row i of slot b sees keys t <= lengths[b] + i. Returns
    [B, S_v, nh * hd]. With `tables` [B, span // bt] int32, ck/cv are a
    pool layer [N, bt, kv, hd] (cks/cvs [N, bt, kv]) and slot b's span is
    its table's blocks. `split_slots`: the slab's slot count when the B
    slots are a window of it (K2 then gives each row the bits of a launch
    over the whole slab)."""
    b, s_v = q.shape[:2]
    out = flash_decode_attention(q, ck, cv, lengths, k_scale=cks,
                                 v_scale=cvs,
                                 scale=1.0 / (cfg.head_dim ** 0.5),
                                 tables=tables, split_slots=split_slots)
    return out.reshape(b, s_v, -1)


def prefill_inner(layers: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: LlamaConfig, lora: Params | None = None,
                  ids: torch.Tensor | None = None):
    """[B, S, D] activations through the layer stack -> (x, k, v
    [L, B, S, kv, hd]); with `lora`, row b through adapter ids[b]."""
    b, s = x.shape[:2]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    per_layer = unstack_layers(layers)
    for layer, ll in zip(per_layer, _lora_layers(lora, len(per_layer))):
        q, k, v = _project_qkv(cfg, layer, x, rope, ll, ids)
        out = prefill_attention(cfg, q, k, v, q_offset=0)
        x = x + _wo(cfg, out.reshape(b, s, -1), layer, ll, ids)
        x = _mlp(cfg, x, layer, ll, ids)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def lm_head(params: Params, x: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """final_norm + lm_head projection, f32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return quant.matmul_f32_out(x, params["lm_head"], cfg.dtype)


def prefill_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   lora: Params | None = None,
                   ids: torch.Tensor | None = None):
    """prefill without the lm_head: (x [B, S, D] before the final norm,
    k, v [L, B, S, kv, hd]). The engine projects only each prompt's last
    row, which is what it samples from."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return prefill_inner(params["layers"], _embed(params, tokens, cfg),
                         positions, cfg, lora, ids)


def prefill(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            lora: Params | None = None, ids: torch.Tensor | None = None):
    """Right-padded prompts [B, S] -> (logits [B, S, vocab] f32, k, v
    [L, B, S, kv, hd]). Pad positions produce KV the caller masks out.
    `lora`/`ids`: the multi-adapter batch (module docstring)."""
    x, (ks, vs) = prefill_hidden(params, tokens, cfg, lora, ids)
    return lm_head(params, x, cfg), ks, vs


def prefill_continue(params: Params, tail_tokens: torch.Tensor,
                     k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                     cfg: LlamaConfig, lora: Params | None = None,
                     ids: torch.Tensor | None = None):
    """Forward only the tail [B, T] of prompts whose prefix KV
    [L, B, P, kv, hd] is known: the tail attends causally over
    prefix + tail (q_offset = P). Returns (logits [B, T, vocab] f32,
    k_tail, v_tail [L, B, T, kv, hd])."""
    x, ks, vs = prefill_continue_hidden(params, tail_tokens, k_prefix,
                                        v_prefix, cfg, lora, ids)
    return lm_head(params, x, cfg), ks, vs


def prefill_continue_hidden(params: Params, tail_tokens: torch.Tensor,
                            k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                            cfg: LlamaConfig, lora: Params | None = None,
                            ids: torch.Tensor | None = None):
    """prefill_continue without the lm_head: (x [B, T, D] before the
    final norm, k_tail, v_tail). The engine's chunked prefill projects
    only the last prompt row."""
    x = _embed(params, tail_tokens, cfg)
    positions = k_prefix.shape[2] + torch.arange(
        tail_tokens.shape[1], device=tail_tokens.device)
    return prefill_continue_inner(params["layers"], x, k_prefix, v_prefix,
                                  positions, cfg, lora, ids)


def prefill_continue_inner(layers: Params, x: torch.Tensor,
                           k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                           positions: torch.Tensor, cfg: LlamaConfig,
                           lora: Params | None = None,
                           ids: torch.Tensor | None = None):
    """[B, T, D] tail activations through the layer stack against the
    prefix KV -> (x, k_tail, v_tail [L, B, T, kv, hd])."""
    b, t = x.shape[:2]
    p = k_prefix.shape[2]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    per_layer = unstack_layers(layers)
    for i, (layer, ll) in enumerate(zip(per_layer, _lora_layers(
            lora, len(per_layer)))):
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope, ll, ids)
        k_full = torch.cat([k_prefix[i].to(cfg.dtype), k_new], dim=1)
        v_full = torch.cat([v_prefix[i].to(cfg.dtype), v_new], dim=1)
        out = prefill_attention(cfg, q, k_full, v_full, q_offset=p)
        x = x + _wo(cfg, out.reshape(b, t, -1), layer, ll, ids)
        x = _mlp(cfg, x, layer, ll, ids)
        ks.append(k_new)
        vs.append(v_new)
    return x, torch.stack(ks), torch.stack(vs)


def decode_step(params: Params, last_tokens: torch.Tensor, cache: Params,
                lengths: torch.Tensor, cfg: LlamaConfig,
                span: int | None = None, lora: Params | None = None,
                ids: torch.Tensor | None = None) -> torch.Tensor:
    """One decode step over every cache slot: last_tokens [B], lengths
    [B] int32 (where this step's KV is written). Returns logits [B, vocab]
    f32 and updates `cache` in place. `span` bounds attention to the
    cache's first `span` rows (caller guarantees lengths < span)."""
    return verify_step(params, last_tokens[:, None], cache, lengths, cfg,
                       span=span, lora=lora, ids=ids)[:, 0]


def verify_step(params: Params, tokens: torch.Tensor, cache: Params,
                lengths: torch.Tensor, cfg: LlamaConfig,
                span: int | None = None, lora: Params | None = None,
                ids: torch.Tensor | None = None) -> torch.Tensor:
    """Forward S_v tokens per slot in one pass: tokens [B, S_v] occupy
    positions lengths[b] .. lengths[b] + S_v - 1. Returns logits
    [B, S_v, vocab] f32; KV rows of all S_v positions are written into
    `cache` in place (rows at or past max_len are dropped)."""
    x = _embed(params, tokens, cfg)
    x = verify_inner(params["layers"], x, cache, lengths, cfg, span=span,
                     lora=lora, ids=ids)
    return lm_head(params, x, cfg)


def _write_coords(lengths: torch.Tensor, s_v: int, max_len: int):
    """Scatter coordinates for the S_v new rows of every slot, with the
    JAX mode="drop" semantics: a row at or past max_len must vanish.
    Such rows are redirected to distinct positions below lengths[b] (not
    written by this step) and given their own current values back, so
    one index_put_ without duplicate indices covers every slot and the
    host never has to look at `lengths`."""
    if max_len < 2 * s_v:
        raise ValueError(f"max_len {max_len} too small for S_v {s_v}")
    b = lengths.shape[0]
    ar = torch.arange(s_v, device=lengths.device)
    positions = lengths.long()[:, None] + ar[None]
    valid = positions < max_len
    alt = (lengths.long()[:, None] - s_v + ar[None]).clamp_min(0)
    rows = torch.arange(b, device=lengths.device)[:, None].expand(b, s_v)
    return positions, rows, torch.where(valid, positions, alt), valid


def _write_rows(buf: torch.Tensor, rows, wpos, valid, val) -> None:
    keep = valid.reshape(valid.shape + (1,) * (val.dim() - 2))
    buf[rows, wpos] = torch.where(keep, val, buf[rows, wpos])


def _paged_write_coords(tbl: torch.Tensor, lengths: torch.Tensor, s_v: int,
                        bt: int):
    """(positions [B, S_v], (block, offset) write coordinates) of the S_v
    new rows of every slot in paged mode: position p of slot r lands at
    block tbl[r, p // bt], offset p % bt. Positions at or past max_len,
    and table entries never allocated (0), land in block 0, the pool's
    trash block, which is never read."""
    max_len = tbl.shape[1] * bt
    positions = lengths.long()[:, None] + torch.arange(
        s_v, device=lengths.device)[None]
    pos_c = positions.clamp_max(max_len - 1)
    blk = torch.gather(tbl.long(), 1, pos_c // bt)
    blk = torch.where(positions < max_len, blk, torch.zeros_like(blk))
    return positions, (blk, positions % bt)


def verify_inner(layers: Params, x: torch.Tensor, cache: Params,
                 lengths: torch.Tensor, cfg: LlamaConfig,
                 span: int | None = None, lora: Params | None = None,
                 ids: torch.Tensor | None = None,
                 slot_start: int = 0) -> torch.Tensor:
    """x [B, S_v, D] through the layer stack against the cache (updated in
    place) -> x. The cache is a slab with one row per slot, or, with "tbl"
    [B, max_len // bt] in it, the paged block pool [L, N, bt, ...] that the
    tables index (B must then equal the table rows). A slab may hold more
    slots than x has rows: the rows are slots [slot_start, slot_start + B)
    (a stage of the stage-sharded engine decodes one microbatch of slots
    against its slab), and `lengths` is per row of x."""
    b, s_v = x.shape[:2]
    paged = "tbl" in cache
    if paged:
        tbl = cache["tbl"]
        bt = cache["k"].shape[2]
        max_len = tbl.shape[1] * bt
        if slot_start:
            raise ValueError("slot_start needs a slab cache: the paged "
                             "tables hold every slot")
        if tbl.shape[0] != b:
            raise ValueError(f"batch {b} != table rows {tbl.shape[0]}")
    else:
        max_len = cache["k"].shape[2]
        if not 0 <= slot_start <= cache["k"].shape[1] - b:
            raise ValueError(
                f"slots [{slot_start}, {slot_start + b}) outside the "
                f"cache's {cache['k'].shape[1]}")
    # the batch's slot rows of a slab; a pool layer is read whole
    slots = slice(None) if paged else slice(slot_start, slot_start + b)
    span = max_len if span is None else min(span, max_len)
    quantized = "k_s" in cache
    if paged:
        if span % bt:
            raise ValueError(
                f"paged span {span} must divide by block_tokens {bt}")
        # attention reads the whole pool layer; the table slices the span
        tables, span_rows = tbl[:, :span // bt], slice(None)
        positions, w_idx = _paged_write_coords(tbl, lengths, s_v, bt)
        split_slots = None
    else:
        tables, span_rows = None, slice(0, span)
        positions, rows, wpos, valid = _write_coords(lengths, s_v, max_len)
        # a window's rows sum their keys as the whole slab's launch does
        split_slots = cache["k"].shape[1]
    rope = _rope(cfg, positions)
    lengths = lengths.to(torch.int32)
    per_layer = unstack_layers(layers)
    for i, (layer, ll) in enumerate(zip(per_layer, _lora_layers(
            lora, len(per_layer)))):
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope, ll, ids)
        if quantized:
            kq, ksc = quantize_kv(k_new)
            vq, vsc = quantize_kv(v_new)
            writes = {"k": kq, "v": vq, "k_s": ksc, "v_s": vsc}
        else:
            writes = {"k": k_new.to(cache["k"].dtype),
                      "v": v_new.to(cache["v"].dtype)}
        for name, val in writes.items():
            if paged:   # duplicate coordinates only in block 0, never read
                cache[name][i][w_idx] = val
            else:
                _write_rows(cache[name][i][slots], rows, wpos, valid, val)
        kv = [cache[n][i][slots, span_rows] if n in cache else None
              for n in ("k", "v", "k_s", "v_s")]
        out = decode_attention(cfg, q, *kv, lengths, tables, split_slots)
        x = x + _wo(cfg, out, layer, ll, ids)
        x = _mlp(cfg, x, layer, ll, ids)
    return x


# -- HuggingFace checkpoints (the JAX package's load_hf) ---------------------
# HF Llama uses the rotate_half RoPE of ops/rope.py, so the mapping is a
# renaming plus the torch Linear [out, in] -> x @ W [in, out] transpose;
# per-layer tensors stack on the leading [L, ...] axis.

#: stacked-layer leaf -> (HF per-layer name, transposed)
_HF_LAYER_MAP = {
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
}


def is_hf_checkpoint(path: str) -> bool:
    """True for a HuggingFace model directory (config.json + safetensors)."""
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "config.json"))
            and bool(glob.glob(os.path.join(path, "*.safetensors"))))


def config_from_hf(path: str, **overrides: Any) -> LlamaConfig:
    """LlamaConfig from an HF config.json (Llama-family field names)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    heads = hf["num_attention_heads"]
    fields = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=hf.get("num_key_value_heads", heads),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
    )
    fields.update(overrides)
    return LlamaConfig(**fields)


def _hf_weight_map(path: str) -> dict[str, str]:
    """Tensor name -> file name, from model.safetensors.index.json for a
    sharded directory, else from the headers of every *.safetensors."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return json.load(f)["weight_map"]
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    weight_map = {}
    for fn in files:
        with safetensors.SafeFile(fn) as f:
            weight_map.update((k, os.path.basename(fn)) for k in f.keys())
    return weight_map


def load_hf(path: str, cfg: LlamaConfig | None = None, *, device="cuda",
            quantize: str | None = None, mesh=None
            ) -> tuple[Params, LlamaConfig]:
    """An HF Llama checkpoint directory as init()-shaped params: (params,
    cfg), every leaf in cfg.param_dtype, bit for bit the JAX `load_hf`'s.
    Takes sharded directories (model.safetensors.index.json) and tied
    embeddings (no lm_head.weight: embed transposed).

    Tensors go from the memory-mapped file to the device as stored (bf16
    for a published checkpoint), one leaf of one layer at a time, and are
    widened and transposed there, so the host never holds an f32 copy of
    the model (the JAX loader's f32 stack of an 8B model is 32 GB). With
    quantize="int8" each layer's matmul weights and the lm_head are
    quantized as they arrive (`quantize_params` of the loaded params, bit
    for bit), so the full-width weights never exist on the device at once.
    Every tensor's shape is checked against init()'s before any is read."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if mesh is not None:
        raise ValueError(
            "load_hf(mesh=...): sharded parameters are not ported yet "
            "(ROADMAP.md queue A6c-iii, tensor-parallel serving)")
    if cfg is None:
        cfg = config_from_hf(path)
    dev = resolve_device(device)
    weight_map = _hf_weight_map(path)
    handles: dict[str, safetensors.SafeFile] = {}

    def handle(name: str) -> safetensors.SafeFile:
        if name not in weight_map:
            raise KeyError(f"{name} missing from checkpoint {path}")
        fn = weight_map[name]
        if fn not in handles:
            handles[fn] = safetensors.SafeFile(os.path.join(path, fn))
        return handles[fn]

    def check(name: str, want: tuple, transpose: bool) -> None:
        got = handle(name).shape(name)
        got = tuple(reversed(got)) if transpose else tuple(got)
        if got != tuple(want):
            raise ValueError(f"shape mismatch: {name} {got} != {want}")

    def tensor(name: str, transpose: bool) -> torch.Tensor:
        """The stored tensor on the device, widened to f32 (exact from
        bf16, f16 and f32) and transposed there."""
        t = handle(name).get_tensor(name).to(dev, copy=True).float()
        return t.t() if transpose else t

    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    pd = cfg.param_dtype
    tied = "lm_head.weight" not in weight_map
    shapes = dict(matmul_shapes(cfg), attn_norm=(d,), mlp_norm=(d,))
    try:
        check("model.embed_tokens.weight", (V, d), False)
        check("model.norm.weight", (d,), False)
        if not tied:
            check("lm_head.weight", (d, V), True)
        for leaf, (tpl, transpose) in _HF_LAYER_MAP.items():
            for i in range(L):
                check(tpl.format(i=i), shapes[leaf], transpose)

        def as_param(w: torch.Tensor, quantized: bool):
            # quantize_params quantizes the leaf as it is stored, in pd
            w = w.to(pd).contiguous()
            return quant.quantize_int8(w) if quantized else w

        embed = tensor("model.embed_tokens.weight", False).to(pd)
        head = (embed.t() if tied else tensor("lm_head.weight", True))
        layers: Params = {}
        for leaf, (tpl, transpose) in _HF_LAYER_MAP.items():
            quantized = quantize is not None and leaf in QUANT_LEAVES
            if quantized:
                out = shapes[leaf][1]
                layers[leaf] = {
                    "q": torch.empty((L, *shapes[leaf]), dtype=torch.int8,
                                     device=dev),
                    "s": torch.empty((L, out), dtype=torch.float32,
                                     device=dev)}
            else:
                layers[leaf] = torch.empty((L, *shapes[leaf]), dtype=pd,
                                           device=dev)
            for i in range(L):
                w = as_param(tensor(tpl.format(i=i), transpose), quantized)
                if quantized:
                    layers[leaf]["q"][i] = w["q"]
                    layers[leaf]["s"][i] = w["s"]
                else:
                    layers[leaf][i] = w
        params: Params = {
            "embed": embed,
            "layers": layers,
            "final_norm": tensor("model.norm.weight", False).to(pd),
            "lm_head": as_param(head, quantize is not None),
        }
    finally:
        # drop the mappings now: a long-lived server would otherwise keep
        # every shard file mapped
        for h in handles.values():
            h.close()
    return params, cfg
