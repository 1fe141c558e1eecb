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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.flash_decode import flash_decode_attention
from kubeflow_tpu_torch.ops.flash_prefill import flash_prefill_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rope import apply_rope_tables, rope_tables

Params = dict[str, Any]

QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
REMAT_POLICIES = ("none", "minimal", "full")


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
    # carry over. Each is stored and checked, and nothing branches on it:
    # attention always runs the kernel wrappers (the plain version only
    # for CPU tensors), and the layer loop is JAX's unrolled one, whose
    # results equal the scan's, so any scan_layers describes it.
    attention_impl: str = "flash"
    scan_layers: bool = True
    pipeline_microbatches: int = 0
    decode_attention_impl: str = "auto"
    prefill_attention_impl: str = "auto"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        for name in ("attention_impl", "decode_attention_impl",
                     "prefill_attention_impl"):
            value = getattr(self, name)
            allowed = ("flash",) if name == "attention_impl" else (
                "auto", "flash")
            if value in allowed:
                continue
            if value == "xla":
                raise ValueError(
                    f"{name}='xla': the port has no plain-version path on "
                    "the card; CUDA tensors always take the kernels "
                    "(ROADMAP.md north star, rule 4)")
            if name == "attention_impl" and value in ("ring", "ulysses"):
                raise ValueError(
                    f"attention_impl={value!r}: sequence-parallel attention "
                    "is not ported yet (ROADMAP.md queue A6, parallelism)")
            raise ValueError(f"unknown {name} {value!r}")
        if self.pipeline_microbatches != 0:
            raise ValueError(
                f"pipeline_microbatches={self.pipeline_microbatches}: "
                "pipeline parallelism is not ported yet (ROADMAP.md queue "
                "A6, parallelism)")
        for name in ("dtype", "param_dtype"):   # "bfloat16" from a config
            value = getattr(self, name)
            if isinstance(value, str):
                object.__setattr__(self, name, getattr(torch, value))

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


def init(cfg: LlamaConfig, *, seed: int = 0, device="cuda",
         quantize: str | None = None) -> Params:
    """Random params (normal / sqrt(fan_in), unit norms) from `seed`,
    built layer by layer on the device. With quantize="int8" each layer's
    matmul weights are quantized as they are made, so the f32 model never
    exists whole (at 8B it would be 32 GB). Non-quantized leaves are kept
    in cfg.param_dtype."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nh, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5

    def leaf(shape, fan_in):
        w = dense(shape, fan_in)
        return quant.quantize_int8(w) if quantize else w.to(pd)

    shapes = {"wq": ((d, nh * hd), d), "wk": ((d, nkv * hd), d),
              "wv": ((d, nkv * hd), d), "wo": ((nh * hd, d), nh * hd),
              "w_gate": ((d, f), d), "w_up": ((d, f), d),
              "w_down": ((f, d), f)}
    layers: Params = {}
    for name, (shape, _) in shapes.items():
        if quantize:
            layers[name] = {
                "q": torch.empty((L, *shape), dtype=torch.int8, device=dev),
                "s": torch.empty((L, shape[1]), dtype=torch.float32,
                                 device=dev)}
        else:
            layers[name] = torch.empty((L, *shape), dtype=pd, device=dev)
    for i in range(L):
        for name, (shape, fan_in) in shapes.items():
            w = leaf(shape, fan_in)
            if quantize:
                layers[name]["q"][i] = w["q"]
                layers[name]["s"][i] = w["s"]
            else:
                layers[name][i] = w
    layers["attn_norm"] = torch.ones((L, d), dtype=pd, device=dev)
    layers["mlp_norm"] = torch.ones((L, d), dtype=pd, device=dev)
    return {"embed": dense((cfg.vocab_size, d), d).to(pd),
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=pd, device=dev),
            "lm_head": leaf((d, cfg.vocab_size), d)}


def quantize_params(params: Params) -> Params:
    """Weight-only int8 for serving: every matmul weight becomes
    {"q", "s"}; embed and the norms stay as they are."""
    out = dict(params)
    out["layers"] = {k: (quant.quantize_int8(v) if k in QUANT_LEAVES
                         and not quant.is_quantized(v) else v)
                     for k, v in params["layers"].items()}
    if not quant.is_quantized(params["lm_head"]):
        out["lm_head"] = quant.quantize_int8(params["lm_head"])
    return out


def unstack_layers(layers: Params) -> list[Params]:
    """The stacked [L, ...] tree as L per-layer trees of views, split with
    one unbind per leaf: in training, autograd then gathers the layers'
    grads with one stack per leaf, where indexing each layer would scatter
    its grad into a full-size zero tensor and add them up."""
    parts = {k: ({"q": v["q"].unbind(0), "s": v["s"].unbind(0)}
                 if quant.is_quantized(v) else v.unbind(0))
             for k, v in layers.items()}
    return [{k: ({"q": p["q"][i], "s": p["s"][i]} if isinstance(p, dict)
                 else p[i]) for k, p in parts.items()}
            for i in range(layers["attn_norm"].shape[0])]


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------


def _attention(cfg: LlamaConfig, x: torch.Tensor, layer: Params, rope,
               segment_ids) -> torch.Tensor:
    """Pre-norm causal GQA self-attention block with its residual; the
    attention itself is flash attention (B1 forward, B2/B3 backward)."""
    q, k, v = _project_qkv(cfg, layer, x, rope)
    b, s = x.shape[:2]
    out = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    return x + quant.matmul(out.reshape(b, s, -1), layer["wo"], cfg.dtype)


def _layer_body(cfg: LlamaConfig, x: torch.Tensor, layer: Params, rope,
                segment_ids) -> torch.Tensor:
    return _mlp(cfg, _attention(cfg, x, layer, rope, segment_ids), layer)


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
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    rope = _rope(cfg, positions)
    x = _embed(params, tokens, cfg)
    body = _remat(cfg, lambda x, layer: _layer_body(cfg, x, layer, rope,
                                                    segment_ids))
    for layer in unstack_layers(params["layers"]):
        x = body(x, layer)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def apply(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
          positions: torch.Tensor | None = None,
          segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S] tokens -> [B, S, vocab] f32 logits."""
    x = apply_hidden(params, tokens, cfg, positions=positions,
                     segment_ids=segment_ids)
    return quant.matmul_f32_out(x, params["lm_head"], cfg.dtype)


def _token_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0]


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: LlamaConfig):
    """Next-token cross-entropy: batch has tokens [B, S] and optionally
    loss_mask [B, S] (1 where the target counts) and segment_ids [B, S].
    The forward runs on the full sequence and the logits shift after.
    Returns (loss, {"loss", "tokens"})."""
    if cfg.ce_chunk:
        return _chunked_ce_loss(params, batch, cfg)
    tokens = batch["tokens"].long()
    logits = apply(params, tokens, cfg,
                   segment_ids=batch.get("segment_ids"))[:, :-1]
    token_loss = _token_loss(logits, tokens[:, 1:])
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(token_loss) if mask is None
            else mask[:, 1:].float())
    total = (token_loss * mask).sum()
    n = mask.sum()
    loss = total / n.clamp_min(1.0)
    return loss, {"loss": loss, "tokens": n}


def _chunk_loss(h, targets, valid, lm_head, dtype):
    logits = quant.matmul_f32_out(h, lm_head, dtype)
    return (_token_loss(logits, targets) * valid).sum()


def _chunked_ce_loss(params: Params, batch: dict[str, torch.Tensor],
                     cfg: LlamaConfig):
    """The loss with the lm_head and log-softmax run per ce_chunk tokens
    under checkpoint, so one [B, C, vocab] block of logits is live at a
    time, forward and backward. The same loss as the plain path; S must
    divide by ce_chunk."""
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    c = cfg.ce_chunk
    if s % c:
        raise ValueError(f"seq_len {s} must divide by ce_chunk {c}")
    h = apply_hidden(params, tokens, cfg,
                     segment_ids=batch.get("segment_ids"))
    # targets roll left; the last position has no target
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.ones(b, s, device=tokens.device)
    valid[:, -1] = 0.0
    mask = batch.get("loss_mask")
    if mask is not None:   # by target position, as the plain path
        valid = valid * torch.cat(
            [mask[:, 1:].float(), torch.zeros(b, 1, device=tokens.device)],
            dim=1)
    total = torch.zeros((), device=tokens.device)
    for i in range(0, s, c):
        total = total + checkpoint(
            _chunk_loss, h[:, i:i + c], targets[:, i:i + c],
            valid[:, i:i + c], params["lm_head"], cfg.dtype,
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


def _project_qkv(cfg: LlamaConfig, layer: Params, x: torch.Tensor, rope):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = quant.matmul(h, layer["wq"], cfg.dtype).reshape(b, s, nh, hd)
    k = quant.matmul(h, layer["wk"], cfg.dtype).reshape(b, s, nkv, hd)
    v = quant.matmul(h, layer["wv"], cfg.dtype).reshape(b, s, nkv, hd)
    return apply_rope_tables(q, *rope), apply_rope_tables(k, *rope), v


def _mlp(cfg: LlamaConfig, x: torch.Tensor,
                 layer: Params) -> torch.Tensor:
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = quant.matmul(h, layer["w_gate"], cfg.dtype)
    up = quant.matmul(h, layer["w_up"], cfg.dtype)
    return x + quant.matmul(F.silu(gate) * up, layer["w_down"], cfg.dtype)


def _embed(params: Params, tokens: torch.Tensor,
           cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype)


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
                     tables: torch.Tensor | None = None) -> torch.Tensor:
    """GQA decode/verify attention over a span-sliced slab: q [B, S_v, nh,
    hd]; row i of slot b sees keys t <= lengths[b] + i. Returns
    [B, S_v, nh * hd]. With `tables` [B, span // bt] int32, ck/cv are a
    pool layer [N, bt, kv, hd] (cks/cvs [N, bt, kv]) and slot b's span is
    its table's blocks."""
    b, s_v = q.shape[:2]
    out = flash_decode_attention(q, ck, cv, lengths, k_scale=cks,
                                 v_scale=cvs,
                                 scale=1.0 / (cfg.head_dim ** 0.5),
                                 tables=tables)
    return out.reshape(b, s_v, -1)


def prefill_inner(layers: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: LlamaConfig):
    """[B, S, D] activations through the layer stack -> (x, k, v
    [L, B, S, kv, hd])."""
    b, s = x.shape[:2]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    for layer in unstack_layers(layers):
        q, k, v = _project_qkv(cfg, layer, x, rope)
        out = prefill_attention(cfg, q, k, v, q_offset=0)
        x = x + quant.matmul(out.reshape(b, s, -1), layer["wo"], cfg.dtype)
        x = _mlp(cfg, x, layer)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def lm_head(params: Params, x: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """final_norm + lm_head projection, f32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return quant.matmul_f32_out(x, params["lm_head"], cfg.dtype)


def prefill_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    """prefill without the lm_head: (x [B, S, D] before the final norm,
    k, v [L, B, S, kv, hd]). The engine projects only each prompt's last
    row, which is what it samples from."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return prefill_inner(params["layers"], _embed(params, tokens, cfg),
                         positions, cfg)


def prefill(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Right-padded prompts [B, S] -> (logits [B, S, vocab] f32, k, v
    [L, B, S, kv, hd]). Pad positions produce KV the caller masks out."""
    x, (ks, vs) = prefill_hidden(params, tokens, cfg)
    return lm_head(params, x, cfg), ks, vs


def prefill_continue(params: Params, tail_tokens: torch.Tensor,
                     k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                     cfg: LlamaConfig):
    """Forward only the tail [B, T] of prompts whose prefix KV
    [L, B, P, kv, hd] is known: the tail attends causally over
    prefix + tail (q_offset = P). Returns (logits [B, T, vocab] f32,
    k_tail, v_tail [L, B, T, kv, hd])."""
    x, ks, vs = prefill_continue_hidden(params, tail_tokens, k_prefix,
                                        v_prefix, cfg)
    return lm_head(params, x, cfg), ks, vs


def prefill_continue_hidden(params: Params, tail_tokens: torch.Tensor,
                            k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                            cfg: LlamaConfig):
    """prefill_continue without the lm_head: (x [B, T, D] before the
    final norm, k_tail, v_tail). The engine's chunked prefill projects
    only the last prompt row."""
    b, t = tail_tokens.shape
    p = k_prefix.shape[2]
    positions = p + torch.arange(t, device=tail_tokens.device)
    x = _embed(params, tail_tokens, cfg)
    layers = params["layers"]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    for i, layer in enumerate(unstack_layers(layers)):
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope)
        k_full = torch.cat([k_prefix[i].to(cfg.dtype), k_new], dim=1)
        v_full = torch.cat([v_prefix[i].to(cfg.dtype), v_new], dim=1)
        out = prefill_attention(cfg, q, k_full, v_full, q_offset=p)
        x = x + quant.matmul(out.reshape(b, t, -1), layer["wo"], cfg.dtype)
        x = _mlp(cfg, x, layer)
        ks.append(k_new)
        vs.append(v_new)
    return x, torch.stack(ks), torch.stack(vs)


def decode_step(params: Params, last_tokens: torch.Tensor, cache: Params,
                lengths: torch.Tensor, cfg: LlamaConfig,
                span: int | None = None) -> torch.Tensor:
    """One decode step over every cache slot: last_tokens [B], lengths
    [B] int32 (where this step's KV is written). Returns logits [B, vocab]
    f32 and updates `cache` in place. `span` bounds attention to the
    cache's first `span` rows (caller guarantees lengths < span)."""
    return verify_step(params, last_tokens[:, None], cache, lengths, cfg,
                       span=span)[:, 0]


def verify_step(params: Params, tokens: torch.Tensor, cache: Params,
                lengths: torch.Tensor, cfg: LlamaConfig,
                span: int | None = None) -> torch.Tensor:
    """Forward S_v tokens per slot in one pass: tokens [B, S_v] occupy
    positions lengths[b] .. lengths[b] + S_v - 1. Returns logits
    [B, S_v, vocab] f32; KV rows of all S_v positions are written into
    `cache` in place (rows at or past max_len are dropped)."""
    x = _embed(params, tokens, cfg)
    x = verify_inner(params["layers"], x, cache, lengths, cfg, span=span)
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
                 span: int | None = None) -> torch.Tensor:
    """x [B, S_v, D] through the layer stack against the cache (updated in
    place) -> x. The cache is a slab with one row per slot (B must equal
    its slot count), or, with "tbl" [B, max_len // bt] in it, the paged
    block pool [L, N, bt, ...] that the tables index."""
    b, s_v = x.shape[:2]
    paged = "tbl" in cache
    if paged:
        tbl = cache["tbl"]
        bt = cache["k"].shape[2]
        max_len = tbl.shape[1] * bt
        if tbl.shape[0] != b:
            raise ValueError(f"batch {b} != table rows {tbl.shape[0]}")
    else:
        max_len = cache["k"].shape[2]
        if cache["k"].shape[1] != b:
            raise ValueError(
                f"batch {b} != cache slots {cache['k'].shape[1]}")
    span = max_len if span is None else min(span, max_len)
    quantized = "k_s" in cache
    if paged:
        if span % bt:
            raise ValueError(
                f"paged span {span} must divide by block_tokens {bt}")
        # attention reads the whole pool layer; the table slices the span
        tables, span_rows = tbl[:, :span // bt], slice(None)
        positions, w_idx = _paged_write_coords(tbl, lengths, s_v, bt)
    else:
        tables, span_rows = None, slice(0, span)
        positions, rows, wpos, valid = _write_coords(lengths, s_v, max_len)
    rope = _rope(cfg, positions)
    lengths = lengths.to(torch.int32)
    for i, layer in enumerate(unstack_layers(layers)):
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope)
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
                _write_rows(cache[name][i], rows, wpos, valid, val)
        kv = [cache[n][i][:, span_rows] if n in cache else None
              for n in ("k", "v", "k_s", "v_s")]
        out = decode_attention(cfg, q, *kv, lengths, tables)
        x = x + quant.matmul(out, layer["wo"], cfg.dtype)
        x = _mlp(cfg, x, layer)
    return x
