"""Llama-family decoder, serving path (counterpart of
kubeflow_tpu/models/llama.py: config, init, quantize_params, the KV
cache, prefill, prefill_continue, decode_step and verify_step).

Layout follows the JAX package so parameters convert one to one
(models/interop.py): weights are [in, out] applied as x @ W, every
per-layer tensor is stacked on a leading [L, ...] axis, and a quantized
leaf is {"q": int8 [..., in, out], "s": f32 [..., out]}. The lax.scan over
layers is a Python loop. Attention goes through the kernel wrappers of
ops/flash_prefill.py and ops/flash_decode.py, which launch the CUDA
kernels for CUDA tensors and run their plain versions for CPU tensors.

The KV cache is updated IN PLACE by verify_step/decode_step (the JAX
functions return a new cache): at 8B width the cache is about a gigabyte,
and rewriting it per step would double the step's memory traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops.flash_decode import flash_decode_attention
from kubeflow_tpu_torch.ops.flash_prefill import flash_prefill_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rope import apply_rope_tables, rope_tables

Params = dict[str, Any]

QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

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
                           rope_theta=10000.0)


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


def layer_at(layers: Params, i: int) -> Params:
    """Layer i of the stacked [L, ...] tree (views, no copies)."""
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if quant.is_quantized(v)
                else v[i]) for k, v in layers.items()}


def n_layers_of(layers: Params) -> int:
    v = layers["attn_norm"]
    return v.shape[0]


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


def _serving_mlp(cfg: LlamaConfig, x: torch.Tensor,
                 layer: Params) -> torch.Tensor:
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = quant.matmul(h, layer["w_gate"], cfg.dtype)
    up = quant.matmul(h, layer["w_up"], cfg.dtype)
    return x + quant.matmul(F.silu(gate) * up, layer["w_down"], cfg.dtype)


def _embed(params: Params, tokens: torch.Tensor,
           cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype)


def prefill_attention(cfg: LlamaConfig, q, k, v, cks=None, cvs=None, *,
                      q_offset: int = 0) -> torch.Tensor:
    """Causal GQA chunk attention: q [B, S, nh, hd] at absolute rows
    q_offset + i against k/v [B, T, kv, hd] (cfg.dtype, or int8 with
    cks/cvs [B, T, kv] f32 scales). Returns [B, S, nh, hd]."""
    return flash_prefill_attention(q, k, v, q_offset=q_offset,
                                   k_scale=cks, v_scale=cvs,
                                   scale=1.0 / (cfg.head_dim ** 0.5))


def decode_attention(cfg: LlamaConfig, q, ck, cv, cks, cvs,
                     lengths: torch.Tensor) -> torch.Tensor:
    """GQA decode/verify attention over a span-sliced slab: q [B, S_v, nh,
    hd]; row i of slot b sees keys t <= lengths[b] + i. Returns
    [B, S_v, nh * hd]."""
    b, s_v = q.shape[:2]
    out = flash_decode_attention(q, ck, cv, lengths, k_scale=cks,
                                 v_scale=cvs,
                                 scale=1.0 / (cfg.head_dim ** 0.5))
    return out.reshape(b, s_v, -1)


def prefill_inner(layers: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: LlamaConfig):
    """[B, S, D] activations through the layer stack -> (x, k, v
    [L, B, S, kv, hd])."""
    b, s = x.shape[:2]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    for i in range(n_layers_of(layers)):
        layer = layer_at(layers, i)
        q, k, v = _project_qkv(cfg, layer, x, rope)
        out = prefill_attention(cfg, q, k, v, q_offset=0)
        x = x + quant.matmul(out.reshape(b, s, -1), layer["wo"], cfg.dtype)
        x = _serving_mlp(cfg, x, layer)
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
    b, t = tail_tokens.shape
    p = k_prefix.shape[2]
    positions = p + torch.arange(t, device=tail_tokens.device)
    x = _embed(params, tail_tokens, cfg)
    layers = params["layers"]
    rope = _rope(cfg, positions)
    ks, vs = [], []
    for i in range(n_layers_of(layers)):
        layer = layer_at(layers, i)
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope)
        k_full = torch.cat([k_prefix[i].to(cfg.dtype), k_new], dim=1)
        v_full = torch.cat([v_prefix[i].to(cfg.dtype), v_new], dim=1)
        out = prefill_attention(cfg, q, k_full, v_full, q_offset=p)
        x = x + quant.matmul(out.reshape(b, t, -1), layer["wo"], cfg.dtype)
        x = _serving_mlp(cfg, x, layer)
        ks.append(k_new)
        vs.append(v_new)
    return lm_head(params, x, cfg), torch.stack(ks), torch.stack(vs)


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


def verify_inner(layers: Params, x: torch.Tensor, cache: Params,
                 lengths: torch.Tensor, cfg: LlamaConfig,
                 span: int | None = None) -> torch.Tensor:
    """x [B, S_v, D] through the layer stack against the slab cache
    (updated in place) -> x. B must equal the cache's slot count."""
    b, s_v = x.shape[:2]
    max_len = cache["k"].shape[2]
    if cache["k"].shape[1] != b:
        raise ValueError(f"batch {b} != cache slots {cache['k'].shape[1]}")
    span = max_len if span is None else min(span, max_len)
    quantized = "k_s" in cache
    positions, rows, wpos, valid = _write_coords(lengths, s_v, max_len)
    rope = _rope(cfg, positions)
    lengths = lengths.to(torch.int32)
    for i in range(n_layers_of(layers)):
        layer = layer_at(layers, i)
        q, k_new, v_new = _project_qkv(cfg, layer, x, rope)
        if quantized:
            kq, ksc = quantize_kv(k_new)
            vq, vsc = quantize_kv(v_new)
            writes = {"k": kq, "v": vq, "k_s": ksc, "v_s": vsc}
        else:
            writes = {"k": k_new.to(cache["k"].dtype),
                      "v": v_new.to(cache["v"].dtype)}
        for name, val in writes.items():
            _write_rows(cache[name][i], rows, wpos, valid, val)
        out = decode_attention(
            cfg, q, cache["k"][i][:, :span], cache["v"][i][:, :span],
            cache["k_s"][i][:, :span] if quantized else None,
            cache["v_s"][i][:, :span] if quantized else None, lengths)
        x = x + quant.matmul(out, layer["wo"], cfg.dtype)
        x = _serving_mlp(cfg, x, layer)
    return x
