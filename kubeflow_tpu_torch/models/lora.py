"""LoRA fine-tuning for the Llama family (counterpart of
kubeflow_tpu/models/lora.py): the registered model `llama_lora`.

params = {"base": <a llama tree>, "lora": {target: {"a", "b"}}}, where a
target is any stacked-layer matmul leaf of the llama tree (QUANT_LEAVES)
and a is [L, d_in, rank], b is [L, rank, d_out]. `merge` materializes
W + (alpha / rank) · a @ b per target (one f32 "ldr,lro->ldo" product
added in the base dtype) and feeds the result to the unmodified llama
forward, so the training path and its kernels (B1-B3) are the base
model's. With `stop_base_gradient` (the default) the base enters
detached, and the trainer's `trainable_prefix: "lora"` gives it no
optimizer state either: AdamW's moments exist only for the adapters.

`merge(params, cfg, stop_base_gradient=False)` is the serving export (a
plain llama tree for the engines, `quantize_params` after it), and
`adapter_only` the checkpoint-sized artifact. `logical_axes` shards an
adapter like its target's matching dim: a keeps the input axis, b the
output axis; under a tensor split the merged blocks are the rank's
(`loss_fn`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import llama

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LoraLlamaConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = ("wq", "wk", "wv", "wo")
    # the base model's LlamaConfig fields: a job's model_overrides are
    # {rank: 8, llama: {d_model: ..., n_layers: ...}}
    llama: dict = dataclasses.field(default_factory=dict)
    # an HF safetensors directory or a port trainer checkpoint holding the
    # base; None: random from the seed
    base_checkpoint: str | None = None

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError("lora rank must be >= 1")
        object.__setattr__(self, "targets", tuple(self.targets))
        bad = set(self.targets) - set(llama.QUANT_LEAVES)
        if bad:
            raise ValueError(f"unknown lora targets {sorted(bad)}; "
                             f"known: {sorted(llama.QUANT_LEAVES)}")
        # built now, so a bad key fails here and not at some later read
        # through __getattr__
        try:
            base = llama.LlamaConfig(**self.llama)
        except TypeError as e:
            raise ValueError(f"bad llama base-config fields: {e}") from None
        object.__setattr__(self, "_base_cfg", base)

    @property
    def base_cfg(self) -> llama.LlamaConfig:
        return self._base_cfg

    def __getattr__(self, name: str) -> Any:
        """The base config's fields (the trainer's MFU and the data recipe
        read vocab_size, d_model, ... off the model config)."""
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.base_cfg, name)


def _load_base(cfg: LoraLlamaConfig, device) -> Params:
    """The base from an HF directory (`load_hf`) or the params of a port
    trainer checkpoint (`restore_params`)."""
    path = cfg.base_checkpoint
    if llama.is_hf_checkpoint(path):
        params, _ = llama.load_hf(path, cfg.base_cfg, device=device)
        return params
    from kubeflow_tpu_torch.training.checkpoint import restore_params

    return restore_params(path, llama.abstract_params(cfg.base_cfg),
                          device=device)


def init(cfg: LoraLlamaConfig, *, seed: int = 0, device="cuda",
         keep=None) -> Params:
    """{"base", "lora"}: the base from `base_checkpoint` or llama.init at
    `seed`; each target's a ~ N(0, 1/d_in) from a generator of its own
    seed and b = 0, so the merged model equals the base at step 0.
    `keep(path, tensor, layer=None)` as in llama.init (a base read from a
    checkpoint is read whole, then kept leaf by leaf)."""
    dev = resolve_device(device)
    bcfg = cfg.base_cfg
    if keep is None:
        def keep(path, t, layer=None):
            return t
    if cfg.base_checkpoint:
        base = _load_base(cfg, dev)
        base = {k: ({n: keep(f"base/layers/{n}", w) for n, w in v.items()}
                    if k == "layers" else keep(f"base/{k}", v))
                for k, v in base.items()}
    else:
        base = llama.init(bcfg, seed=seed, device=dev,
                          keep=lambda path, t, layer=None: keep(
                              f"base/{path}", t, layer))
    shapes = llama.matmul_shapes(bcfg)
    pd, L = bcfg.param_dtype, bcfg.n_layers
    adapters = {}
    for i, t in enumerate(cfg.targets):
        d_in, d_out = shapes[t]
        gen = torch.Generator(device=dev).manual_seed(
            (seed << 16) + 1000 + i)
        a = torch.randn((L, d_in, cfg.rank), generator=gen, device=dev)
        adapters[t] = {"a": keep(f"lora/{t}/a", (a / d_in ** 0.5).to(pd)),
                       "b": keep(f"lora/{t}/b",
                                 torch.zeros((L, cfg.rank, d_out), dtype=pd,
                                             device=dev))}
    return {"base": base, "lora": adapters}


def logical_axes(cfg: LoraLlamaConfig) -> Params:
    """Adapters shard like their target's matching dimension: a keeps the
    input axis (rank replicated), b keeps the output axis."""
    base = llama.logical_axes(cfg.base_cfg)
    lora = {}
    for t in cfg.targets:
        _, in_ax, out_ax = base["layers"][t]  # ("layers", in, out)
        lora[t] = {"a": ("layers", in_ax, None),
                   "b": ("layers", None, out_ax)}
    return {"base": base, "lora": lora}


def abstract_params(cfg: LoraLlamaConfig) -> Params:
    """init's tree as meta tensors (a checkpoint restore's target)."""
    bcfg = cfg.base_cfg
    meta, pd, L = torch.device("meta"), bcfg.param_dtype, bcfg.n_layers
    shapes = llama.matmul_shapes(bcfg)
    lora = {t: {"a": torch.empty((L, shapes[t][0], cfg.rank), dtype=pd,
                                 device=meta),
                "b": torch.empty((L, cfg.rank, shapes[t][1]), dtype=pd,
                                 device=meta)}
            for t in cfg.targets}
    return {"base": llama.abstract_params(bcfg), "lora": lora}


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def merge(params: Params, cfg: LoraLlamaConfig, *,
          stop_base_gradient: bool = True) -> Params:
    """base + (alpha / rank) · a @ b for every target: a plain llama tree
    (for llama.apply, the engines or quantize_params)."""
    base = (_detached(params["base"]) if stop_base_gradient
            else params["base"])
    scale = cfg.alpha / cfg.rank
    layers = dict(base["layers"])
    for t in cfg.targets:
        ab = params["lora"][t]
        delta = torch.einsum("ldr,lro->ldo", ab["a"].float(),
                             ab["b"].float()) * scale
        w = base["layers"][t]
        layers[t] = w + delta.to(w.dtype)
    return {**base, "layers": layers}


def adapter_only(params: Params) -> Params:
    """The checkpoint-sized artifact: the adapter leaves alone."""
    return {"lora": params["lora"]}


def apply(params: Params, tokens: torch.Tensor, cfg: LoraLlamaConfig, **kw):
    return llama.apply(merge(params, cfg), tokens, cfg.base_cfg, **kw)


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: LoraLlamaConfig):
    """The merged model's loss. Under a tensor split (`llama.tensor_split`)
    each merged block is this rank's: a column target's b is split with
    its output and a row target's a with its input rows, so the factor
    that stays whole (a column target's a, a row target's b) enters
    through copy_in, its gradient summed over `tensor` (each rank's block
    gives a partial one)."""
    tp = llama.tensor_split(cfg.base_cfg)
    if tp is not None:
        whole = {t: "b" if t in llama.ROW_PARALLEL else "a"
                 for t in cfg.targets}
        params = {**params, "lora": {
            t: {k: tp.copy_in(v, "tensor") if k == whole[t] else v
                for k, v in ab.items()}
            for t, ab in params["lora"].items()}}
    return llama.loss_fn(merge(params, cfg), batch, cfg.base_cfg)
