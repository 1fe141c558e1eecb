"""Model registry: name -> (config class, init, apply, loss_fn, abstract)
(counterpart of kubeflow_tpu/models/registry.py). A training job names a
registered model and config overrides. The Llama family is ported
(`llama` and its LoRA fine-tune `llama_lora`); the other families of the
JAX registry are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from kubeflow_tpu_torch.models import llama, lora


class ModelDef(NamedTuple):
    config_cls: type
    init: Callable
    apply: Callable
    loss_fn: Callable
    abstract: Callable   # cfg -> init's tree as meta tensors


_REGISTRY: dict[str, ModelDef] = {
    "llama": ModelDef(llama.LlamaConfig, llama.init, llama.apply,
                      llama.loss_fn, llama.abstract_params),
    "llama_lora": ModelDef(lora.LoraLlamaConfig, lora.init, lora.apply,
                           lora.loss_fn, lora.abstract_params),
}


def get(name: str) -> ModelDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def make_config(name: str, overrides: dict[str, Any] | None = None):
    return get(name).config_cls(**(overrides or {}))
