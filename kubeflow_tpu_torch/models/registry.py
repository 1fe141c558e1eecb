"""Model registry: name -> (config class, init, apply, loss_fn)
(counterpart of kubeflow_tpu/models/registry.py). A training job names a
registered model and config overrides. Only the Llama family is ported;
the other families of the JAX registry are queued in ROADMAP.md."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from kubeflow_tpu_torch.models import llama


class ModelDef(NamedTuple):
    config_cls: type
    init: Callable
    apply: Callable
    loss_fn: Callable


_REGISTRY: dict[str, ModelDef] = {
    "llama": ModelDef(llama.LlamaConfig, llama.init, llama.apply,
                      llama.loss_fn),
}


def get(name: str) -> ModelDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def make_config(name: str, overrides: dict[str, Any] | None = None):
    return get(name).config_cls(**(overrides or {}))
