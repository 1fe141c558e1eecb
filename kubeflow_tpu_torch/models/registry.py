"""Model registry: name -> (config class, init, apply, loss_fn, abstract)
(counterpart of kubeflow_tpu/models/registry.py). A training job names a
registered model and config overrides. Every family of the JAX registry
is here: the Llama decoder (`llama`) and its LoRA fine-tune
(`llama_lora`), the Mixtral-style MoE (`mixtral`), BERT (`bert`), ResNet
(`resnet`), ViT (`vit`), the MNIST CNN (`mnist_cnn`), and the NAS CNN
(`nas_cnn`) with its DARTS supernet (`darts_supernet`). `abstract` gives
init's tree as meta tensors: a checkpoint restores into it;
`logical_axes` gives its logical sharding axes, leaf for leaf
(parallel/sharding.py); `needs_global_batch` marks a family whose loss
is already the global batch's on a mesh (the trainer does not scale
it), `local_blocks` the families that compute on `tensor`- and
`expert`-local blocks (Megatron splits; every other family runs those
axes with its blocks at rest and its compute repeated on each rank of
the group), and `splits_sequence` the families that run a `sequence`
axis (the Llama family: each rank its columns of the batch; the others
raise, ROADMAP.md queue A6b-ii), `pipelines` the families whose loss runs
the GPipe schedule on a `stage` axis (the Llama decoder and its LoRA)."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from kubeflow_tpu_torch.models import (bert, llama, lora, mnist_cnn,
                                       moe_llama, nas_cnn, resnet, vit)


class ModelDef(NamedTuple):
    config_cls: type
    init: Callable
    apply: Callable
    loss_fn: Callable
    abstract: Callable   # cfg -> init's tree as meta tensors
    logical_axes: Callable   # cfg -> init's tree of logical axis tuples
    # the loss depends on the global batch past a mean over its rows or
    # tokens (Mixtral's routing: capacity, slot priority and the aux
    # losses over every token): on a mesh the family computes the global
    # batch's loss itself (`sharding.regions`), and the trainer takes it
    # and its metrics as they are, unscaled
    needs_global_batch: bool = False
    # the family computes on tensor- and expert-local blocks (Megatron
    # splits under `sharding.regions`): the trainer gathers its params
    # over the other mesh axes only
    local_blocks: bool = False
    # the family runs on a rank's columns of the batch (its `sequence`
    # shard), its attention across the sequence group
    splits_sequence: bool = False
    # the family's loss runs the GPipe schedule on a `stage` axis past
    # one rank (parallel/pipeline.py): each rank computes on its stage's
    # slab of the stacked layers, which stays split over `stage`, and
    # the leaves outside the slab get their gradients in parts, summed
    # over `stage`; every other family gathers its slabs over `stage`
    # and repeats its compute on each stage rank
    pipelines: bool = False


_REGISTRY: dict[str, ModelDef] = {
    "llama": ModelDef(llama.LlamaConfig, llama.init, llama.apply,
                      llama.loss_fn, llama.abstract_params,
                      llama.logical_axes, local_blocks=True,
                      splits_sequence=True, pipelines=True),
    "llama_lora": ModelDef(lora.LoraLlamaConfig, lora.init, lora.apply,
                           lora.loss_fn, lora.abstract_params,
                           lora.logical_axes, local_blocks=True,
                           splits_sequence=True, pipelines=True),
    "mixtral": ModelDef(moe_llama.MoELlamaConfig, moe_llama.init,
                        moe_llama.apply, moe_llama.loss_fn,
                        moe_llama.abstract_params,
                        moe_llama.logical_axes, needs_global_batch=True,
                        local_blocks=True, splits_sequence=True),
    "mnist_cnn": ModelDef(mnist_cnn.MnistConfig, mnist_cnn.init,
                          mnist_cnn.apply, mnist_cnn.loss_fn,
                          mnist_cnn.abstract_params,
                      mnist_cnn.logical_axes),
    "bert": ModelDef(bert.BertConfig, bert.init, bert.apply, bert.loss_fn,
                     bert.abstract_params,
                      bert.logical_axes),
    "resnet": ModelDef(resnet.ResNetConfig, resnet.init, resnet.apply,
                       resnet.loss_fn, resnet.abstract_params,
                      resnet.logical_axes),
    "nas_cnn": ModelDef(nas_cnn.NasCnnConfig, nas_cnn.init, nas_cnn.apply,
                        nas_cnn.loss_fn, nas_cnn.abstract_params,
                      nas_cnn.logical_axes),
    "darts_supernet": ModelDef(nas_cnn.NasCnnConfig, nas_cnn.darts_init,
                               nas_cnn.darts_apply, nas_cnn.darts_loss_fn,
                               nas_cnn.darts_abstract_params,
                      nas_cnn.darts_logical_axes),
    "vit": ModelDef(vit.ViTConfig, vit.init, vit.apply, vit.loss_fn,
                    vit.abstract_params,
                      vit.logical_axes),
}


def get(name: str) -> ModelDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def make_config(name: str, overrides: dict[str, Any] | None = None):
    return get(name).config_cls(**(overrides or {}))
