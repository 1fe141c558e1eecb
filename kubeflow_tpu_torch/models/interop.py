"""Parameters from the JAX package's trees.

`from_jax_tree` takes any registered family's JAX param tree (numpy
leaves, as below) and the port registry's `abstract` tree for the same
config, and copies leaf for leaf after checking the structure, every
shape and every dtype. `from_jax_params` takes a
`kubeflow_tpu.models.llama.init` (or
`quantize_params`) tree whose leaves are numpy arrays — the caller runs
`jax.tree.map(numpy.asarray, params)` — and returns the port's tree on
`device`. The two packages share the layout (stacked [L, ...] layers,
[in, out] weights, {"q", "s"} quantized leaves), so this is a leaf-by-leaf
copy; this module never imports JAX. `from_jax_lora_params` does the
same for a `kubeflow_tpu.models.lora.init` tree ({"base", "lora"}).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.llama import QUANT_LEAVES, LlamaConfig


def _tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes: exact through f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # own copy


def _leaf(value: Any, device: torch.device):
    if isinstance(value, dict):
        return {k: _tensor(v, device) for k, v in value.items()}
    return _tensor(value, device)


def from_jax_tree(tree: Any, abstract: Any, device="cuda") -> Any:
    """A JAX param tree (dicts and lists of numpy leaves) as the port's
    tree on `device`, walked against `abstract` (the registry's meta
    tree for the same config): raises ValueError at the first key set,
    list length, shape or dtype that differs."""
    dev = resolve_device(device)

    def walk(node, like, path):
        where = path or "/"
        if isinstance(like, dict):
            if not isinstance(node, dict) or set(node) != set(like):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{where}: keys {got} != {sorted(like)}")
            return {k: walk(node[k], v, f"{path}/{k}") for k, v in
                    like.items()}
        if isinstance(like, (list, tuple)):
            if not isinstance(node, (list, tuple)) or len(node) != len(like):
                raise ValueError(f"{where}: not a list of {len(like)}")
            return [walk(n, v, f"{path}/{i}") for i, (n, v) in
                    enumerate(zip(node, like))]
        t = _tensor(node, dev)
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"{where}: {tuple(t.shape)} {t.dtype}, the "
                             f"port wants {tuple(like.shape)} {like.dtype}")
        return t

    return walk(tree, abstract, "")


def from_jax_params(tree: dict[str, Any], cfg: LlamaConfig,
                    device="cuda") -> dict[str, Any]:
    """JAX llama param tree (numpy leaves) -> the port's param tree."""
    dev = resolve_device(device)
    layers = tree["layers"]
    expected = set(QUANT_LEAVES) | {"attn_norm", "mlp_norm"}
    if set(layers) != expected:
        raise ValueError(f"layer leaves {sorted(layers)} != "
                         f"{sorted(expected)}")
    out = {
        "embed": _leaf(tree["embed"], dev),
        "layers": {k: _leaf(v, dev) for k, v in layers.items()},
        "final_norm": _leaf(tree["final_norm"], dev),
        "lm_head": _leaf(tree["lm_head"], dev),
    }
    n = out["layers"]["attn_norm"].shape[0]
    if n != cfg.n_layers or out["embed"].shape != (cfg.vocab_size,
                                                   cfg.d_model):
        raise ValueError("param tree does not match the config")
    return out


def from_jax_lora_params(tree: dict[str, Any], cfg, device="cuda"
                         ) -> dict[str, Any]:
    """JAX llama_lora param tree ({"base", "lora"}, numpy leaves) -> the
    port's; cfg is the port's LoraLlamaConfig."""
    dev = resolve_device(device)
    lora = {t: {k: _tensor(v, dev) for k, v in ab.items()}
            for t, ab in tree["lora"].items()}
    if set(lora) != set(cfg.targets):
        raise ValueError(f"lora targets {sorted(lora)} != "
                         f"{sorted(cfg.targets)}")
    return {"base": from_jax_params(tree["base"], cfg.base_cfg, device=dev),
            "lora": lora}
