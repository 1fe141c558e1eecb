"""Parameters from the JAX package's trees.

`from_jax_params` takes a `kubeflow_tpu.models.llama.init` (or
`quantize_params`) tree whose leaves are numpy arrays — the caller runs
`jax.tree.map(numpy.asarray, params)` — and returns the port's tree on
`device`. The two packages share the layout (stacked [L, ...] layers,
[in, out] weights, {"q", "s"} quantized leaves), so this is a leaf-by-leaf
copy; this module never imports JAX.
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
