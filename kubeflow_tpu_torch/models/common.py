"""Pieces the model families share: param trees from a spec of shapes
and fills (init and the meta `abstract` tree from one description), the
classifiers' loss, stacked-layer unbinding, XLA's SAME padding for
convolutions and pools, and dtype names from a config.

The vision families take NHWC images with HWIO conv kernels, as the JAX
package's do. An NHWC tensor permuted to NCHW is PyTorch's channels_last
layout, so `nchw` costs no copy and cuDNN runs its NHWC kernels; a
kernel becomes OIHW at the point of use (`oihw`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device


def set_dtypes(cfg, *names: str) -> None:
    """Resolve a frozen config's dtype fields given as names ("bfloat16"
    from a job's config) to torch dtypes."""
    for name in names:
        value = getattr(cfg, name)
        if isinstance(value, str):
            object.__setattr__(cfg, name, getattr(torch, value))


def map_spec(spec: Any, fn) -> Any:
    """A param spec (nested dicts and lists whose leaves are (shape,
    fill) tuples) with fn(shape, fill) at each leaf."""
    if isinstance(spec, dict):
        return {k: map_spec(v, fn) for k, v in spec.items()}
    if isinstance(spec, list):
        return [map_spec(v, fn) for v in spec]
    return fn(*spec)


def _map_spec_paths(spec: Any, fn, path: str = "") -> Any:
    """map_spec with fn(path, shape, fill), path the leaf's "/"-joined
    keys (the trainer's `named_leaves` path)."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(spec, dict):
        return {k: _map_spec_paths(v, fn, sub(k)) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_map_spec_paths(v, fn, sub(i)) for i, v in enumerate(spec)]
    return fn(path, *spec)


def init_tree(spec: Any, *, seed: int, device, dtype=torch.float32,
              keep=None) -> Any:
    """Params from a spec on `device` (cuda raises without a GPU), in
    dtype: fill "ones" or "zeros", or a float, the std of a normal draw
    from `seed`. `keep(path, leaf)`, when given, takes each leaf as it is
    made and returns what the tree holds (a sharded trainer's block), so
    one whole leaf exists at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(path, shape, fill):
        if fill in ("ones", "zeros"):
            t = getattr(torch, fill)(shape, dtype=dtype, device=dev)
        else:
            t = (torch.randn(shape, generator=gen, device=dev)
                 * fill).to(dtype)
        return t if keep is None else keep(path, t)
    return _map_spec_paths(spec, make)


def meta_tree(spec: Any, dtype=torch.float32) -> Any:
    """A spec's params as meta tensors: shapes and dtypes, no memory."""
    return map_spec(spec, lambda shape, _: torch.empty(
        shape, dtype=dtype, device="meta"))


def he(fan_in: int) -> float:
    """He-normal's std."""
    return (2.0 / fan_in) ** 0.5


def classification_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy and accuracy of [B, n_classes] logits against
    integer labels [B]: (loss, {"loss", "accuracy"})."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def unstack_layers(layers: Any) -> list:
    """A stacked [L, ...] tree (nested dicts of tensors, a quantized leaf
    {"q", "s"} among them) as L per-layer trees of views, split with one
    unbind per leaf: in training, autograd then gathers the layers' grads
    with one stack per leaf, where indexing each layer would scatter its
    grad into a full-size zero tensor and add them up."""
    def parts(node):
        if isinstance(node, dict):
            return {k: parts(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    split = parts(layers)
    first = split
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(split, i) for i in range(len(first))]


def nchw(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC images -> the NCHW view (channels_last), in dtype."""
    return images.to(dtype).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as PyTorch's OIHW."""
    return w.permute(3, 2, 0, 1)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: out = ceil(size / stride),
    the total pad split low = floor(total / 2), high = the rest (so a
    stride-2 window pads one more on the high side than the low)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
              value: float = 0.0):
    """(x, symmetric padding for the op): x padded explicitly where the
    SAME pads are not symmetric, else untouched with the pads to pass."""
    (t, b), (l, r) = (same_pads(x.shape[2], kh, stride),
                      same_pads(x.shape[3], kw, stride))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def conv_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """lax.conv_general_dilated(x, w, (stride, stride), "SAME") on an
    NCHW x with an HWIO kernel (cast to x's dtype)."""
    x, pad = _pad_same(x, w_hwio.shape[0], w_hwio.shape[1], stride)
    return F.conv2d(x, oihw(w_hwio).to(x.dtype), stride=stride,
                    padding=pad, groups=groups)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """reduce_window(max, -inf, k x k, stride, "SAME") on NCHW x."""
    x, pad = _pad_same(x, k, k, stride, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=pad)
