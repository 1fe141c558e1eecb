"""Every family's logical_axes in the port's registry against the JAX
registry's: the same tree of axis tuples, and the structure of the
family's `abstract` (init's tree) leaf for leaf."""

import pytest

from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu_torch.models import registry as tregistry
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.training import trainer as ttrainer

LLAMA = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8,
             n_kv_heads=4, d_ff=128, max_seq_len=128)
NAS = dict(ops=("conv3", "sep3", "maxpool", "identity", "conv5"),
           channels=8)
# (port config, JAX config) of each registered family at a small size
CONFIGS = {
    "llama": (LLAMA, LLAMA),
    "llama_lora": (dict(rank=4, targets=("wq", "wv", "w_up"), llama=LLAMA),
                   dict(rank=4, targets=("wq", "wv", "w_up"), llama=LLAMA)),
    "mixtral": ({}, {}),
    "bert": ({}, {}),
    "resnet": (dict(stage_sizes=(2, 1), width=8),
               dict(stage_sizes=(2, 1), width=8)),
    "vit": ({}, {}),
    "mnist_cnn": ({}, {}),
    "nas_cnn": (NAS, NAS),
    "darts_supernet": (NAS, NAS),
}
CONFIGS = {name: {"port": tregistry.get(name).config_cls(**p),
                  "jax": jregistry.get(name).config_cls(**j)}
           for name, (p, j) in CONFIGS.items()}


def _as_lists(tree):
    """A logical tree with lists for lists and tuples for axes (JAX's
    trees use lists for layer lists too)."""
    if tsharding.is_axes_leaf(tree):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    return [_as_lists(v) for v in tree]


@pytest.mark.parametrize("name", tregistry.names())
def test_logical_axes_equal_jax_and_match_abstract(name):
    cfg = CONFIGS[name]
    got = tregistry.get(name).logical_axes(cfg["port"])
    want = jregistry.get(name).logical_axes(cfg["jax"])
    assert _as_lists(got) == _as_lists(want)
    paths = tsharding.axes_by_path(got)
    abstract = ttrainer.named_leaves(tregistry.get(name).abstract(
        cfg["port"]))
    assert sorted(paths) == sorted(p for p, _ in abstract)
    for path, leaf in abstract:
        assert len(paths[path]) == leaf.dim(), path
