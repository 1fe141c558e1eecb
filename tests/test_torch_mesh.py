"""The port's mesh, sharding rules and worker bootstrap
(kubeflow_tpu_torch/parallel/, runtime/) against the JAX package's:
MeshConfig.resolved and validate_divisibility raise JAX's messages for
the same inputs, logical_to_spec gives JAX's PartitionSpec for every
leaf of every registered family (DEFAULT_RULES and a custom rules dict),
worker_context reads the KTPU_* env as JAX's does; spec_placements, the
rank layout, the one-process skip and the card checks."""

import types

import numpy as np
import pytest
import torch

import jax

from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import sharding as jsharding
from kubeflow_tpu.runtime import bootstrap as jboot
from kubeflow_tpu_torch.models import registry as tregistry
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.runtime import bootstrap as tboot

CUSTOM = {"embed": ("data", "fsdp"), "mlp": "fsdp", "vocab": None,
          "heads": ("tensor", "sequence"), "conv_in": "tensor"}

from test_torch_logical_axes import CONFIGS  # noqa: E402


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("sizes,n", [
    ({"data": -1}, 4), ({"data": -1, "fsdp": 2}, 8), ({"fsdp": -1}, 1),
    ({"data": -1, "tensor": -1}, 4), ({"data": -1, "fsdp": 3}, 8),
    ({"data": 2, "fsdp": 4}, 4), ({"tensor": 2, "stage": 2}, 4)])
def test_mesh_config_resolves_as_jax(sizes, n):
    want = _error(lambda: jmesh.MeshConfig(**sizes).resolved(n))
    got = _error(lambda: tmesh.MeshConfig(**sizes).resolved(n))
    assert got == want
    if want is None:
        assert tmesh.MeshConfig(**sizes).resolved(n).axis_sizes() == \
            jmesh.MeshConfig(**sizes).resolved(n).axis_sizes()


def _stand_in(sizes):
    """A DeviceMesh's shape without a process group (validate_divisibility
    reads only the names and the shape)."""
    shape = tuple(sizes.get(a, 1) for a in tmesh.AXIS_ORDER)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 mesh=torch.arange(int(np.prod(shape)))
                                 .reshape(shape))


def test_validate_divisibility_raises_jax_messages():
    devices = np.array(jax.devices()[:8])
    for sizes, kw in (({"data": 2, "fsdp": 2}, {"batch": 6}),
                      ({"data": 2, "fsdp": 2}, {"batch": 8}),
                      ({"sequence": 4}, {"seq": 18}),
                      ({"tensor": 2}, {"heads": 3, "embed": 4}),
                      ({"tensor": 4}, {"embed": 6}),
                      ({"data": 8}, {"batch": 4})):
        jm = jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                             devices=list(devices[:int(np.prod(
                                 list(sizes.values())))]))
        want = _error(lambda: jmesh.validate_divisibility(jm, **kw))
        got = _error(lambda: tmesh.validate_divisibility(
            _stand_in(sizes), **kw))
        assert got == want
        assert tmesh.num_data_shards(_stand_in(sizes)) == \
            jmesh.num_data_shards(jm)


@pytest.mark.parametrize("rules", [None, CUSTOM], ids=["default", "custom"])
def test_logical_to_spec_equals_jax_partition_spec(rules):
    """Every leaf of every registered family: the port's spec tuple is
    the JAX PartitionSpec's entries."""
    n = 0
    for name in tregistry.names():
        cfg = CONFIGS[name]
        taxes = tsharding.axes_by_path(
            tregistry.get(name).logical_axes(cfg["port"]))
        jtree = jregistry.get(name).logical_axes(cfg["jax"])
        jleaves = jax.tree_util.tree_flatten_with_path(
            jtree, is_leaf=lambda x: isinstance(x, tuple))[0]
        assert len(jleaves) == len(taxes)
        for path, axes in jleaves:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            want = tuple(jsharding.logical_to_spec(axes, rules))
            assert tsharding.logical_to_spec(taxes[key], rules) == want
            n += 1
    assert n > 100


def test_spec_placements_and_the_rank_layout():
    """A spec's mesh axes become Shard placements on their tensor dims
    (a dim over two axes: both, major first); ranks lie row-major over
    AXIS_ORDER, the order of JAX's mesh device array."""
    from torch.distributed.tensor import Replicate, Shard

    m = _stand_in({"data": 2, "fsdp": 2})
    pl = tsharding.spec_placements((("data", "fsdp"), None, "tensor"), m)
    assert pl == (Shard(0), Shard(0), Replicate(), Replicate(),
                  Replicate(), Shard(2))
    assert tsharding.spec_placements((), m) == (Replicate(),) * 6
    tree = tsharding.tree_logical_to_placements(
        {"w": ("embed", "mlp"), "n": [("embed_no_fsdp",), {}]}, m)
    assert tree == {"w": (Replicate(), Shard(0)) + (Replicate(),) * 3
                    + (Shard(1),), "n": [(Replicate(),) * 6, {}]}
    with pytest.raises(ValueError, match="axis order"):
        tsharding.spec_placements((("fsdp", "data"),), m)
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, fsdp=2, tensor=2),
                         devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert ids.tolist() == torch.arange(8).reshape(
        ids.shape).tolist()
    # block r of PartitionSpec(("data", "fsdp")) is at (r // F, r % F)
    blocks = jax.device_put(np.arange(8), jmesh.batch_sharding(jm))
    for shard in blocks.addressable_shards:
        d, f = np.argwhere(jm.devices == shard.device)[0][:2]
        assert int(shard.data[0]) // 2 == d * 2 + f
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


ENVS = [
    {},
    {"KTPU_JOB_NAME": "llama", "KTPU_NAMESPACE": "ml",
     "KTPU_REPLICA_TYPE": "worker", "KTPU_REPLICA_INDEX": "3",
     "KTPU_PROCESS_ID": "3", "KTPU_NUM_PROCESSES": "4",
     "KTPU_COORDINATOR_ADDRESS": "10.0.0.2:47123",
     "KTPU_DEVICE_IDS": "3"},
    {"KTPU_DEVICE_IDS": "0,1,2,3", "KTPU_NUM_PROCESSES": "1"},
    {"KTPU_DEVICE_IDS": ""},
]


def test_worker_context_equals_jax():
    for env in ENVS:
        want = jboot.worker_context(env)
        got = tboot.worker_context(env)
        assert tuple(vars(got).values()) == tuple(vars(want).values())
        assert got.is_primary == want.is_primary


def test_one_process_skips_the_group_and_ranks_name_one_card():
    ctx = tboot.worker_context({})
    assert tboot.initialize_distributed(ctx, device="cpu") is ctx
    assert not torch.distributed.is_initialized()
    assert tboot.rank_device(ctx, "cuda") == torch.device("cuda")
    assert tboot.rank_device(tboot.worker_context(ENVS[1]), "cuda") == \
        torch.device("cuda", 3)
    for env in ({"KTPU_NUM_PROCESSES": "2"},
                {"KTPU_NUM_PROCESSES": "2", "KTPU_DEVICE_IDS": "0,1"}):
        with pytest.raises(ValueError, match="one card"):
            tboot.rank_device(tboot.worker_context(env), "cuda")
    assert tboot.rank_device(tboot.worker_context(ENVS[1]), "cpu") == \
        torch.device("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh({"data": -1})
