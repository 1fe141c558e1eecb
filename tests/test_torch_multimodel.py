"""The port's multi-model serving against the JAX package: `storage.
download` on temporary file, pvc and ktpu trees; `MultiModelAgent` over
the port's `ModelRepository` replaying the JAX agent and TrainedModel
cases (pull, LRU eviction, unload, a failed load releasing its slot, the
host's own model never evicted and its name refused); the port's server
over a repository answering V1 and V2 by name as the JAX `ModelServer`
does, for `mean` and for an MNIST-CNN `trainer` checkpoint that each
package wrote from the same params and its agent pulled by file:// URI;
`/v1/models`, a 404 for an unknown name, completions routed by "model"
on a tiny `LLMModel` beside a tensor model; gRPC by name over the same
repository; readiness over every model."""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu.pipelines.artifacts import ArtifactStore
from kubeflow_tpu.serving import agent as jagent
from kubeflow_tpu.serving import model as jmodel
from kubeflow_tpu.serving import storage as jstorage
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu.training.checkpoint import CheckpointManager as JCkpt
from kubeflow_tpu_torch.models import interop, registry
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import agent as tagent
from kubeflow_tpu_torch.serving import grpc_server as tgrpc
from kubeflow_tpu_torch.serving import model as tmodel
from kubeflow_tpu_torch.serving import storage as tstorage
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.server import CompletionServer
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(2)

ATOL = 1e-4   # f32 logits of the two packages' convolutions


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(fn):
    """fn(storage module) for JAX then the port: (value or exception
    type name, message)."""
    out = []
    for mod in (jstorage, tstorage):
        try:
            out.append(("ok", fn(mod)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("scheme", ["file", "pvc", "ktpu"])
def test_download_matches_jax(scheme, tmp_path, monkeypatch):
    monkeypatch.setenv("KTPU_VOLUMES_ROOT", str(tmp_path / "vols"))
    monkeypatch.delenv("KTPU_ARTIFACT_ROOT", raising=False)
    model = tmp_path / "m"
    model.mkdir()
    (model / "w.bin").write_bytes(b"x")
    if scheme == "file":
        uris = [f"file://{model}", str(model), f"file://{tmp_path}/none",
                "zz://x", "gs://bucket/m"]
        calls = [lambda mod, u=u: mod.download(u) for u in uris]
        dest = tmp_path / "dest"
        calls.append(lambda mod: sorted(os.listdir(
            mod.download(f"file://{model}", str(dest / mod.__name__),
                         copy=True))))
    elif scheme == "pvc":
        vol = tmp_path / "vols" / "team" / "v1" / "sub"
        vol.mkdir(parents=True)
        uris = ["pvc://v1/sub", "pvc://v1", "pvc://v2/x", "pvc://v1/../../x",
                "pvc:///x"]
        calls = [lambda mod, u=u: mod.download(u, namespace="team")
                 for u in uris]
    else:
        store = ArtifactStore(str(tmp_path / "art"))
        art = store.put_file(str(model / "w.bin"))
        calls = [lambda mod: mod.download(art.uri,
                                          artifact_root=str(tmp_path / "art")),
                 lambda mod: mod.download(art.uri),
                 lambda mod: mod.download("ktpu://ab" + "0" * 62,
                                          artifact_root=str(tmp_path / "art"))]
    for call in calls:
        jout, tout = _both(call)
        assert tout == jout
    assert tstorage.registered_schemes() == jstorage.registered_schemes()


_UNLOADS: list = []


class _Tracked(tmodel.FunctionModel):
    def unload(self):
        _UNLOADS.append(self.name)
        super().unload()


@tmodel.serving_runtime("tracked")
def _tracked(name, uri=None, **config):
    return _Tracked(name, lambda x: x)


@tmodel.serving_runtime("boom")
def _boom(name, uri=None, **config):
    raise RuntimeError("load failed")


def test_agent_pull_and_lru_evict():
    """The JAX agent's case on the port's agent: b becomes least recently
    used and is evicted by c's pull; a pull of a loaded name returns it."""
    _UNLOADS.clear()
    agent = tagent.MultiModelAgent(max_loaded=2)
    agent.pull("a", "tracked")
    agent.pull("b", "tracked")
    agent.touch("a")
    agent.pull("c", "tracked")
    assert agent.loaded() == ["a", "c"] and _UNLOADS == ["b"]
    assert agent.pulls == 3 and agent.evictions == 1
    m = agent.pull("a", "tracked")
    assert m.name == "a" and agent.pulls == 3
    agent.unload("a")
    assert agent.loaded() == ["c"] and _UNLOADS == ["b", "a"]
    assert not m.ready
    with pytest.raises(ValueError, match="max_loaded"):
        tagent.MultiModelAgent(max_loaded=0)


def test_agent_failed_load_releases_its_slot():
    agent = tagent.MultiModelAgent(max_loaded=2)
    with pytest.raises(RuntimeError, match="load failed"):
        agent.pull("x", "boom")
    agent.pull("x", "tracked")
    assert agent.loaded() == ["x"]
    with pytest.raises(tmodel.ModelError, match="no serving runtime"):
        agent.pull("y", "no-such-runtime")
    assert agent.loaded() == ["x"]


def test_agent_keeps_the_host_model_and_refuses_its_name():
    """The TrainedModel cases: capacity counts only pulled models, the
    host's own model is never evicted, and a pull of its name is
    refused with the JAX message; the JAX agent does the same."""
    msgs = []
    for mod, ag in ((jmodel, jagent), (tmodel, tagent)):
        repo = mod.ModelRepository()
        repo.register(mod.load_model("echo", "host"))
        agent = ag.MultiModelAgent(repo, max_loaded=2)
        for n in ("m1", "m2", "m3"):
            agent.pull(n, "mean")
        assert repo.names() == ["host", "m2", "m3"]
        assert agent.loaded() == ["m2", "m3"] and agent.evictions == 1
        with pytest.raises(mod.ModelError) as e:
            agent.pull("host", "mean")
        msgs.append(str(e.value))
        agent.unload("m2")
        assert repo.names() == ["host", "m3"]
    assert msgs[0] == msgs[1] and "already in use" in msgs[1]


def _answers(url, names, v1, v2):
    return {n: (_post(f"{url}/v1/models/{n}:predict", v1),
                _post(f"{url}/v2/models/{n}/infer", v2),
                _get(f"{url}/v2/models/{n}"), _get(f"{url}/v2/models/{n}/ready"))
            for n in names}


def test_mean_by_name_answers_as_jax():
    """A host echo model and an agent-pulled `mean` on each package's
    server: V1, V2, metadata and readiness by name equal."""
    outs = []
    for mod, ag, serve in ((jmodel, jagent, lambda r: ModelServer(r)),
                           (tmodel, tagent,
                            lambda r: CompletionServer(repository=r))):
        repo = mod.ModelRepository()
        repo.register(mod.load_model("echo", "host"))
        ag.MultiModelAgent(repo).pull("avg", "mean")
        server = serve(repo).start()
        try:
            x = [[2.0, 4.0, 6.0], [1.0, 2.0, 6.0]]
            v2 = {"id": "r1", "inputs": [{"name": "x", "shape": [2, 3],
                                          "datatype": "FP64",
                                          "data": sum(x, [])}]}
            outs.append(_answers(server.url, ["avg", "host", "nope"],
                                 {"instances": x}, v2))
            outs[-1]["models"] = _get(server.url + "/v1/models")
        finally:
            server.stop()
    for n in ("avg", "host", "nope"):
        j, t = outs[0][n], outs[1][n]
        assert t[0] == j[0] and t[1] == j[1] and t[3] == j[3], n
        assert t[2][0] == j[2][0]
    assert outs[1]["avg"][0] == (200, {"predictions": [4.0, 3.0]})
    assert outs[1]["nope"][0][0] == 404
    assert outs[1]["models"] == outs[0]["models"] == (
        200, {"models": ["avg", "host"]})


MNIST = {"c1": 4, "c2": 8, "hidden": 16}


def test_trainer_checkpoint_by_name_answers_as_jax(tmp_path):
    """One MNIST-CNN init (JAX, seed 0) written by the JAX checkpoint
    manager and, carried over, by the port's; each package's agent pulls
    its checkpoint through the `trainer` runtime by file:// URI into the
    repository its server serves: V1 logits within ATOL, argmax and the
    V2 shapes equal."""
    jov = dict(MNIST, dtype=jnp.float32)
    jdef = jregistry.get("mnist_cnn")
    jparams = jdef.init(jax.random.key(0), jdef.config_cls(**jov))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jm = JCkpt(str(jdir))
    jm.save(2, {"params": jparams, "step": 2}, force=True)
    jm.close()
    tov = dict(MNIST, dtype="float32")
    tdef = registry.get("mnist_cnn")
    params = interop.from_jax_tree(jax.tree.map(np.asarray, jparams),
                                   tdef.abstract(tdef.config_cls(**tov)),
                                   device="cpu")
    tm = CheckpointManager(str(tdir))
    tm.save(2, {"params": params, "step": 2}, force=True)
    tm.close()
    images = np.random.default_rng(3).normal(size=(3, 28, 28, 1))
    v1 = {"instances": images.tolist()}
    v2 = {"inputs": [{"name": "image", "shape": [3, 28, 28, 1],
                      "datatype": "FP32",
                      "data": images.astype(np.float32).ravel().tolist()}]}
    got = {}
    for side, mod, ag, serve, ckpt, ov, extra in (
            ("jax", jmodel, jagent, lambda r: ModelServer(r), jdir, jov, {}),
            ("port", tmodel, tagent, lambda r: CompletionServer(repository=r),
             tdir, tov, {"device": "cpu"})):
        repo = mod.ModelRepository()
        agent = ag.MultiModelAgent(repo, max_loaded=2)
        for out in ("logits", "argmax"):
            agent.pull(f"mnist-{out}", "trainer", f"file://{ckpt}",
                       model="mnist_cnn", model_overrides=ov, output=out,
                       **extra)
        server = serve(repo).start()
        try:
            got[side] = [_post(f"{server.url}/v1/models/mnist-{o}:predict",
                               v1) for o in ("logits", "argmax")] + [
                _post(f"{server.url}/v2/models/mnist-logits/infer", v2)]
        finally:
            server.stop()
    (jl, ja, jv2), (tl, ta, tv2) = got["jax"], got["port"]
    assert tl[0] == jl[0] == 200 and ta == ja and tv2[0] == jv2[0] == 200
    np.testing.assert_allclose(tl[1]["predictions"], jl[1]["predictions"],
                               atol=ATOL)
    assert np.shape(tl[1]["predictions"]) == (3, 10)
    to, jo = tv2[1]["outputs"][0], jv2[1]["outputs"][0]
    assert (to["name"], to["shape"], to["datatype"]) == (
        jo["name"], jo["shape"], jo["datatype"])
    np.testing.assert_allclose(to["data"], jo["data"], atol=ATOL)


@pytest.fixture(scope="module")
def mixed():
    """The port's server over a repository: a tiny f32 LLMModel (the
    server's own) and an agent-pulled mean model."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    params = tllama.init(cfg, seed=0, device="cpu")
    llm = LLMModel("tiny", device="cpu", params=params, llama_config=cfg,
                   n_slots=2, max_len=32, buckets=[16], decode_chunk=1,
                   seed=0)
    server = CompletionServer(llm, grpc=True)
    agent = tagent.MultiModelAgent(server.repository, max_loaded=1)
    agent.pull("avg", "mean")
    server.start()
    yield server, agent, llm
    server.stop()


def test_routes_by_name_beside_an_llm(mixed):
    server, agent, llm = mixed
    url = server.url
    assert _get(url + "/v1/models") == (200, {"models": ["avg", "tiny"]})
    code, out = _post(url + "/openai/v1/completions",
                      {"model": "tiny", "prompt": [3, 4, 5], "max_tokens": 4})
    assert code == 200 and out["model"] == "tiny"
    want = llm.predict([{"prompt_tokens": [3, 4, 5], "max_new_tokens": 4}])
    assert out["choices"][0]["token_ids"] == want[0]["output_tokens"]
    code, _ = _post(url + "/openai/v1/completions",
                    {"prompt": [3, 4, 5], "max_tokens": 2})
    assert code == 200   # the server's own model
    code, out = _post(url + "/openai/v1/completions",
                      {"model": "avg", "prompt": [3], "max_tokens": 2})
    assert code == 400 and "text completions" in out["error"]
    for path in ("/openai/v1/completions", "/v1/models/nope:predict",
                 "/v2/models/nope/infer"):
        code, out = _post(url + path, {"model": "nope", "prompt": [1],
                                       "instances": [1], "inputs": []})
        assert code == 404 and "'nope' not found" in out["error"], path
    assert _get(url + "/v2/models/nope")[0] == 404
    assert _get(url + "/v2/models/nope/ready")[0] == 503
    assert _post(url + "/v1/models/avg:predict",
                 {"instances": [[1.0, 3.0]]}) == (200, {"predictions": [2.0]})
    health = _get(url + "/healthz")[1]
    assert set(health["supervisor"]) == {"tiny"}


def test_grpc_routes_by_name_over_the_repository(mixed):
    server, agent, _ = mixed
    client = tgrpc.GrpcInferenceClient(server.grpc_address)
    try:
        x = np.array([[1.0, 2.0, 6.0]])
        np.testing.assert_allclose(client.infer("avg", {"x": x})["output0"],
                                   [3.0])
        out = client.infer("tiny", {
            "prompt_tokens": np.array([3, 4, 5], np.int64),
            "max_new_tokens": np.array(4, np.int32)})["output_tokens"]
        assert len(out) == 4
        assert client.model_ready("avg") and not client.model_ready("nope")
        assert client.server_ready()
        with pytest.raises(grpc.RpcError) as e:
            client.infer("nope", {"x": x})
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        client.close()


def test_readiness_looks_at_every_model(mixed):
    """A pulled model whose supervisor is out of restarts takes the whole
    replica out of rotation (HTTP and gRPC); its eviction puts it back."""
    server, agent, _ = mixed

    class Failed(tmodel.FunctionModel):
        def metrics(self):
            return {"supervisor": {"permanent_failed": True}}

    @tmodel.serving_runtime("failed")
    def _failed(name, uri=None, **config):
        return Failed(name, lambda x: x)

    assert _get(server.url + "/v2/health/ready") == (200, {"ready": True})
    agent.pull("broken", "failed")          # evicts avg (max_loaded 1)
    assert server.repository.names() == ["broken", "tiny"]
    assert _get(server.url + "/v2/health/ready") == (503, {"ready": False})
    client = tgrpc.GrpcInferenceClient(server.grpc_address)
    try:
        assert not client.server_ready()
        agent.pull("avg", "mean")           # evicts broken
        assert client.server_ready()
    finally:
        client.close()
    assert _get(server.url + "/v2/health/ready") == (200, {"ready": True})
