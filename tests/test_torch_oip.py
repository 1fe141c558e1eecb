"""The port's Open Inference Protocol dataplanes on the CPU against the JAX
server's: the V2 `infer` route and gRPC `ModelInfer` over an `LLMModel`
(tiny Llama, f32, the JAX model's weights) answer what the JAX
`ModelServer` and `GrpcInferenceServer` answer over the JAX `LLMModel`;
the gRPC dtypes, health, metadata and refusals as in JAX (over a tensor
model both servers host); `DynamicBatcher` against the JAX one and
batching on both dataplanes; `PayloadLogger` records, modes, error
pairing and the url sink against JAX's; `grpc` without grpcio raising;
`CompletionServer.from_config` taking the predictor's grpc, logger and
batching keys; the OIP codec against JAX's; and readiness gated on a
failed supervisor on both dataplanes."""

import dataclasses
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from unittest import mock

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import agent as jagent
from kubeflow_tpu.serving import batching as jbatching
from kubeflow_tpu.serving import grpc_server as jgrpc
from kubeflow_tpu.serving.model import (FunctionModel, ModelRepository,
                                        load_model)
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import agent, batching
from kubeflow_tpu_torch.serving import grpc_server as tgrpc
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

SERVING = dict(n_slots=2, max_len=16, buckets=[8], decode_chunk=1, seed=0)
PROMPTS = ([1, 2, 3, 4, 5, 6, 7, 8, 9], [4, 5], list(range(2, 12)))


class TensorModel:
    """A tensor model with the port's model surface (the port's servers
    host one model of any kind that has it), beside the JAX
    `FunctionModel` of the same function."""

    def __init__(self, name, fn):
        self.name, self.fn, self.ready = name, fn, True

    def predict(self, payload):
        return self.fn(payload)

    def preprocess(self, payload):
        return payload

    postprocess = preprocess

    def input_spec(self):
        return [{"name": "x", "datatype": "FP32", "shape": [-1]}]

    def output_spec(self):
        return []

    def metrics(self):
        return {}


def _neg(d):
    return {"out": ~d["b"], "i": -d["i"]}


def _double(d):
    return {"y": np.asarray(d["x"]) * 2}


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


def _v2_body(prompt, new):
    return {"id": f"r{len(prompt)}", "inputs": [
        {"name": "prompt_tokens", "shape": [len(prompt)],
         "datatype": "INT64", "data": prompt},
        {"name": "max_new_tokens", "shape": [], "datatype": "INT32",
         "data": new}]}


@pytest.fixture(scope="module")
def llm():
    """The JAX LLMModel (HTTP and gRPC servers over its repository) and
    the port's over the same weights (its server with gRPC beside it)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    repo = ModelRepository()
    repo.register(load_model("llama", "m", None,
                             model=dataclasses.asdict(jcfg), **SERVING))
    jhttp = ModelServer(repo).start()
    jgrpc_srv = jgrpc.GrpcInferenceServer(repo).start()
    port = CompletionServer(
        LLMModel("m", device="cpu", params=tparams, llama_config=tcfg,
                 **SERVING), grpc=True).start()
    yield jhttp, jgrpc_srv, port
    port.stop()
    jgrpc_srv.stop()
    jhttp.stop()
    repo.unload("m")


@pytest.fixture(scope="module")
def tensor_servers():
    """A tensor model's JAX and port gRPC servers, and their clients."""
    repo = ModelRepository()
    repo.register(FunctionModel("neg", _neg))
    jsrv = jgrpc.GrpcInferenceServer(repo).start()
    tsrv = tgrpc.GrpcInferenceServer(TensorModel("neg", _neg)).start()
    clients = (jgrpc.GrpcInferenceClient(jsrv.address),
               tgrpc.GrpcInferenceClient(tsrv.address))
    yield clients
    for c in clients:
        c.close()
    jsrv.stop()
    tsrv.stop()


def test_v2_infer_matches_the_jax_server(llm):
    jhttp, _, port = llm
    for i, prompt in enumerate(PROMPTS):
        body = _v2_body(prompt, 4 + i)
        want = _post(f"{jhttp.url}/v2/models/m/infer", body)
        got = _post(f"{port.url}/v2/models/m/infer", body)
        assert got == want
        assert want[0] == 200 and want[1]["outputs"][0]["datatype"] == "INT64"
        assert len(want[1]["outputs"][0]["data"]) == 4 + i
    # the errors: a 400 with the JAX message, a 404, a bad route
    for body in ({"inputs": [{"name": "x", "shape": [1], "datatype": "NOPE",
                              "data": [1]}]},
                 {"nothing": 1},
                 {"inputs": [{"name": "x", "shape": [3], "datatype": "FP32",
                              "data": [1, 2]}]}):
        assert _post(f"{port.url}/v2/models/m/infer", body) == _post(
            f"{jhttp.url}/v2/models/m/infer", body)
    assert _post(f"{port.url}/v2/models/zz/infer", {})[0] == 404


def test_grpc_model_infer_matches_the_jax_grpc_server(llm):
    _, jsrv, port = llm
    clients = {"jax": jgrpc.GrpcInferenceClient(jsrv.address),
               "port": tgrpc.GrpcInferenceClient(port.grpc_address),
               # the JAX client speaks to the port's server: one wire
               "cross": jgrpc.GrpcInferenceClient(port.grpc_address)}
    try:
        for prompt in PROMPTS:
            inputs = {"prompt_tokens": np.array(prompt, np.int64),
                      "max_new_tokens": np.array(5, np.int32)}
            outs = {k: c.infer("m", inputs, id="g1")
                    for k, c in clients.items()}
            want = outs["jax"]["output_tokens"]
            assert want.dtype == np.int64 and want.shape == (5,)
            for k in ("port", "cross"):
                np.testing.assert_array_equal(outs[k]["output_tokens"], want)
        # and the HTTP route of the same model answers the same
        body = _v2_body(list(PROMPTS[0]), 5)
        _, h = _post(f"{port.url}/v2/models/m/infer", body)
        inputs = {"prompt_tokens": np.array(PROMPTS[0], np.int64),
                  "max_new_tokens": np.array(5, np.int32)}
        np.testing.assert_array_equal(
            clients["port"].infer("m", inputs)["output_tokens"],
            h["outputs"][0]["data"])
    finally:
        for c in clients.values():
            c.close()


def test_grpc_health_ready_and_metadata(llm):
    _, jsrv, port = llm
    pc = tgrpc.GrpcInferenceClient(port.grpc_address)
    jc = jgrpc.GrpcInferenceClient(jsrv.address)
    try:
        assert pc.server_live() and pc.server_ready()
        assert pc.model_ready("m") and not pc.model_ready("nope")
        assert jc.model_ready("m") and not jc.model_ready("nope")
        md = pc.model_metadata("m")
        assert md.name == "m" and md.platform == "pytorch-cuda"
        for c in (pc, jc):
            with pytest.raises(grpc.RpcError) as e:
                c.model_metadata("nope")
            assert e.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        pc.close()
        jc.close()


def test_grpc_int_and_bool_dtypes_as_in_jax(tensor_servers):
    inputs = {"b": np.array([True, False]),
              "i": np.array([1, -2], np.int64)}
    jout, tout = (c.infer("neg", inputs) for c in tensor_servers)
    assert jout.keys() == tout.keys() == {"out", "i"}
    for k in jout:
        np.testing.assert_array_equal(tout[k], jout[k])
        assert tout[k].dtype == jout[k].dtype
    np.testing.assert_array_equal(tout["out"], [False, True])
    assert tout["i"].dtype == np.int64


def test_grpc_refusals_as_in_jax(tensor_servers):
    """An unknown model, a tensor whose values do not fit its shape, and
    raw_input_contents: the JAX status codes and messages."""
    from kubeflow_tpu_torch.serving.protos import inference_pb2 as pb

    bad_shape = pb.ModelInferRequest(model_name="neg")
    t = bad_shape.inputs.add()
    t.name, t.datatype = "i", "INT64"
    t.shape.extend([2, 2])
    t.contents.int64_contents.extend([1, 2, 3])     # 3 values, shape 4
    raw = pb.ModelInferRequest(model_name="neg")
    raw.raw_input_contents.append(b"\x00\x00\x80\x3f")
    unknown = pb.ModelInferRequest(model_name="missing")
    got = []
    for client in tensor_servers:
        row = []
        for req in (bad_shape, raw, unknown):
            with pytest.raises(grpc.RpcError) as e:
                client._infer(req, timeout=10)
            row.append((e.value.code(), e.value.details()))
        got.append(row)
    assert got[0] == got[1]
    assert [c for c, _ in got[1]] == [grpc.StatusCode.INVALID_ARGUMENT,
                                      grpc.StatusCode.INVALID_ARGUMENT,
                                      grpc.StatusCode.NOT_FOUND]


def test_dynamic_batcher_matches_jax():
    """_stack/_unstack on dict and array payloads, one concurrent burst
    through each batcher (the same results, and shared batches), a
    malformed payload failing only its own caller, and stop()."""
    payloads = [{"x": np.full((n, 2), float(n)), "z": np.arange(n)}
                for n in (1, 3, 2)]
    for mod in (batching, jbatching):
        stacked, sizes = mod._stack(payloads)
        assert sizes == [1, 3, 2]
    ts, ss = batching._stack(payloads)
    js, _ = jbatching._stack(payloads)
    for k in ts:
        np.testing.assert_array_equal(ts[k], js[k])
    for a, b in zip(batching._unstack(ts, ss), jbatching._unstack(js, ss)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    arrays = [np.arange(2), np.arange(3)]
    assert [a.tolist() for a in batching._unstack(*batching._stack(
        arrays))] == [a.tolist() for a in jbatching._unstack(
            *jbatching._stack(arrays))]

    def burst(mod):
        seen = []

        def fn(d):
            seen.append(len(d["x"]))
            if np.any(np.asarray(d["x"]) < 0):
                raise ValueError("negative")
            return _double(d)

        b = mod.DynamicBatcher(fn, max_batch_size=8, max_latency_ms=50)
        out: dict = {}
        gate = threading.Barrier(5)

        def call(i):
            gate.wait()
            x = np.array([float(i)]) if i != 4 else [[1.0], [2.0]]
            try:
                out[i] = b({"x": x})["y"].tolist()
            except Exception as e:
                out[i] = type(e).__name__
        ts_ = [threading.Thread(target=call, args=(i,)) for i in range(5)]
        for t in ts_:
            t.start()
        for t in ts_:
            t.join()
        b.stop()
        with pytest.raises(RuntimeError, match="batcher stopped"):
            b({"x": np.zeros(1)})
        return out, max(seen)

    (tout, tmax), (jout, jmax) = burst(batching), burst(jbatching)
    assert tout == jout
    assert tout[3] == [6.0] and tmax > 1 and jmax > 1


def test_batching_wraps_predict_on_both_dataplanes():
    """{model: {maxBatchSize, maxLatencyMs}} on the port's server: a
    concurrent burst over HTTP V2 and over gRPC shares model calls, and
    every caller gets its own rows, as on the JAX servers."""
    sizes = []

    def fn(d):
        sizes.append(len(d["x"]))
        return _double(d)

    cfg = {"b": {"maxBatchSize": 8, "maxLatencyMs": 50}}
    server = CompletionServer(TensorModel("b", fn), batching=cfg,
                              grpc=True).start()
    client = tgrpc.GrpcInferenceClient(server.grpc_address)
    out: dict = {}
    gate = threading.Barrier(8)

    def call(i):
        gate.wait()
        x = np.array([float(i)], np.float32)
        if i % 2:
            out[i] = client.infer("b", {"x": x})["y"].tolist()
        else:
            body = {"inputs": [{"name": "x", "shape": [1],
                                "datatype": "FP32", "data": [float(i)]}]}
            out[i] = _post(f"{server.url}/v2/models/b/infer",
                           body)[1]["outputs"][0]["data"]

    try:
        ts = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        client.close()
        server.stop()
    assert out == {i: [2.0 * i] for i in range(8)}
    assert max(sizes) > 1 and sum(sizes) == 8


def _log_run(server_cls, model, logger, url_of):
    """The same exchanges on a server with a payload logger: a V1
    predict, a V2 infer, a 400 of each, a 404, then a broken sink."""
    server = server_cls(model, logger)
    codes = []
    try:
        for path, body in (("/v1/models/d:predict", {"instances": [1, 2]}),
                           ("/v2/models/d/infer", {"inputs": [
                               {"name": "x", "shape": [2], "datatype": "FP32",
                                "data": [1.0, 2.0]}]}),
                           ("/v1/models/d:predict", {"wrong": 1}),
                           ("/v2/models/d/infer", {"inputs": 3}),
                           ("/v1/models/nope:predict", {"instances": [1]})):
            codes.append(_post(url_of(server) + path, body)[0])
        logger.path = logger.path + ".gone/x.jsonl"
        codes.append(_post(url_of(server) + "/v1/models/d:predict",
                           {"instances": [7]})[0])
    finally:
        server.stop()
    return codes


def _records(path):
    out = []
    for line in open(path):
        r = json.loads(line)
        r.pop("ts")
        assert r.pop("latency_ms", 0) >= 0
        out.append(r)
    return out


def test_payload_logger_records_and_error_pairing_match_jax(tmp_path):
    def fn(d):
        if isinstance(d, dict):
            return _double(d)
        return [2 * x for x in d]

    def jserver(model, logger):
        repo = ModelRepository()
        repo.register(FunctionModel("d", fn))
        return ModelServer(repo, payload_logger=logger).start()

    def tserver(model, logger):
        return CompletionServer(TensorModel("d", fn),
                                payload_logger=logger).start()

    logs = {}
    for name, cls, mod in (("jax", jserver, jagent), ("port", tserver, agent)):
        path = str(tmp_path / f"{name}.jsonl")
        codes = _log_run(cls, None, mod.PayloadLogger(path=path),
                         lambda s: s.url)
        logs[name] = (codes, _records(path))
    assert logs["port"] == logs["jax"]
    codes, records = logs["port"]
    assert codes == [200, 200, 400, 400, 404, 200]
    assert [r["type"] for r in records] == ["request", "response"] * 5
    assert all(a["id"] == b["id"] for a, b in zip(records[::2],
                                                  records[1::2]))
    assert [r["status"] for r in records[1::2]] == [200, 200, 400, 400, 404]


def test_payload_logger_modes_and_url_sink_match_jax(tmp_path):
    got: list = []

    class Collector(BaseHTTPRequestHandler):
        def do_POST(self):
            got.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    sink = ThreadingHTTPServer(("127.0.0.1", 0), Collector)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{sink.server_address[1]}/log"
    try:
        for mod in (agent, jagent):
            for mode in ("all", "request", "response"):
                lg = mod.PayloadLogger(url=url, mode=mode)
                rid = lg.next_id()
                lg.log_request("m", rid, {"x": 1})
                lg.log_response("m", rid, {"y": 2}, 1.25, 201)
                lg.flush()
            # a dead collector: swallowed, never raised
            dead = mod.PayloadLogger(url="http://127.0.0.1:9/x")
            dead.log_request("m", "r", {})
            dead.flush()
            with pytest.raises(ValueError, match="invalid"):
                mod.PayloadLogger(path="p", mode="nope")
            with pytest.raises(ValueError, match="path or url"):
                mod.PayloadLogger()
        deadline = time.monotonic() + 10
        while len(got) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sink.shutdown()
        sink.server_close()
    for r in got:
        r.pop("ts")
    assert got[:4] == got[4:]
    assert [(r["type"], r.get("status")) for r in got[:4]] == [
        ("request", None), ("response", 201), ("request", None),
        ("response", 201)]


def test_grpc_without_grpcio_raises_naming_the_package():
    model = TensorModel("m", _double)
    with mock.patch.dict(sys.modules, {"grpc": None}):
        with pytest.raises(ImportError, match="grpcio"):
            tgrpc.GrpcInferenceServer(model)
        with pytest.raises(ImportError, match="grpcio"):
            tgrpc.GrpcInferenceClient("127.0.0.1:1")
        with pytest.raises(ImportError, match="grpcio"):
            CompletionServer(model, grpc=True)
    with mock.patch.dict(sys.modules, {
            "kubeflow_tpu_torch.serving.protos.inference_pb2": None}):
        with pytest.raises(ImportError, match="protobuf"):
            tgrpc.GrpcInferenceServer(model)


def test_from_config_takes_the_predictor_keys(llm, tmp_path):
    """grpc, logger and batching as the JAX controller reads them off an
    InferenceService predictor: the V2 route and gRPC answer, both logged
    and batched, and stop() closes all of it."""
    _, jsrv, port = llm
    model = port.model
    log = str(tmp_path / "isvc.jsonl")
    server = CompletionServer.from_config(
        model._params, model._llama_config, dict(SERVING), device="cpu",
        model="isvc", grpc=True, logger={"path": log, "mode": "response"},
        batching={"maxBatchSize": 4, "maxLatencyMs": 1}).start()
    client = tgrpc.GrpcInferenceClient(server.grpc_address)
    try:
        inputs = {"prompt_tokens": np.array(PROMPTS[2], np.int64),
                  "max_new_tokens": np.array(3, np.int32)}
        got = client.infer("isvc", inputs)["output_tokens"]
        jc = jgrpc.GrpcInferenceClient(jsrv.address)
        try:
            np.testing.assert_array_equal(
                got, jc.infer("m", inputs)["output_tokens"])
        finally:
            jc.close()
        code, out = _post(f"{server.url}/v2/models/isvc/infer",
                          _v2_body(list(PROMPTS[2]), 3))
        assert code == 200 and out["outputs"][0]["data"] == got.tolist()
        assert set(server._batchers) == {"isvc"}
    finally:
        client.close()
        server.stop()
    assert [r["type"] for r in _records(log)] == ["response"]
    assert not server.grpc_server._started and not server.model.ready


def test_protocol_codec_matches_jax():
    """InferTensor/InferRequest/InferResponse of the port against the
    JAX codec: every datatype from JSON and back, as_dict, from_result
    of a dict, an array and a response, and the refusals."""
    from kubeflow_tpu.serving import protocol as jproto
    from kubeflow_tpu_torch.serving import protocol as tproto
    from kubeflow_tpu_torch.serving.llm_runtime import ProtocolError

    body = {"id": "q", "parameters": {"k": 1}, "inputs": [
        {"name": dt.lower(), "shape": [2, 1], "datatype": dt,
         "data": ["a", "b"] if dt == "BYTES" else
         [True, False] if dt == "BOOL" else [1, 2]}
        for dt in jproto._DTYPES]}
    t, j = (m.InferRequest.from_json("m", body) for m in (tproto, jproto))
    assert (t.id, t.parameters) == (j.id, j.parameters)
    for a, b in zip(t.inputs, j.inputs):
        assert a.to_json() == b.to_json() and a.data.dtype == b.data.dtype
    assert t.as_dict().keys() == j.as_dict().keys()
    for result in ({"y": np.arange(3, dtype=np.float16), "s": ["x"]},
                   np.ones((2, 2), np.uint8)):
        assert (tproto.InferResponse.from_result("m", result, id="q")
                .to_json() == jproto.InferResponse.from_result(
                    "m", result, id="q").to_json())
    resp = tproto.InferResponse("m", [], id="z")
    assert tproto.InferResponse.from_result("m", resp) is resp
    for bad in ({"inputs": [{"name": "x"}]}, {"inputs": "x"}, [],
                {"inputs": [{"name": "x", "shape": [2], "datatype": "BF16",
                             "data": [1, 2]}]}):
        with pytest.raises(ProtocolError):
            tproto.InferRequest.from_json("m", bad)
    with pytest.raises(ProtocolError):
        tproto.dtype_of(np.zeros(1, np.complex64))


def test_readiness_gates_on_a_failed_supervisor_on_both_dataplanes():
    """A model whose supervisor has used up its restarts makes the
    replica not ready on HTTP (/v2/health/ready 503) and on gRPC
    (ServerReady false), as on the JAX servers; live stays true."""
    from kubeflow_tpu.serving.protos import inference_pb2 as jpb

    def failed_metrics():
        return {"supervisor": {"permanent_failed": True}}

    jmodel = FunctionModel("f", _double)
    jmodel.metrics = failed_metrics
    repo = ModelRepository()
    repo.register(jmodel)
    tmodel = TensorModel("f", _double)
    tmodel.metrics = failed_metrics
    jhttp = ModelServer(repo).start()
    jsrv = jgrpc.GrpcInferenceServer(repo).start()
    port = CompletionServer(tmodel, grpc=True).start()
    jc = jgrpc.GrpcInferenceClient(jsrv.address)
    tc = tgrpc.GrpcInferenceClient(port.grpc_address)
    try:
        got = []
        for url, live, ready in (
                (jhttp.url, jc.server_live,
                 lambda: jc._ready(jpb.ServerReadyRequest(),
                                   timeout=10).ready),
                (port.url, tc.server_live, tc.server_ready)):
            got.append((_get(url + "/v2/health/ready"), live(),
                        ready()))
        assert got[0] == got[1] == ((503, {"ready": False}), True, False)
    finally:
        jc.close()
        tc.close()
        port.stop()
        jsrv.stop()
        jhttp.stop()
