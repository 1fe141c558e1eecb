"""The Open Inference Protocol over gRPC (counterpart of kubeflow_tpu/
serving/grpc_server.py): `GrpcInferenceServer` serves the port's
`ModelRepository` (or one model, as a repository of one) beside the HTTP
server, routing by model name; `GrpcInferenceClient` calls it.

    inference.GRPCInferenceService/ServerLive | ServerReady | ModelReady
        | ModelMetadata | ModelInfer

ModelInfer decodes typed `InferTensorContents` into the tensor dict the
V2 REST route makes (`serving/protocol.py`), runs the model's predict
(through a `DynamicBatcher` of its own when `batching` names the model,
the HTTP server's config shape) and answers its outputs: an unknown model is
NOT_FOUND, a malformed tensor or `raw_input_contents` INVALID_ARGUMENT,
a model not ready UNAVAILABLE. The service is registered by hand with
`grpc.method_handlers_generic_handler` over the protoc-generated
messages in `serving/protos/inference_pb2.py`, as in the JAX package.

`grpcio` and `protobuf` are imported only when a server or client is
made: without them that raises an ImportError naming the package, and
the rest of the port does not need them.
"""

from __future__ import annotations

import importlib
import threading
from concurrent import futures
from typing import Any

import numpy as np

from kubeflow_tpu_torch.serving.batching import DynamicBatcher
from kubeflow_tpu_torch.serving.model import ModelError, ModelRepository
from kubeflow_tpu_torch.serving.protocol import (_DTYPES, InferRequest,
                                                 InferResponse, InferTensor,
                                                 ProtocolError)

SERVICE = "inference.GRPCInferenceService"

# OIP datatype -> its InferTensorContents field
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents", "INT16": "int_contents", "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents", "UINT16": "uint_contents",
    "UINT32": "uint_contents", "UINT64": "uint64_contents",
    "FP16": "fp32_contents",   # FP16 rides the fp32 field (the OIP spec)
    "FP32": "fp32_contents", "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}


def _grpc_modules():
    """(grpc, inference_pb2), or an ImportError naming what is missing:
    the gRPC dataplane is never dropped silently."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC dataplane needs the grpcio package, which is not "
            "installed") from e
    try:
        pb = importlib.import_module(
            "kubeflow_tpu_torch.serving.protos.inference_pb2")
    except ImportError as e:
        raise ImportError(
            "the gRPC dataplane needs the protobuf package, which is not "
            "installed") from e
    return grpc, pb


def _tensor_from_pb(t) -> InferTensor:
    dt = t.datatype
    if dt not in _CONTENTS_FIELD:
        raise ProtocolError(f"unknown datatype {dt!r}")
    values = list(getattr(t.contents, _CONTENTS_FIELD[dt]))
    shape = tuple(t.shape)
    try:
        if dt == "BYTES":
            arr = np.array(values, dtype=object).reshape(shape)
        else:
            arr = np.array(values, dtype=_DTYPES[dt]).reshape(shape)
    except ValueError as e:
        raise ProtocolError(
            f"tensor {t.name!r}: {len(values)} values do not fit shape "
            f"{list(shape)} ({e})") from e
    return InferTensor(name=t.name, data=arr, datatype=dt)


def _tensor_to_pb(out, t: InferTensor) -> None:
    out.name = t.name
    out.datatype = t.datatype
    out.shape.extend(int(d) for d in np.asarray(t.data).shape)
    field = _CONTENTS_FIELD.get(t.datatype)
    if field is None:
        raise ProtocolError(f"unknown datatype {t.datatype!r}")
    flat = np.asarray(t.data).reshape(-1)
    if t.datatype == "BYTES":
        getattr(out.contents, field).extend(
            v if isinstance(v, bytes) else str(v).encode() for v in flat)
    elif t.datatype == "BOOL":
        getattr(out.contents, field).extend(bool(v) for v in flat)
    elif t.datatype in ("FP16", "FP32", "FP64"):
        getattr(out.contents, field).extend(float(v) for v in flat)
    else:
        getattr(out.contents, field).extend(int(v) for v in flat)


class GrpcInferenceServer:
    """The OIP gRPC server over a ModelRepository (a model alone is served
    as a repository of one). `batching` is the HTTP server's {model name:
    {maxBatchSize, maxLatencyMs}}."""

    def __init__(self, repository, port: int = 0, host: str = "127.0.0.1",
                 max_workers: int = 8,
                 batching: dict[str, Any] | None = None):
        grpc, pb = _grpc_modules()
        self._grpc, self._pb = grpc, pb
        if not isinstance(repository, ModelRepository):
            model, repository = repository, ModelRepository()
            repository.register(model, load=False)
        self.repository = repository
        self._batch_cfg = batching or {}
        self._batchers: dict[str, DynamicBatcher] = {}
        self._batch_lock = threading.Lock()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        handlers = {
            "ServerLive": self._unary(self._server_live,
                                      pb.ServerLiveRequest,
                                      pb.ServerLiveResponse),
            "ServerReady": self._unary(self._server_ready,
                                       pb.ServerReadyRequest,
                                       pb.ServerReadyResponse),
            "ModelReady": self._unary(self._model_ready,
                                      pb.ModelReadyRequest,
                                      pb.ModelReadyResponse),
            "ModelMetadata": self._unary(self._model_metadata,
                                         pb.ModelMetadataRequest,
                                         pb.ModelMetadataResponse),
            "ModelInfer": self._unary(self._model_infer,
                                      pb.ModelInferRequest,
                                      pb.ModelInferResponse),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self._started = False

    def _unary(self, fn, req_cls, resp_cls):
        return self._grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "GrpcInferenceServer":
        self._server.start()
        self._started = True
        return self

    def stop(self, grace: float = 0.5) -> None:
        if self._started:
            self._server.stop(grace).wait()
            self._started = False
        with self._batch_lock:
            for b in self._batchers.values():
                b.stop()
            self._batchers.clear()

    # -- the RPCs --------------------------------------------------------------

    def _server_live(self, request, context):
        return self._pb.ServerLiveResponse(live=True)

    def _server_ready(self, request, context):
        # the HTTP /v2/health/ready gate: a supervisor out of restarts
        # makes the replica not ready for good
        from kubeflow_tpu_torch.serving.server import ready_models

        return self._pb.ServerReadyResponse(
            ready=ready_models(self.repository))

    def _model_ready(self, request, context):
        return self._pb.ModelReadyResponse(
            ready=self.repository.ready(request.name))

    def _get(self, name: str):
        return self.repository.get(name)

    def _predictor(self, model):
        """The model's predict, through its batcher when `batching` names
        it (made at the model's first request)."""
        cfg = self._batch_cfg.get(model.name)
        if not cfg:
            return model.predict
        with self._batch_lock:
            if model.name not in self._batchers:
                self._batchers[model.name] = DynamicBatcher.from_config(
                    model.predict, cfg)
            return self._batchers[model.name]

    def _model_metadata(self, request, context):
        try:
            model = self._get(request.name)
        except ModelError as e:
            context.abort(self._grpc.StatusCode.NOT_FOUND, str(e))
        resp = self._pb.ModelMetadataResponse(name=model.name,
                                              platform="pytorch-cuda")
        for spec, field in ((model.input_spec(), resp.inputs),
                            (model.output_spec(), resp.outputs)):
            for s in spec:
                tm = field.add()
                tm.name = s.get("name", "")
                tm.datatype = s.get("datatype", "")
                tm.shape.extend(int(d) for d in s.get("shape", []))
        return resp

    def _model_infer(self, request, context):
        status = self._grpc.StatusCode
        try:
            if request.raw_input_contents:
                context.abort(
                    status.INVALID_ARGUMENT,
                    "raw_input_contents not supported; send typed "
                    "InferTensorContents")
            model = self._get(request.model_name)
            if not model.ready:
                context.abort(status.UNAVAILABLE,
                              f"model {request.model_name!r} not ready")
            req = InferRequest(
                model_name=request.model_name,
                inputs=[_tensor_from_pb(t) for t in request.inputs],
                id=request.id)
            payload = model.preprocess(req.as_dict())
            result = model.postprocess(self._predictor(model)(payload))
            out = InferResponse.from_result(request.model_name, result,
                                            id=request.id)
            resp = self._pb.ModelInferResponse(model_name=out.model_name,
                                               id=out.id)
            for t in out.outputs:
                _tensor_to_pb(resp.outputs.add(), t)
            return resp
        except ModelError as e:
            context.abort(status.NOT_FOUND, str(e))
        except ProtocolError as e:
            context.abort(status.INVALID_ARGUMENT, str(e))


class GrpcInferenceClient:
    """A small OIP gRPC client (the kserve InferenceGRPCClient analog)."""

    def __init__(self, address: str, timeout: float = 30.0):
        grpc, pb = _grpc_modules()
        self._pb = pb
        self._channel = grpc.insecure_channel(address)
        self.timeout = timeout

        def method(name, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        self._live = method("ServerLive", pb.ServerLiveRequest,
                            pb.ServerLiveResponse)
        self._ready = method("ServerReady", pb.ServerReadyRequest,
                             pb.ServerReadyResponse)
        self._model_ready = method("ModelReady", pb.ModelReadyRequest,
                                   pb.ModelReadyResponse)
        self._metadata = method("ModelMetadata", pb.ModelMetadataRequest,
                                pb.ModelMetadataResponse)
        self._infer = method("ModelInfer", pb.ModelInferRequest,
                             pb.ModelInferResponse)

    def server_live(self) -> bool:
        return self._live(self._pb.ServerLiveRequest(),
                          timeout=self.timeout).live

    def server_ready(self) -> bool:
        return self._ready(self._pb.ServerReadyRequest(),
                           timeout=self.timeout).ready

    def model_ready(self, name: str) -> bool:
        return self._model_ready(self._pb.ModelReadyRequest(name=name),
                                 timeout=self.timeout).ready

    def model_metadata(self, name: str):
        return self._metadata(self._pb.ModelMetadataRequest(name=name),
                              timeout=self.timeout)

    def infer(self, model_name: str,
              inputs: dict[str, np.ndarray] | list[InferTensor],
              id: str = "") -> dict[str, np.ndarray]:
        if isinstance(inputs, dict):
            inputs = [InferTensor(name=k, data=np.asarray(v))
                      for k, v in inputs.items()]
        req = self._pb.ModelInferRequest(model_name=model_name, id=id)
        for t in inputs:
            _tensor_to_pb(req.inputs.add(), t)
        resp = self._infer(req, timeout=self.timeout)
        return {t.name: _tensor_from_pb(t).data for t in resp.outputs}

    def close(self) -> None:
        self._channel.close()
