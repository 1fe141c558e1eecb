"""The V2 / Open Inference Protocol tensor codec (the port's copy of what
the V2 `infer` route and the gRPC server need from kubeflow_tpu/serving/
protocol.py):

    POST /v2/models/<m>/infer
    {"id"?, "inputs": [{"name", "shape", "datatype", "data"}, ...]}
    -> {"model_name", "id", "outputs": [{"name", "shape", "datatype",
        "data"}, ...]}

Tensors are numpy arrays. The same codec feeds the REST route and the
gRPC server (`serving/grpc_server.py`); `v1_encode` makes the V1
`predict` answer. A malformed request raises the
`ProtocolError` of `serving/llm_runtime.py`, the one type the server
answers with a 400.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from kubeflow_tpu_torch.serving.llm_runtime import ProtocolError

_DTYPES = {
    "BOOL": np.bool_, "UINT8": np.uint8, "UINT16": np.uint16,
    "UINT32": np.uint32, "UINT64": np.uint64, "INT8": np.int8,
    "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
    "BYTES": object,
}
_NP_TO_DTYPE = {np.dtype(v).name: k for k, v in _DTYPES.items()
                if v is not object}


def dtype_of(arr: np.ndarray) -> str:
    """The OIP datatype of a numpy array (BYTES for objects and
    strings)."""
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        return "BYTES"
    name = arr.dtype.name
    if name not in _NP_TO_DTYPE:
        raise ProtocolError(f"unsupported numpy dtype {name}")
    return _NP_TO_DTYPE[name]


@dataclass
class InferTensor:
    name: str
    data: np.ndarray
    datatype: str = ""
    parameters: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.datatype:
            self.datatype = dtype_of(self.data)

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "InferTensor":
        for key in ("name", "shape", "datatype", "data"):
            if key not in obj:
                raise ProtocolError(f"tensor missing {key!r}")
        dt = obj["datatype"]
        if dt not in _DTYPES:
            raise ProtocolError(f"unknown datatype {dt!r}")
        np_dt = _DTYPES[dt]
        arr = np.asarray(obj["data"],
                         dtype=np_dt if np_dt is not object else None)
        try:
            arr = arr.reshape(obj["shape"])
        except ValueError as e:
            raise ProtocolError(f"tensor {obj['name']}: {e}") from e
        return cls(name=obj["name"], data=arr, datatype=dt,
                   parameters=obj.get("parameters", {}))

    def to_json(self) -> dict[str, Any]:
        return {"name": self.name, "shape": list(self.data.shape),
                "datatype": self.datatype,
                "data": self.data.ravel().tolist(),
                **({"parameters": self.parameters} if self.parameters
                   else {})}


@dataclass
class InferRequest:
    model_name: str
    inputs: list[InferTensor]
    id: str = ""
    parameters: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_json(cls, model_name: str, obj: dict[str, Any]
                  ) -> "InferRequest":
        if not isinstance(obj, dict) or not isinstance(obj.get("inputs"),
                                                       list):
            raise ProtocolError("request missing inputs list")
        return cls(model_name=model_name,
                   inputs=[InferTensor.from_json(t) for t in obj["inputs"]],
                   id=obj.get("id", ""),
                   parameters=obj.get("parameters", {}))

    def as_dict(self) -> dict[str, np.ndarray]:
        """The tensors by name: the payload a model's predict takes."""
        return {t.name: t.data for t in self.inputs}


@dataclass
class InferResponse:
    model_name: str
    outputs: list[InferTensor]
    id: str = ""
    parameters: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_result(cls, model_name: str, result: Any,
                    id: str = "") -> "InferResponse":
        """A predict() result as a response: a dict of tensors, one
        array (named output0), or a response already."""
        if isinstance(result, InferResponse):
            return result
        if isinstance(result, dict):
            outs = [InferTensor(name=k, data=np.asarray(v))
                    for k, v in result.items()]
        else:
            outs = [InferTensor(name="output0", data=np.asarray(result))]
        return cls(model_name=model_name, outputs=outs, id=id)

    def to_json(self) -> dict[str, Any]:
        return {"model_name": self.model_name, "id": self.id,
                "outputs": [t.to_json() for t in self.outputs],
                **({"parameters": self.parameters} if self.parameters
                   else {})}


def v1_encode(result: Any) -> dict[str, Any]:
    """A predict() result as a V1 answer: {"predictions": ...}, numpy
    arrays (alone or as a dict's values) as lists."""
    if isinstance(result, np.ndarray):
        result = result.tolist()
    elif isinstance(result, dict):
        result = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in result.items()}
    return {"predictions": result}
