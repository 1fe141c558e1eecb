"""The serving model abstraction (the port's copy of kubeflow_tpu/
serving/model.py): `Model` with the kserve lifecycle (`load()` -> ready;
per request `preprocess -> predict -> postprocess`, optional `explain`),
`ModelRepository` (many named models: multi-model serving) and the
serving-runtime registry that maps a modelFormat to a loader.

Built-in runtimes: `python` (className "pkg.module:Class", built as
class(name, uri=..., **config)), `echo` and `mean` (diagnostic tensor
models), and, registered by their modules, `trainer` (`serving/
trainer_runtime.py` `TrainerCheckpointModel`) and `llama` (`serving/
llm_runtime.py` `LLMModel`); `load_model` imports those two modules when
their format is asked for. This module holds the port's one `ModelError`
(`llm_runtime` re-exports it).
"""

from __future__ import annotations

import importlib
import threading
import time
from typing import Any, Callable

import numpy as np

from kubeflow_tpu_torch.obs import metrics as obs_metrics


class ModelError(Exception):
    """A model the request named cannot serve it (HTTP 404)."""


class Model:
    """Subclass and override load/predict (and optionally pre/postprocess,
    explain). predict takes and returns protocol-level values (lists,
    dicts of numpy arrays); batchable models take stacked inputs."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False
        self.load_time: float | None = None

    def load(self) -> None:
        self.ready = True

    def _mark_ready(self) -> None:
        self.ready = True
        self.load_time = time.time()

    def preprocess(self, payload: Any) -> Any:
        return payload

    def predict(self, payload: Any) -> Any:
        raise NotImplementedError

    def postprocess(self, result: Any) -> Any:
        return result

    def explain(self, payload: Any) -> Any:
        raise ModelError(f"model {self.name!r} does not support explain")

    def unload(self) -> None:
        self.ready = False

    def input_spec(self) -> list[dict[str, Any]]:
        return []

    def output_spec(self) -> list[dict[str, Any]]:
        return []


class FunctionModel(Model):
    """A plain callable as a model (the custom-predictor shortcut)."""

    def __init__(self, name: str, fn: Callable[[Any], Any],
                 explainer: Callable[[Any], Any] | None = None):
        super().__init__(name)
        self.fn = fn
        self.explainer = explainer

    def load(self) -> None:
        self._mark_ready()

    def predict(self, payload: Any) -> Any:
        return self.fn(payload)

    def explain(self, payload: Any) -> Any:
        if self.explainer is None:
            return super().explain(payload)
        return self.explainer(payload)


class ModelRepository:
    """Named models with readiness (multi-model serving). A model is any
    object with the `Model` surface; `register` loads it unless it is
    ready."""

    def __init__(self):
        self._models: dict[str, Any] = {}
        self._lock = threading.RLock()

    def register(self, model, load: bool = True):
        with self._lock:
            self._models[model.name] = model
        if load and not model.ready:
            t0 = time.monotonic()
            model.load()
            if not model.ready:
                model._mark_ready()
            obs_metrics.MODEL_LOAD_SECONDS.observe(
                time.monotonic() - t0, model=model.name)
        obs_metrics.MODEL_READY.set(int(model.ready), model=model.name)
        return model

    def get(self, name: str):
        with self._lock:
            m = self._models.get(name)
        if m is None:
            raise ModelError(f"model {name!r} not found")
        return m

    def unload(self, name: str) -> None:
        with self._lock:
            m = self._models.pop(name, None)
        if m is not None:
            m.unload()
            obs_metrics.MODEL_READY.set(0, model=name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def ready(self, name: str) -> bool:
        try:
            return self.get(name).ready
        except ModelError:
            return False

    def permanently_failed(self) -> bool:
        """True when any model's supervisor has used up its restarts: the
        replica can never serve that model again and leaves rotation (the
        one gate /v2/health/ready and gRPC ServerReady consult)."""
        for name in self.names():
            try:
                mm = self.get(name).metrics() or {}
            except Exception:
                continue   # a model without metrics is not a verdict
            sup = mm.get("supervisor")
            if sup and bool(sup.get("permanent_failed", False)):
                return True
        return False


# -- serving runtimes ---------------------------------------------------------

_RUNTIMES: dict[str, Callable[..., Any]] = {}

#: runtimes registered by modules of their own, imported on first use
#: (importing them here would close an import cycle through agent.py)
_RUNTIME_MODULES = {
    "trainer": "kubeflow_tpu_torch.serving.trainer_runtime",
    "llama": "kubeflow_tpu_torch.serving.llm_runtime",
}


def serving_runtime(model_format: str):
    """Register a loader: (name, uri, **config) -> Model."""
    def deco(fn):
        _RUNTIMES[model_format] = fn
        return fn
    return deco


def load_model(model_format: str, name: str, uri: str | None = None,
               **config: Any):
    if model_format not in _RUNTIMES and model_format in _RUNTIME_MODULES:
        importlib.import_module(_RUNTIME_MODULES[model_format])
    if model_format not in _RUNTIMES:
        raise ModelError(
            f"no serving runtime for modelFormat {model_format!r}; "
            f"known: {sorted(set(_RUNTIMES) | set(_RUNTIME_MODULES))}")
    return _RUNTIMES[model_format](name, uri, **config)


@serving_runtime("python")
def _python_runtime(name: str, uri: str | None, *, className: str,
                    **config: Any):
    """className = "pkg.module:ClassName"; class(name, uri=..., **config)."""
    mod_name, _, cls_name = className.partition(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    return cls(name, uri=uri, **config)


@serving_runtime("echo")
def _echo_runtime(name: str, uri: str | None, **config: Any) -> Model:
    """Diagnostic runtime: answers its payload."""
    return FunctionModel(name, lambda payload: payload)


def unwrap_single_tensor(payload: Any) -> Any:
    """V2 requests arrive as {tensor_name: array}; a single-input model
    takes either dataplane by unwrapping a one-entry dict."""
    if isinstance(payload, dict) and len(payload) == 1:
        return next(iter(payload.values()))
    return payload


@serving_runtime("mean")
def _mean_runtime(name: str, uri: str | None, **config: Any) -> Model:
    """Tiny numeric runtime: the row-wise mean."""
    return FunctionModel(
        name, lambda x: np.asarray(unwrap_single_tensor(x),
                                   dtype=np.float64).mean(axis=-1))
