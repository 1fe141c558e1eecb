"""Trainer-checkpoint serving (counterpart of
kubeflow_tpu/serving/trainer_runtime.py `TrainerCheckpointModel`): any
registered model family served straight from the port trainer's
`checkpoint_dir`. The port's repository builds it through the
`trainer` runtime (`load_model("trainer", name, uri, model=...)`, as a
`MultiModelAgent` pull does), and the JAX package's `ModelServer` through
its `python` runtime, as it builds `LLMModel`:

    predictor:
      model:
        modelFormat: python
        storageUri: /path/to/checkpoint_dir      # a Trainer checkpoint_dir
        config:
          className: kubeflow_tpu_torch.serving.trainer_runtime:TrainerCheckpointModel
          model: resnet                          # registry name
          model_overrides: {...}
          output: logits | argmax                # default logits
          device: cuda                           # the default

V1 payload: {"instances": [<input array>, ...]}, the model's natural
input (NHWC images for the vision families, token ids for the language
models); V2: one input tensor. `load()` restores only the `params`
subtree of the newest checkpoint, into the family's `abstract` tree on
the device (`training/checkpoint.py` `restore_params`; no optimizer
state), or makes random params from `seed` without a checkpoint;
`unload()` drops them, so an evicted model's memory goes back to the
card's allocator. The class is the port's `serving/model.py` `Model`,
which has the JAX `Model`'s methods (the port imports nothing of it).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.serving.model import (Model, ModelError,
                                              serving_runtime)


class TrainerCheckpointModel(Model):
    def __init__(self, name: str, uri: str | None = None, *,
                 model: str, model_overrides: dict[str, Any] | None = None,
                 checkpoint: str | None = None, output: str = "logits",
                 seed: int = 0, device="cuda", **_ignored: Any):
        super().__init__(name)
        if output not in ("logits", "argmax"):
            raise ModelError(f"output {output!r} invalid (logits|argmax)")
        self._model_name = model
        self._overrides = dict(model_overrides or {})
        self._checkpoint = checkpoint or uri
        self._output = output
        self._seed = seed
        self._dev = resolve_device(device)
        self.params = None
        self.cfg = None
        self._apply = None

    def load(self) -> None:
        from kubeflow_tpu_torch.training.checkpoint import restore_params

        dev = self._dev
        mdef = registry.get(self._model_name)
        self.cfg = mdef.config_cls(**self._overrides)
        if self._checkpoint:
            try:
                self.params = restore_params(self._checkpoint,
                                             mdef.abstract(self.cfg),
                                             device=dev)
            except FileNotFoundError as e:
                raise ModelError(str(e)) from e
        else:
            self.params = mdef.init(self.cfg, seed=self._seed, device=dev)
        self._apply = mdef.apply
        self._mark_ready()

    def unload(self) -> None:
        self.params = None
        self.ready = False

    def predict(self, payload: Any) -> np.ndarray:
        """The family's apply on the payload's array: f32 logits, or
        their argmax over the last axis."""
        if isinstance(payload, dict):   # V2: one named tensor
            if len(payload) != 1:
                raise ModelError(
                    "trainer runtime expects one input tensor "
                    f"(got {sorted(payload)})")
            payload = next(iter(payload.values()))
        x = np.asarray(payload)
        if x.dtype == np.float64:   # JAX takes JSON floats as f32
            x = x.astype(np.float32)
        with torch.no_grad():
            out = self._apply(self.params, torch.as_tensor(x).to(self._dev),
                              self.cfg)
        out = out.float().cpu().numpy()
        if self._output == "argmax":
            return np.argmax(out, axis=-1)
        return out


@serving_runtime("trainer")
def _trainer_runtime(name: str, uri: str | None = None, **config: Any):
    return TrainerCheckpointModel(name, uri, **config)
