"""RL learner configuration (the port's copy of kubeflow_tpu/rl/config.py):
`AnakinConfig`, the env kwargs map and `parse_rl_config`, accepting and
rejecting exactly what the JAX copy does, with the same messages (the JAX
`RLJobController.validate` admits an RLJob's KTPU_RL_CONFIG before the
port ever sees it). One difference: `mesh` must be a mesh the port runs:
known axes, `data` at any size (the env batch over the process group's
ranks, `anakin.AnakinLearner(mesh=)`), every other axis 1 or -1
(`_device.check_one_card_mesh`)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from kubeflow_tpu_torch._device import check_one_card_mesh


@dataclasses.dataclass
class AnakinConfig:
    """One fused on-device learner: `n_envs` batched envs stepped
    `rollout_len` times, fused with the PPO update into one program (a
    CUDA graph on the card). `clip_eps=None` is A2C: the plain
    policy-gradient surrogate with a single pass (`ppo_epochs` forced
    to 1)."""

    env: str = "cartpole"
    env_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    n_envs: int = 64
    rollout_len: int = 16
    hidden: tuple[int, ...] = (64, 64)
    learning_rate: float = 3e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float | None = 0.2    # None => A2C
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    ppo_epochs: int = 2
    max_grad_norm: float | None = 0.5
    mesh: dict[str, int] = dataclasses.field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        self.hidden = tuple(int(h) for h in self.hidden)
        if self.clip_eps is None:
            self.ppo_epochs = 1
        for fname in ("n_envs", "rollout_len", "ppo_epochs"):
            if getattr(self, fname) < 1:
                raise ValueError(f"{fname} must be >= 1")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be > 0")
        if not 0.0 < self.gamma <= 1.0 or not 0.0 <= self.gae_lambda <= 1.0:
            raise ValueError("need 0 < gamma <= 1 and 0 <= gae_lambda <= 1")
        if self.env not in ENV_KWARGS:
            raise ValueError(f"unknown env {self.env!r}; "
                             f"registered: {sorted(ENV_KWARGS)}")
        bad = set(self.env_kwargs) - ENV_KWARGS[self.env]
        if bad:
            raise ValueError(
                f"unknown env_kwargs for {self.env!r}: {sorted(bad)}")
        for k, lo in ENV_KWARG_MIN.items():
            if k in self.env_kwargs and self.env_kwargs[k] < lo:
                raise ValueError(f"env_kwargs.{k} must be >= {lo}")
        # the env batch runs over data; the params are replicated
        seq = self.mesh.get("sequence", 1)
        if seq not in (1, -1):
            raise ValueError(
                f"mesh axis sequence={seq}: the RL learner splits no "
                "sequence (ROADMAP.md queue A6b-ii, sequence parallelism "
                "outside the Llama family)")
        check_one_card_mesh({k: v for k, v in self.mesh.items()
                             if k != "data"})

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["hidden"] = list(self.hidden)
        return d


#: env name -> allowed env_kwargs (the fields of the envs.py dataclasses;
#: tests/test_torch_rl_envs.py holds both against the JAX map)
ENV_KWARGS: dict[str, frozenset[str]] = {
    "cartpole": frozenset({
        "gravity", "cart_mass", "pole_mass", "pole_half_length",
        "force_mag", "tau", "theta_limit", "x_limit", "max_steps",
        "reset_scale"}),
    "gridworld": frozenset({"size", "max_steps", "step_cost",
                            "goal_reward"}),
}

#: structural floors for env_kwargs values: below these the task is
#: degenerate (a 1x1 gridworld starts on the goal; max_steps=0 never ends)
ENV_KWARG_MIN: dict[str, float] = {"size": 2, "max_steps": 1,
                                   "tau": 1e-6}

#: the metrics the learner emits every logged update (Katib's objective)
REWARD_METRIC = "mean_episode_return"
LEARNER_METRICS = (REWARD_METRIC, "rollout_reward", "loss", "entropy",
                   "episodes")

_KNOWN = {f.name for f in dataclasses.fields(AnakinConfig)}


def parse_rl_config(raw: str | dict[str, Any]
                    ) -> tuple[AnakinConfig, int, int]:
    """KTPU_RL_CONFIG -> (AnakinConfig, num_updates, log_every). Raises
    ValueError on unknown keys and bad values."""
    d = dict(json.loads(raw)) if isinstance(raw, str) else dict(raw)
    num_updates = int(d.pop("num_updates", 100))
    log_every = int(d.pop("log_every", 10))
    if num_updates < 1 or log_every < 1:
        raise ValueError("num_updates and log_every must be >= 1")
    unknown = set(d) - _KNOWN
    if unknown:
        raise ValueError(f"unknown rl config keys: {sorted(unknown)}")
    return AnakinConfig(**d), num_updates, log_every
