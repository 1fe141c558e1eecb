"""Batched RL environments as tensors on a device (the port's copy of
kubeflow_tpu/rl/envs.py): the env batch lives on the card beside the
policy, so a rollout is device work with no host round trip per step,
and a whole update can be one CUDA graph (`rl/anakin.py`).

Conventions (the JAX envs', batched over the leading axis):

- An env is a frozen dataclass of physics and shape constants (the JAX
  fields, so `config.ENV_KWARGS` names both); the dynamic state is a
  NamedTuple of tensors with a leading batch axis.
- `reset(u) -> (state, obs)` and `step(state, action, u) -> (state, obs,
  reward, done)` run the whole batch. The reset noise enters as
  uniform draws in [0, 1) that the caller passes in, `u` [n,
  reset_draws], scaled as `jax.random.uniform` scales its floats, so a
  test can feed both packages the same numbers.
- Auto-reset: where a step ends an episode the returned state and obs
  are already the next episode's reset (from this step's `u`), the
  terminal reward is kept and `done` marks the boundary.

The physics is f32 in the JAX order of operations (Python constants
folded in f64 first, as JAX folds them before they meet an f32 array).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, NamedTuple

import torch


class CartPoleState(NamedTuple):
    x: torch.Tensor          # cart position [n] f32
    x_dot: torch.Tensor
    theta: torch.Tensor      # pole angle (rad)
    theta_dot: torch.Tensor
    t: torch.Tensor          # steps into the episode [n] int32


def _f32(x: float) -> float:
    """`x` rounded to f32 (and back to a Python float, exactly)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _select(done: torch.Tensor, a: NamedTuple, b: NamedTuple) -> Any:
    """Field by field: `a` where done, else `b` (rows on the batch axis)."""
    return type(a)(*(torch.where(done.view(-1, *[1] * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


@dataclasses.dataclass(frozen=True)
class CartPole:
    """Cart-pole (Barto-Sutton-Anderson physics, the standard constants):
    an episode ends when the pole falls past 12 degrees, the cart leaves
    +-2.4, or `max_steps` elapse; reward 1 a step."""

    gravity: float = 9.8
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_half_length: float = 0.5
    force_mag: float = 10.0
    tau: float = 0.02               # integration step (s)
    theta_limit: float = 12 * 2 * math.pi / 360
    x_limit: float = 2.4
    max_steps: int = 200
    reset_scale: float = 0.05       # uniform(-s, s) initial state

    num_actions: ClassVar[int] = 2
    obs_dim: ClassVar[int] = 4
    reset_draws: ClassVar[int] = 4

    def reset(self, u: torch.Tensor) -> tuple[CartPoleState, torch.Tensor]:
        # f32 bounds and their f32 difference, as JAX scales its floats
        lo, hi = _f32(-self.reset_scale), _f32(self.reset_scale)
        v = (u * _f32(hi - lo) + lo).clamp_min(lo)
        state = CartPoleState(v[:, 0], v[:, 1], v[:, 2], v[:, 3],
                              torch.zeros(u.shape[0], dtype=torch.int32,
                                          device=u.device))
        return state, self._obs(state)

    def _obs(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def step(self, state: CartPoleState, action: torch.Tensor,
             u: torch.Tensor):
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        total_mass = self.cart_mass + self.pole_mass
        ml = self.pole_mass * self.pole_half_length
        cos, sin = torch.cos(state.theta), torch.sin(state.theta)
        tmp = (force + ml * state.theta_dot ** 2 * sin) / total_mass
        theta_acc = (self.gravity * sin - cos * tmp) / (
            self.pole_half_length
            * (4.0 / 3.0 - self.pole_mass * cos ** 2 / total_mass))
        x_acc = tmp - ml * theta_acc * cos / total_mass
        nxt = CartPoleState(
            x=state.x + self.tau * state.x_dot,
            x_dot=state.x_dot + self.tau * x_acc,
            theta=state.theta + self.tau * state.theta_dot,
            theta_dot=state.theta_dot + self.tau * theta_acc,
            t=state.t + 1)
        done = ((nxt.x.abs() > self.x_limit)
                | (nxt.theta.abs() > self.theta_limit)
                | (nxt.t >= self.max_steps))
        reward = torch.ones_like(state.x)
        fresh, fresh_obs = self.reset(u)
        obs = torch.where(done[:, None], fresh_obs, self._obs(nxt))
        return _select(done, fresh, nxt), obs, reward, done


class GridWorldState(NamedTuple):
    xy: torch.Tensor         # [n, 2] int32 (col, row)
    t: torch.Tensor          # [n] int32 step counter


@dataclasses.dataclass(frozen=True)
class GridWorld:
    """N x N grid: start at (0, 0), goal at (N-1, N-1); actions
    right/down/left/up (walls clip); -step_cost a step, +goal_reward at
    the goal; an episode ends at the goal or after `max_steps`."""

    size: int = 5
    max_steps: int = 40
    step_cost: float = 0.01
    goal_reward: float = 1.0

    num_actions: ClassVar[int] = 4
    obs_dim: ClassVar[int] = 2
    reset_draws: ClassVar[int] = 0   # a fixed start: the task is stationary

    def reset(self, u: torch.Tensor) -> tuple[GridWorldState, torch.Tensor]:
        n, dev = u.shape[0], u.device
        state = GridWorldState(torch.zeros(n, 2, dtype=torch.int32,
                                           device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev))
        return state, self._obs(state)

    def _obs(self, s: GridWorldState) -> torch.Tensor:
        return s.xy.float() / max(self.size - 1, 1)

    def step(self, state: GridWorldState, action: torch.Tensor,
             u: torch.Tensor):
        # moves right/down/left/up, without a host-made table (a graph
        # capture cannot copy one to the card)
        move = torch.stack([(action == 0).int() - (action == 2).int(),
                            (action == 1).int() - (action == 3).int()], -1)
        xy = (state.xy + move).clamp(0, self.size - 1)
        at_goal = (xy == self.size - 1).all(dim=-1)
        t = state.t + 1
        done = at_goal | (t >= self.max_steps)
        reward = torch.where(at_goal, self.goal_reward, -self.step_cost)
        fresh, fresh_obs = self.reset(u)
        nxt = GridWorldState(xy, t)
        obs = torch.where(done[:, None], fresh_obs, self._obs(nxt))
        return _select(done, fresh, nxt), obs, reward, done


ENVS: dict[str, type] = {"cartpole": CartPole, "gridworld": GridWorld}


def make_env(name: str, **kwargs: Any):
    """Instantiate a registered env."""
    if name not in ENVS:
        raise ValueError(f"unknown env {name!r}; registered: {sorted(ENVS)}")
    return ENVS[name](**kwargs)
