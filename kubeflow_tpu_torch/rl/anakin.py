"""The Anakin learner on the card (the port's copy of
kubeflow_tpu/rl/anakin.py): a batched-env rollout fused with the PPO
update.

The JAX learner is one `jax.jit` program per update: a `lax.scan`
rollout of `rollout_len` steps over `n_envs` envs, GAE, advantage
normalisation and `ppo_epochs` clipped-surrogate passes through
`optax.chain(clip_by_global_norm, adam)`. Here the same update is one
CUDA graph on the card: the body (`_body`) is captured once, after a
warm-up on a side stream, and every update is a replay. Eager, an update
at the RLJob example's config would be thousands of tiny launches from
the host. On the CPU the body runs eager. A capture or a replay that
fails raises; nothing falls back to eager on the card.

What a graph needs, and how the body gives it:
- **Static state.** The learner owns the state's tensors (`state` as
  `init` makes it, or a copy of the one `step` is given); the body reads
  them by address and updates them in place, and the metrics it returns
  are the graph's static outputs. A returned state is the learner's own
  buffers, overwritten by the next update (clone it to keep it).
- **Randomness from counters.** JAX's threefry cannot be matched bit for
  bit, so every draw of a rollout comes from one function,
  `draws(update, t, seed) -> (gumbel [n, A], reset_u [n, R])`, by default
  a counter hash keyed by (seed, update, step, env, lane) (`_mix32`, the
  engine sampler's finalizer: the same bits on the CPU and the card).
  The update counter and the seed are device tensors, so a replay draws
  afresh. Actions are Gumbel-argmax, which is what
  `jax.random.categorical` computes; a CPU test replaces `draws` with the
  JAX package's own draws.
- **Adam with a device count.** The optimizer is the learner's own few
  lines (`_apply_updates`): optax's `clip_by_global_norm` then `adam`,
  with `count` an int32 device tensor and the bias corrections computed
  from it on the card. (The trainer's `Optimizer` computes them from a
  host-side count, which a graph captured once would freeze.)

- **The env batch over `data`.** With `mesh=` (a DeviceMesh of
  `parallel/mesh.py` whose other axes are 1) a rank steps its
  n_envs / D envs, the global envs [r·n/D, (r+1)·n/D), and its params
  and optimizer state are the replicated whole. The draws and the env
  resets are keyed by the global env index (an injected `draws` returns
  the global batch's rows and a rank takes its own), so the sharded
  learner's trajectories are the one-rank learner's. The advantages are
  normalised by the global batch's mean and std (the advantages
  all-gathered over `data`: [T, n] is small), the PPO terms are means
  over the global batch (each rank's mean times its share), the grads
  are all-reduced inside the update (on the card an NCCL all-reduce
  captured in the update's graph, on gloo eager), and `rollout_reward`,
  `episodes` and `last_mean_return` are the global batch's. The
  all-reduce runs at every data size, one rank included.

No Pallas kernel lies on this path: the JAX learner's products are
plain `@`, and here `torch.matmul`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.rl.config import REWARD_METRIC, AnakinConfig
from kubeflow_tpu_torch.rl.envs import make_env
from kubeflow_tpu_torch.serving.llm import _mix32, gc_paused

_M32 = (1 << 32) - 1
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8

# -- policy/value network (shared torso MLP) ---------------------------------


def net_shapes(obs_dim: int, hidden: tuple[int, ...],
               num_actions: int) -> dict[str, Any]:
    """The param tree's shapes: a tanh torso, a policy and a value head
    (the JAX `init_net` tree)."""
    torso, d_in = [], obs_dim
    for d_out in hidden:
        torso.append({"w": (d_in, d_out), "b": (d_out,)})
        d_in = d_out
    return {"torso": torso, "policy": {"w": (d_in, num_actions),
                                       "b": (num_actions,)},
            "value": {"w": (d_in, 1), "b": (1,)}}


def abstract_net(obs_dim: int, hidden: tuple[int, ...],
                 num_actions: int) -> dict[str, Any]:
    """The param tree on the meta device (for `interop.from_jax_tree`)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return torch.empty(node, device="meta")
    return walk(net_shapes(obs_dim, hidden, num_actions))


def init_net(gen: torch.Generator, obs_dim: int, hidden: tuple[int, ...],
             num_actions: int, device="cuda") -> dict[str, Any]:
    """The JAX init's distributions from a CPU generator (the same params
    on every device): torso and value weights N(0, 1/d_in), the policy
    head 0.01 N(0, 1) so the first policy is near uniform, zero biases."""
    dev = resolve_device(device)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    shapes = net_shapes(obs_dim, hidden, num_actions)
    torso = [{"w": normal(l["w"], (1.0 / l["w"][0]) ** 0.5),
              "b": torch.zeros(l["b"], device=dev)} for l in shapes["torso"]]
    d_in = shapes["value"]["w"][0]
    return {"torso": torso,
            "policy": {"w": normal(shapes["policy"]["w"], 0.01),
                       "b": torch.zeros(num_actions, device=dev)},
            "value": {"w": normal(shapes["value"]["w"], (1.0 / d_in) ** 0.5),
                      "b": torch.zeros(1, device=dev)}}


def net_leaves(params: dict[str, Any]) -> list[torch.Tensor]:
    """The param tree's tensors in a fixed order."""
    out = [t for layer in params["torso"] for t in (layer["w"], layer["b"])]
    return out + [params[h][k] for h in ("policy", "value")
                  for k in ("w", "b")]


def net_apply(params: dict[str, Any], obs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """obs [..., obs_dim] -> (logits [..., A], value [...])."""
    h = obs
    for layer in params["torso"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params["policy"]["w"] + params["policy"]["b"]
    value = (h @ params["value"]["w"] + params["value"]["b"])[..., 0]
    return logits, value


# -- pure math: GAE and the PPO/A2C surrogate --------------------------------


def gae_advantages(rewards: torch.Tensor, dones: torch.Tensor,
                   values: torch.Tensor, last_value: torch.Tensor,
                   gamma: float, lam: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation over the time axis: rewards,
    dones, values [T, ...], last_value [...] the bootstrap after the last
    step; `dones` masks the bootstrap and the recursion at episode
    boundaries. Returns (advantages, returns = advantages + values)."""
    nonterm = 1.0 - dones.to(rewards.dtype)
    values_next = torch.cat([values[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * values_next[t] * nonterm[t] - values[t]
        adv = delta + gamma * lam * nonterm[t] * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def ppo_loss(params: dict[str, Any], batch: dict[str, torch.Tensor], *,
             clip_eps: float | None, entropy_coef: float, value_coef: float,
             apply_fn: Callable = net_apply, share: float | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO objective (A2C when clip_eps is None).
    batch: obs [N, d], action [N], logp [N] (behavior log-probs),
    advantage [N], return [N]. `share`: this batch's fraction of a
    global batch split over ranks; each mean is scaled by it, so the
    ranks' terms sum to the global batch's."""
    def mean(x):
        return x.mean() if share is None else x.mean() * share
    logits, values = apply_fn(params, batch["obs"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["action"][..., None])[..., 0]
    entropy = -mean((logp_all.exp() * logp_all).sum(dim=-1))
    adv = batch["advantage"]
    if clip_eps is None:
        pg = -mean(logp * adv)
    else:
        ratio = torch.exp(logp - batch["logp"])
        pg = -mean(torch.minimum(
            ratio * adv,
            ratio.clamp(1.0 - clip_eps, 1.0 + clip_eps) * adv))
    v_loss = mean((values - batch["return"]) ** 2)
    loss = pg + value_coef * v_loss - entropy_coef * entropy
    return loss, {"pg_loss": pg, "value_loss": v_loss, "entropy": entropy}


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


# -- draws ---------------------------------------------------------------------


def hash_uniform(seed: torch.Tensor, update: torch.Tensor, t: int, n: int,
                 lanes: int, first: int = 0) -> torch.Tensor:
    """[n, lanes] f32 uniforms in [0, 1) keyed by (seed, update, step t,
    env, lane), from 23 hashed bits as `jax.random.uniform` makes its
    floats, for the envs [first, first + n); seed and update are int64
    device tensors (read in a graph)."""
    dev = update.device
    k = _mix32((seed * 0x9E3779B1 + 0x7F4A7C15) & _M32)
    k = _mix32((k ^ (update * 0x85EBCA77 & _M32)) & _M32)
    k = _mix32((k + (t * 0xC2B2AE3D & _M32)) & _M32)
    env = torch.arange(first, first + n, device=dev,
                       dtype=torch.int64)[:, None]
    lane = torch.arange(lanes, device=dev, dtype=torch.int64)[None]
    x = _mix32((k ^ (env * 0x27D4EB2F + lane * 0x165667B1)) & _M32)
    x = _mix32((x + env * lanes + lane) & _M32)
    return (x >> 9).to(torch.float32) * 2.0 ** -23


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1) as `jax.random.gumbel` makes
    it: -log(-log(u)) with u kept at or above the smallest normal f32."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log((u + tiny).clamp_min(tiny)))


# -- the fused learner --------------------------------------------------------


class AnakinLearner:
    """Batched-env rollout fused with the PPO update, one CUDA graph an
    update on the card (module doc). `init(seed)` builds the state;
    `step(state)` runs one rollout and update; `train(state, n)` loops,
    fetching metrics to the host only at the logging cadence."""

    def __init__(self, cfg: AnakinConfig, device="cuda",
                 draws: Callable | None = None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.env = make_env(cfg.env, **cfg.env_kwargs)
        self._draws = draws
        self.mesh = mesh
        # the data group's sums and gathers (`sharding.Regions`); the
        # identity off a mesh
        self._regions = sharding.NO_REGIONS
        self.n_local, self.first = cfg.n_envs, 0
        data = cfg.mesh.get("data", 1)
        if mesh is None and data not in (1, -1):
            raise ValueError(
                f"mesh data={data}: the env batch over data needs a process "
                "group and its mesh (runtime.initialize_distributed, "
                "AnakinLearner(mesh=make_mesh(cfg.mesh)))")
        if mesh is not None:
            from kubeflow_tpu_torch.parallel import mesh as mesh_lib

            shape = mesh_lib.mesh_shape(mesh)
            other = {a: n for a, n in shape.items() if a != "data" and n > 1}
            if other:
                raise ValueError(
                    f"the learner's mesh {shape}: only the data axis splits "
                    "the env batch" + (" (a sequence split is ROADMAP.md "
                                       "queue A6b-ii)"
                                       if "sequence" in other else ""))
            mesh_lib.validate_divisibility(mesh, batch=cfg.n_envs)
            d = shape["data"]
            self.n_local = cfg.n_envs // d
            self.first = mesh.get_coordinate()[
                mesh.mesh_dim_names.index("data")] * self.n_local
            # the group even at one rank: the update graph holds its
            # collectives at every data size
            self._regions = dataclasses.replace(
                sharding.regions(mesh),
                groups={"data": mesh.get_group("data")})
        self._state: dict[str, Any] | None = None
        self._graph = None
        self._out: dict[str, torch.Tensor] | None = None
        # Adam's decay rates as f32 tensors on the device, made here: a
        # capture cannot copy a host value to the card
        self._b1 = torch.tensor(_ADAM_B1, device=self.device)
        self._b2 = torch.tensor(_ADAM_B2, device=self.device)

    # -- state ----------------------------------------------------------------

    def init(self, seed: int | None = None) -> dict[str, Any]:
        cfg, dev = self.cfg, self.device
        seed = cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        params = init_net(gen, self.env.obs_dim, cfg.hidden,
                          self.env.num_actions, device=dev)
        for p in net_leaves(params):
            p.requires_grad_(True)
        seed_t = torch.tensor(seed, dtype=torch.int64, device=dev)
        u = hash_uniform(seed_t, torch.tensor(-1, device=dev), 0,
                         self.n_local, self.env.reset_draws, self.first)
        env_state, obs = self.env.reset(u)
        return {
            "params": params,
            "opt_state": {
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": [torch.zeros_like(p, requires_grad=False)
                       for p in net_leaves(params)],
                "nu": [torch.zeros_like(p, requires_grad=False)
                       for p in net_leaves(params)]},
            "env_state": env_state,
            "obs": obs,
            "ep_ret": torch.zeros(self.n_local, device=dev),
            "last_mean_return": torch.zeros((), device=dev),
            "seed": seed_t,
            "update": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def draws(self, update: torch.Tensor, t: int, seed: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(gumbel [n, A], reset uniforms [n, R]) of this rank's envs at
        step t of an update: the injected `draws`' rows of them, else the
        counter hash of the global env index."""
        if self._draws is not None:
            g, r = self._draws(update, t, seed)
            mine = slice(self.first, self.first + self.n_local)
            return g[mine], r[mine]
        a, r = self.env.num_actions, self.env.reset_draws
        u = hash_uniform(seed, update, t, self.n_local, a + r, self.first)
        return gumbel_of(u[:, :a]), u[:, a:]

    @staticmethod
    def _tensors(state: dict[str, Any]) -> list[torch.Tensor]:
        """Every tensor of a state, in a fixed order."""
        opt = state["opt_state"]
        return (net_leaves(state["params"]) + [opt["count"]] + opt["mu"]
                + opt["nu"] + list(state["env_state"])
                + [state[k] for k in ("obs", "ep_ret", "last_mean_return",
                                      "seed", "update")])

    def _adopt(self, state: dict[str, Any]) -> dict[str, Any]:
        """The learner's own state, holding `state`'s values."""
        if state is self._state:
            return state
        if self._state is None:
            own = {k: v for k, v in state.items()}
            own["params"] = _tree_map(
                lambda t: t.detach().clone().requires_grad_(True),
                state["params"])
            own["opt_state"] = _tree_map(lambda t: t.detach().clone(),
                                         state["opt_state"])
            own["env_state"] = type(state["env_state"])(
                *(t.clone() for t in state["env_state"]))
            for k in ("obs", "ep_ret", "last_mean_return", "seed",
                      "update"):
                own[k] = state[k].clone()
            self._state = own
            return own
        with torch.no_grad():
            for dst, src in zip(self._tensors(self._state),
                                self._tensors(state)):
                dst.copy_(src)
        return self._state

    # -- one fused rollout and update ------------------------------------------

    def _body(self) -> dict[str, torch.Tensor]:
        """One update on the learner's state, in place: the rollout, the
        bootstrap value, GAE, advantage normalisation and `ppo_epochs`
        passes of forward, backward, clip and Adam. Returns the metrics
        as 0-d tensors."""
        cfg, env, s = self.cfg, self.env, self._state
        params = s["params"]
        with torch.no_grad():
            env_state, obs, ep_ret = s["env_state"], s["obs"], s["ep_ret"]
            steps, completed = [], []
            for t in range(cfg.rollout_len):
                logits, value = net_apply(params, obs)
                gumbel, reset_u = self.draws(s["update"], t, s["seed"])
                action = (gumbel + logits).argmax(dim=-1)
                logp = F.log_softmax(logits, dim=-1).gather(
                    -1, action[..., None])[..., 0]
                env_state, next_obs, reward, done = env.step(
                    env_state, action, reset_u)
                ep_ret = ep_ret + reward
                completed.append(torch.where(done, ep_ret, 0.0))
                ep_ret = torch.where(done, 0.0, ep_ret)
                steps.append(Transition(obs, action, logp, value, reward,
                                        done))
                obs = next_obs
            traj = Transition(*(torch.stack(x) for x in zip(*steps)))
            _, last_value = net_apply(params, obs)
            adv, returns = gae_advantages(traj.reward, traj.done, traj.value,
                                          last_value, cfg.gamma,
                                          cfg.gae_lambda)
            # every rank's envs in global env order: [T, n_envs]
            every = self._regions.gather_shards(adv).permute(
                1, 0, 2).reshape(adv.shape[0], -1)
            adv = (adv - every.mean()) / (every.std(correction=0) + 1e-8)
            flat = {"obs": traj.obs.reshape(-1, env.obs_dim),
                    "action": traj.action.reshape(-1),
                    "logp": traj.logp.reshape(-1),
                    "advantage": adv.reshape(-1),
                    "return": returns.reshape(-1)}
        leaves = net_leaves(params)
        share = None if self.mesh is None else self.n_local / cfg.n_envs
        for _ in range(cfg.ppo_epochs):
            loss, aux = ppo_loss(params, flat, clip_eps=cfg.clip_eps,
                                 entropy_coef=cfg.entropy_coef,
                                 value_coef=cfg.value_coef, share=share)
            grads = list(torch.autograd.grad(loss, leaves))
            if self.mesh is not None:   # the global batch's gradient
                with torch.no_grad():
                    flat_g = self._regions.sum_batch(torch.cat(
                        [g.reshape(-1) for g in grads]))
                    grads = [x.view_as(g) for x, g in zip(
                        flat_g.split([g.numel() for g in grads]), grads)]
            self._apply_updates(leaves, grads, s["opt_state"])
        with torch.no_grad():
            reward = traj.reward.mean()
            vec = torch.stack([
                torch.stack(completed).sum(),
                traj.done.sum().to(torch.float32),
                reward if share is None else reward * share,
                loss.detach(), aux["entropy"].detach(),
                aux["pg_loss"].detach(), aux["value_loss"].detach()])
            (done_ret, n_done, reward, loss_v, entropy, pg,
             v_loss) = self._regions.sum_batch(vec).unbind()
            n_done = n_done.to(torch.int64)
            mean_ret = torch.where(n_done > 0,
                                   done_ret / n_done.clamp_min(1),
                                   s["last_mean_return"])
            metrics = {
                REWARD_METRIC: mean_ret,
                "rollout_reward": reward,
                "episodes": n_done,
                "loss": loss_v,
                "entropy": entropy,
                "pg_loss": pg,
                "value_loss": v_loss}
            for dst, src in zip(s["env_state"], env_state):
                dst.copy_(src)
            s["obs"].copy_(obs)
            s["ep_ret"].copy_(ep_ret)
            s["last_mean_return"].copy_(mean_ret)
            s["update"].add_(1)
        return metrics

    @torch.no_grad()
    def _apply_updates(self, params: list[torch.Tensor],
                       grads: list[torch.Tensor], opt: dict[str, Any]
                       ) -> None:
        """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr)) in
        place, with the step count an int32 device tensor (a graph replay
        computes each update's bias corrections afresh)."""
        cfg = self.cfg
        if cfg.max_grad_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < cfg.max_grad_norm
            grads = [torch.where(keep, g, g / norm * cfg.max_grad_norm)
                     for g in grads]
        count = opt["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(self._b1, c)
        bc2 = 1 - torch.pow(self._b2, c)
        for p, g, mu, nu in zip(params, grads, opt["mu"], opt["nu"]):
            mu.copy_((1 - _ADAM_B1) * g + _ADAM_B1 * mu)
            nu.copy_((1 - _ADAM_B2) * (g * g) + _ADAM_B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS)
            p.add_(-cfg.learning_rate * u)
        opt["count"].copy_(count)

    # -- the graph ---------------------------------------------------------------

    def _capture(self) -> None:
        """Capture `_body` as a CUDA graph over the learner's state. The
        body runs once first on a side stream (first-use work must not
        happen in a capture) and the state it changed is put back."""
        saved = [t.detach().clone() for t in self._tensors(self._state)]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._body()
        current.wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self._tensors(self._state), saved):
                t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(graph):
            out = self._body()
        self._graph, self._out = graph, out

    def step(self, state: dict[str, Any]
             ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        """One rollout and update from `state`; returns the learner's state
        and the metrics (0-d device tensors; on the card the graph's
        outputs, overwritten by the next update)."""
        self._adopt(state)
        if self.device.type != "cuda":
            return self._state, self._body()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        return self._state, self._out

    def eager_step(self, state: dict[str, Any]
                   ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
        """The update's body run eager on the learner's state (what a
        replay runs; for comparing the two on the card)."""
        self._adopt(state)
        return self._state, self._body()

    # -- loops --------------------------------------------------------------------

    def train(self, state: dict[str, Any], num_updates: int, *,
              log_every: int = 10,
              callback: Callable[[int, dict[str, float]], None] | None = None,
              should_stop: Callable[[], bool] | None = None
              ) -> tuple[dict[str, Any], list[dict[str, float]]]:
        """`num_updates` updates; metrics reach the host only at the
        logging cadence. `should_stop` is consulted before every update
        (the pod's cancellation hook)."""
        history: list[dict[str, float]] = []
        for u in range(1, num_updates + 1):
            if should_stop is not None and should_stop():
                break
            state, metrics = self.step(state)
            if u % log_every == 0 or u == num_updates:
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["update"] = u
                history.append(scalars)
                if callback is not None:
                    callback(u, scalars)
        return state, history

    def env_steps_per_update(self) -> int:
        """The global batch's env steps an update (every rank's)."""
        return self.cfg.n_envs * self.cfg.rollout_len

    def measure_steps_per_s(self, state: dict[str, Any], *,
                            iters: int = 10, warmup: int = 2
                            ) -> tuple[dict[str, Any], float]:
        """Sustained env-steps/s of the update (synced by a metric fetch)."""
        if iters < 1:
            raise ValueError("iters must be >= 1")
        for _ in range(warmup):
            state, _ = self.step(state)
        float(state["update"])
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = self.step(state)
        float(metrics["loss"])
        dt = (time.perf_counter() - t0) / iters
        return state, self.env_steps_per_update() / dt


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)
