"""Mixture-of-Experts routing and the expert MLP (counterpart of
kubeflow_tpu/ops/moe.py), in the GShard/Switch formulation the JAX
package uses:

  - static expert capacity C = int(T * top_k * capacity_factor / E),
    never below top_k; a token past an expert's capacity is dropped from
    that expert (its combine weight is 0);
  - dispatch and combine are [T, E, C] one-hot tensors contracted with
    einsums, not gathers, so the products are those of the JAX function;
  - the Switch load-balance loss over the first choice plus the router
    z-loss.

The JAX package computes the expert products with XLA einsums outside
any Pallas kernel; here they are torch.einsum (cuBLAS on the card).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    cap = int(tokens * top_k * capacity_factor / n_experts)
    return max(cap, top_k)   # never below top_k so tiny shapes route


def route(gate_logits: torch.Tensor, args: MoEArgs):
    """Top-k routing with static capacity: gate_logits [T, E] f32 ->
    (dispatch [T, E, C] f32 of 0/1, combine [T, E, C] f32, aux scalar).

    k rounds of argmax (the first index on ties, as jnp.argmax); a token's
    slot in its expert is the running count of that expert's tokens
    before it, this round's cumsum over tokens plus the `fill` of earlier
    rounds."""
    t, e = gate_logits.shape
    cap = expert_capacity(t, e, args.top_k, args.capacity_factor)
    probs = torch.softmax(gate_logits, dim=-1)
    dev = gate_logits.device
    remaining = probs
    dispatch = torch.zeros((t, e, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros((t, e, cap), dtype=torch.float32, device=dev)
    fill = torch.zeros((e,), dtype=torch.int64, device=dev)
    for _ in range(args.top_k):
        idx = remaining.argmax(dim=-1)                               # [T]
        gate = remaining.gather(1, idx[:, None])[:, 0]
        onehot = F.one_hot(idx, e)                                   # [T, E]
        remaining = remaining * (1.0 - onehot.float())
        pos_in_e = onehot.cumsum(dim=0) - 1 + fill[None, :]
        fill = fill + onehot.sum(dim=0)
        pos = (pos_in_e * onehot).sum(dim=-1)                         # [T]
        keep = pos < cap          # overflow dropped for this expert
        # jax.nn.one_hot of an index >= cap is all zeros; keep zeros it
        slot = F.one_hot(pos.clamp(max=cap - 1), cap).float() \
            * keep[:, None].float()
        d = onehot.float()[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
    # renormalize over the experts that kept the token
    denom = combine.sum(dim=(1, 2), keepdim=True).clamp_min(1e-9)
    combine = combine / denom
    # Switch: fraction routed to e by the first choice . mean prob of e
    f_e = F.one_hot(probs.argmax(dim=-1), e).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = args.aux_loss_coef * e * (f_e * p_e).sum()
    z = args.router_z_coef * (torch.logsumexp(gate_logits, dim=-1)
                              ** 2).mean()
    return dispatch, combine, aux + z


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, args: MoEArgs,
            dtype: torch.dtype = torch.bfloat16):
    """SwiGLU experts with top-k routing: x [B, S, D], router_w [D, E],
    w_gate/w_up [E, D, F], w_down [E, F, D] -> (out [B, S, D], aux)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    # bf16 @ f32 promotes to f32 in JAX
    gate_logits = xt.float() @ router_w.float()
    dispatch, combine, aux = route(gate_logits, args)
    dispatch = dispatch.to(dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    g = torch.einsum("ecd,edf->ecf", expert_in, w_gate.to(dtype))
    u = torch.einsum("ecd,edf->ecf", expert_in, w_up.to(dtype))
    h = F.silu(g) * u
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down.to(dtype))
    out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
    return out.reshape(b, s, d), aux
