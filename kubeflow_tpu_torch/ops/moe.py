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

On a mesh (`regions`, the `sharding.Regions` of the trainer's mesh) the
routing is the global batch's, as GSPMD computes the JAX function over
the global arrays: the capacity counts T = B·S of every batch shard, a
token's slot is its place in the global [B, S] token order flattened
rows outer and columns inner (the data shards' rows as
PartitionSpec(("data", "fsdp")) lays them out, each row's `sequence`
blocks in rank order: each round's per-row, per-expert counts are
all-gathered and an exclusive prefix over the row blocks in that order
offsets this rank's rows, `Regions.tokens_before`), and the Switch and z
losses are means over every token (f_e and p_e summed over the shards
before their product). A rank of the `expert` axis holds E/X experts, and of the
`tensor` axis a column block of w_gate/w_up and a row block of w_down:
it builds dispatch and combine for its own experts only, and the
combine's partial output is all-reduced over `expert` and `tensor`. A
slot holds one token of one shard and the experts have no bias, so a
shard's partial [E, C, D] buffer gives its own slots' outputs with no
exchange across data shards. The router's gradient through the combine
is summed over `expert` and `tensor` (`copy_in` on the logits that feed
it); the aux and z terms, the same on every rank of those axes, count
once. Off a mesh `regions` is `sharding.NO_REGIONS`, whose operators are
the identity: one code path serves both.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.sharding import NO_REGIONS


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


def route(gate_logits: torch.Tensor, args: MoEArgs, regions=None,
          rows: int = 1):
    """Top-k routing with static capacity: gate_logits [T, E] f32 of
    `rows` rows of T / rows tokens each -> (dispatch [T, E, C] f32 of
    0/1, combine [T, E, C] f32, aux scalar).

    k rounds of argmax (the first index on ties, as jnp.argmax); a token's
    slot in its expert is the running count of that expert's tokens
    before it: this round's cumsum along its row, the tokens of earlier
    rounds (`fill`) and those of the row blocks before it in the global
    order (`regions`, NO_REGIONS by default: the module doc). The routing
    and the combine read the logits through `copy_in` over `expert` and
    `tensor`; the aux and z losses read them directly."""
    regions = NO_REGIONS if regions is None else regions
    t, e = gate_logits.shape
    n = t * regions.n_shards * regions.size("sequence")
    cap = expert_capacity(n, e, args.top_k, args.capacity_factor)
    probs = torch.softmax(gate_logits, dim=-1)
    dev = gate_logits.device
    routed = regions.copy_in(gate_logits, "expert", "tensor")
    remaining = (probs if routed is gate_logits
                 else torch.softmax(routed, dim=-1))
    dispatch = torch.zeros((t, e, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros((t, e, cap), dtype=torch.float32, device=dev)
    fill = torch.zeros((e,), dtype=torch.int64, device=dev)
    for _ in range(args.top_k):
        idx = remaining.argmax(dim=-1)                               # [T]
        gate = remaining.gather(1, idx[:, None])[:, 0]
        onehot = F.one_hot(idx, e)                                   # [T, E]
        remaining = remaining * (1.0 - onehot.float())
        by_row = onehot.reshape(rows, -1, e)
        before, total = regions.tokens_before(by_row.sum(dim=1))
        pos_in_e = (by_row.cumsum(dim=1) - 1 + before[:, None, :]
                    ).reshape(t, e) + fill[None, :]
        fill = fill + total
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
    # Switch: fraction routed to e by the first choice . mean prob of e,
    # both over the global batch's tokens
    first = F.one_hot(probs.argmax(dim=-1), e).float()
    f_e = regions.sum_batch(first.sum(dim=0)) / n
    p_e = regions.sum_batch(probs.sum(dim=0)) / n
    lse2 = torch.logsumexp(gate_logits, dim=-1) ** 2
    z = args.router_z_coef * (regions.sum_batch(lse2.sum()) / n)
    aux = args.aux_loss_coef * e * (f_e * p_e).sum()
    return dispatch, combine, aux + z


def experts_partial(xt: torch.Tensor, dispatch: torch.Tensor,
                    combine: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """The expert FFN of the experts and the mlp columns a rank holds:
    tokens xt [T, D], their dispatch and combine [T, E_r, C] for those
    experts, w_gate/w_up [E_r, D, F_r], w_down [E_r, F_r, D] -> the
    combined output [T, D] in dtype (the whole output when the blocks are
    whole, else this rank's partial sum)."""
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype), xt)
    g = torch.einsum("ecd,edf->ecf", expert_in, w_gate.to(dtype))
    u = torch.einsum("ecd,edf->ecf", expert_in, w_up.to(dtype))
    h = F.silu(g) * u
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down.to(dtype))
    return torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, args: MoEArgs,
            dtype: torch.dtype = torch.bfloat16, regions=None):
    """SwiGLU experts with top-k routing: x [B, S, D], router_w [D, E],
    w_gate/w_up [E, D, F], w_down [E, F, D] -> (out [B, S, D], aux).
    With `regions` the routing is the global batch's, and under an
    `expert` or `tensor` split the expert leaves are this rank's blocks
    [E/X, D, F/T] and [E/X, F/T, D] (module doc)."""
    regions = NO_REGIONS if regions is None else regions
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    # bf16 @ f32 promotes to f32 in JAX
    dispatch, combine, aux = route(xt.float() @ router_w.float(), args,
                                   regions, rows=b)
    e_r = w_gate.shape[0]
    mine = slice(regions.rank("expert") * e_r,
                 (regions.rank("expert") + 1) * e_r)
    part = experts_partial(regions.copy_in(xt, "expert", "tensor"),
                           dispatch[:, mine], combine[:, mine], w_gate,
                           w_up, w_down, dtype)
    out = regions.reduce_out(part.float(), "expert", "tensor").to(dtype)
    return out.reshape(b, s, d), aux
