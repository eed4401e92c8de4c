"""Mixture-of-Experts FFN with expert parallelism over an 'expert' mesh dim
(counterpart of ssak_tpu.parallel.moe).

The same function as ssak_tpu's GShard layer: a gate in f32, top-k experts
per token (ties toward the lower index), the chosen gates renormalised, a
static capacity C = ceil(cf * S * k / E / 8) * 8 per expert, slots filled
per choice k with a running count per expert and tokens in S order (so the
same tokens are kept and dropped), expert FFNs with products in f32 rounded
to `dtype`, and the load-balancing loss E * sum(mean gate prob * dispatch
fraction).

Routing goes by indices, not by ssak_tpu's (S, E, C) one-hot dispatch and
combine einsums (its TPU idiom, "scatter-free routing"), which grow as S²:
each kept (token, choice) owns one (e, c) slot, so `index_copy` into (E, C,
D) dispatches exactly, and a weighted `index_add` combines, the k terms of
a token summed in f32 and rounded once. The expert FFNs are two batched
`torch.bmm` over (E, C, .), which ssak_tpu computes as einsums outside any
Pallas kernel. The one-hot form stays in tests/test_torch_parallel.py as
the witness that both compute the same function.

Expert parallelism: each rank of the MoE's `ep` group holds E / ep experts
(parallel.mesh.shard_params with WAV2VEC2_MOE_RULES); every rank routes
all of its tokens, runs its own experts on their slots, and the f32
partial outputs are summed over the group before the one rounding.

Data parallelism: ssak_tpu routes the global batch in one program, so
under a 'data' mesh axis the capacity, the fill order and the loss's
means are those of all the data ranks' tokens together (`data_group`).
Each rank takes its slots from the per-expert counts of the ranks
before it (tokens in global S order are the ranks' in rank order), and
dispatches only its own tokens.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ssak_tpu_torch.parallel.collectives import all_reduce, copy_to_region, group_size
from ssak_tpu_torch.parallel.sharding import P


class MoE(nn.Module):
    """gate: a Linear (E, D) without bias; w1 (E, D, F), b1 (E, F), w2
    (E, F, D), b2 (E, D) in ssak_tpu's expert-stacked layout. `ep`: the
    expert-parallel process group once sharded (None: all experts here).
    `last_route`: the last call's (experts (S, k), kept (S, k) bool), the
    routing read by checks and the dropped-token share."""

    def __init__(self, gate, w1, b1, w2, b2):
        super().__init__()
        self.gate = gate
        self.w1, self.b1, self.w2, self.b2 = (nn.Parameter(t, requires_grad=False) for t in (w1, b1, w2, b2))
        self.ep = None
        self.last_route = None

    @property
    def num_experts(self) -> int:
        return self.gate.weight.shape[0]


def moe_init(gen, d_model: int, d_ff: int, num_experts: int, scale=None) -> MoE:
    """ssak_tpu's initializers on a torch.Generator: gate and w1 N(0,
    1/d_model), w2 N(0, 1/d_ff) (std `scale` when given), zero biases."""
    from ssak_tpu_torch.models import layers as L

    s1 = scale if scale is not None else d_model**-0.5
    s2 = scale if scale is not None else d_ff**-0.5
    gate = L.Linear(L._normal(gen, (d_model, num_experts), s1).t().contiguous())
    return MoE(gate, L._normal(gen, (num_experts, d_model, d_ff), s1), torch.zeros(num_experts, d_ff),
               L._normal(gen, (num_experts, d_ff, d_model), s2), torch.zeros(num_experts, d_model))


# sharding rules for expert-stacked leaves: leading E dim on 'expert'
MOE_RULES = [
    (r"/moe/(w1|b1|w2|b2)$", "expert_leading"),
]


def moe_partition_spec(path: str, leaf):
    """PartitionSpec of an MoE leaf: expert-stacked tensors shard their
    leading dim on 'expert'; the gate is replicated."""
    import re

    shape = tuple(getattr(leaf, "shape", leaf))
    for pattern, _ in MOE_RULES:
        if re.search(pattern, path):
            return P("expert", *([None] * (len(shape) - 1)))
    return P()


def capacity(n_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(cf * S * k / E / 8) * 8."""
    return int(np.ceil(capacity_factor * n_tokens * top_k / num_experts / 8.0)) * 8


def route(probs, top_k: int, C: int, data_group=None):
    """Top-k routing of (S, E) gate probabilities with capacity C ->
    (topv (S, k) renormalised, topi (S, k), pos (S, k) slot within the
    expert, keep (S, k) bool): for each choice k in turn, a running count
    per expert over the tokens in S order, those of the ranks of
    data_group before this one first."""
    S, E = probs.shape
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(E, dtype=torch.int64, device=probs.device)
    pos, keep = [], []
    for k in range(top_k):
        onehot = F.one_hot(topi[:, k], E)
        before, total = _rank_offsets(onehot.sum(0), data_group)
        within = torch.cumsum(onehot, dim=0) - onehot + (counts + before)[None, :]
        p = (within * onehot).sum(-1)
        pos.append(p)
        keep.append(p < C)
        counts = torch.clamp(counts + total, max=C)  # slots taken, as the kept tokens of every rank count them
    return topv, topi, torch.stack(pos, 1), torch.stack(keep, 1)


def _rank_offsets(n, group):
    """(sum of the per-expert counts `n` of the ranks of `group` before
    this one, their sum over all of them)."""
    if group_size(group) == 1:
        return torch.zeros_like(n), n
    parts = [torch.empty_like(n) for _ in range(group_size(group))]
    torch.distributed.all_gather(parts, n.contiguous(), group=group)
    rank = torch.distributed.get_rank(group)
    return sum(parts[:rank], torch.zeros_like(n)), sum(parts)


def gelu_tanh(x):
    """jax.nn.gelu (approximate=True) op by op, each rounded to x's dtype
    as jax rounds it: x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x³))) with
    the constants in x's dtype. (F.gelu's tanh form rounds once: half its
    bf16 outputs then differ from jax's by a step.)"""

    def c(v):
        return torch.tensor(v, dtype=torch.float32).to(x.dtype).to(x.device)

    inner = c(float(np.float32(np.sqrt(2 / np.pi)))) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def moe_mlp(x, p: MoE, *, top_k: int = 2, capacity_factor: float = 1.25, dtype=torch.bfloat16, data_group=None):
    """x: (B, T, D) -> (y (B, T, D) in `dtype`, aux_loss f32 scalar), the
    experts' activation jax.nn.gelu's (gelu_tanh). data_group: the
    data-parallel ranks whose x (equal shapes, rank order) make the global
    batch that ssak_tpu routes: capacity, fill order and the aux loss are
    the global batch's, and the aux loss, the same on every rank, passes
    each rank the gradient of its own tokens' share times the group's size
    (the data-parallel step averages the ranks' gradients)."""
    B, T, D = x.shape
    S = B * T
    S_all = S * group_size(data_group)
    E = p.num_experts
    top_k = min(top_k, E)
    C = capacity(S_all, E, top_k, capacity_factor)
    xs = x.reshape(S, D)
    logits = torch.matmul(xs.to(torch.float32), p.gate.weight.to(torch.float32).t())
    probs = torch.softmax(logits, dim=-1)
    topv, topi, pos, keep = route(probs, top_k, C, data_group)
    keep = keep & (topv > 0)  # ssak_tpu dispatches where the combine weight is > 0

    ep = p.ep
    E_local = p.w1.shape[0]
    e0 = torch.distributed.get_rank(ep) * E_local if group_size(ep) > 1 else 0
    local = keep & (topi >= e0) & (topi < e0 + E_local)
    tok = torch.arange(S, device=x.device)[:, None].expand(S, top_k)[local]
    slot = ((topi - e0) * C + pos)[local]
    xe = torch.zeros(E_local * C, D, dtype=dtype, device=x.device)
    xe = xe.index_copy(0, slot, copy_to_region(xs, ep).index_select(0, tok).to(dtype))
    xe = xe.view(E_local, C, D)
    h = gelu_tanh(_bmm_f32(xe, p.w1, dtype).to(dtype) + p.b1.to(dtype)[:, None])
    ye = (_bmm_f32(h, p.w2, dtype).to(dtype) + p.b2.to(dtype)[:, None]).view(E_local * C, D)
    w = copy_to_region(topv.to(dtype).to(torch.float32), ep)[local]
    y = torch.zeros(S, D, dtype=torch.float32, device=x.device).index_add(
        0, tok, w[:, None] * ye.index_select(0, slot).to(torch.float32))
    y = all_reduce(y, ep)
    # the means over the global batch: all_reduce sums the ranks' shares, copy_to_region sums the ranks'
    # cotangents in the backward (every data rank's loss holds the same aux)
    me = all_reduce(copy_to_region(probs.sum(0), data_group), data_group) / S_all
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add(
        0, topi[keep], torch.ones_like(topi[keep], dtype=torch.float32))
    ce = all_reduce(ce, data_group) / S_all
    aux = (me * ce).sum() * E
    p.last_route = (topi.detach(), keep.detach())
    return y.to(dtype).reshape(B, T, D), aux


def _bmm_f32(a, w, dtype):
    """(E, C, K) @ (E, K, N) with the operands rounded to `dtype`, the
    products summed in f32 (ssak_tpu's preferred_element_type=f32)."""
    from ssak_tpu_torch.models.layers import _HALF

    w = w.to(dtype)
    if dtype not in _HALF:
        return torch.bmm(a, w)
    if a.is_cuda:
        return _HalfBmm.apply(a, w)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


class _HalfBmm(torch.autograd.Function):
    """torch.bmm with an f32 result from half operands, with a backward in
    the operands' dtype (layers._HalfMatmul's, batched)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gw
