"""Differentiable collectives over torch.distributed process groups: what
XLA inserts for the JAX package (`lax.all_gather(tiled=True)`, `lax.psum`,
`lax.ppermute`), written out for the port's one process per rank.

Gradients follow the rule that every rank calls backward on the same loss,
computed replicated downstream of the parallel region:
  * `all_reduce` sums the ranks' partials; its backward hands each rank
    the cotangent as it is (identity).
  * `copy_to_region` is the identity forward; its backward sums the ranks'
    cotangents: a replicated tensor that rank-local work consumes (the
    input of a column-parallel layer, the activations entering a pipeline,
    the tokens routed to a rank's experts) gets every rank's share.
  * `all_gather` concatenates along `dim` in rank order; its backward is the
    reduce-scatter (the ranks' cotangents summed, the rank's own chunk)
    where each rank consumes the gathered tensor differently (the keys and
    values of sequence parallelism), or the rank's own chunk of its
    cotangent where the consumer is replicated (`replicated=True`: the
    gathered logits).
  * `ppermute` sends to and receives from the ranks of `perm`; its
    backward runs the reverse permutation.
Ranks are those of `group` (group-local). At world size 1 each is the
identity and sends nothing. bf16 and f16 tensors travel widened to f32
(exact), so no backend reduces or stages a half type.
"""

import torch
import torch.distributed as dist

_HALF = (torch.bfloat16, torch.float16)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wide(x):
    return x.to(torch.float32) if x.dtype in _HALF else x


def _sum(x, group):
    y = _wide(x).contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gather(x, dim, group):
    w = _wide(x).contiguous()
    parts = [torch.empty_like(w) for _ in range(group_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def _chunk(x, dim, group):
    return x.chunk(group_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, replicated):
        ctx.dim, ctx.group, ctx.replicated = dim, group, replicated
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = _sum(g, ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None, None


def _send_recv(x, perm, group):
    """The rank's value from the source that `perm` maps onto it (zeros
    where none does), its own value sent to its destination. gloo's
    point-to-point transport reads host memory only: CUDA tensors stage
    through the host there."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    w = _wide(x).contiguous()
    if w.is_cuda and dist.get_backend(group) == "gloo":
        return _send_recv(w.cpu(), perm, group).to(x.device, x.dtype)
    out = torch.zeros_like(w)
    ops = [dist.P2POp(dist.isend, w, dist.get_global_rank(group, d), group) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group) for s in src]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(x.dtype)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _send_recv(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def all_reduce(x, group):
    """Sum of x over the ranks of `group` (backward: identity)."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def copy_to_region(x, group):
    """x itself (backward: the cotangents summed over `group`)."""
    if group_size(group) == 1:
        return x
    return _CopyToRegion.apply(x, group)


def all_gather(x, dim, group, replicated: bool = False):
    """The ranks' x concatenated along `dim` in rank order (jax's tiled
    all_gather). Backward: reduce-scatter, or with replicated=True the
    rank's own chunk of its cotangent."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, dim % x.ndim, group, replicated)


def ppermute(x, perm, group):
    """lax.ppermute: rank d receives the x of the rank s with (s, d) in
    `perm` (group-local ranks), zeros where no pair names it; backward:
    the reverse permutation. Integer tensors pass without a gradient."""
    if group_size(group) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    if not x.is_floating_point():
        return _send_recv(x, perm, group)
    return _PPermute.apply(x, list(perm), group)
