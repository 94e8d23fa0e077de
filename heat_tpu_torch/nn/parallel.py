"""Tensor, pipeline and expert parallelism over a MeshGrid (heat_tpu
``nn/parallel.py``).

Per-rank functions that compose into the combined dp x pp x tp x sp (x ep)
training step of :mod:`heat_tpu_torch.nn.transformer`. Each takes the
communicator of its grid axis (``grid.axis("tp")``, ...) where heat_tpu
takes the axis name, and is differentiable through the autograd pairs of
:mod:`heat_tpu_torch.core.communication`, written as heat_tpu's JAX
transposes are:

* Tensor parallel (Megatron): a column-parallel product takes its
  replicated input through :func:`~heat_tpu_torch.core.communication.copy_to`
  (no collective forward, one all-reduce of the cotangent backward); a
  row-parallel product ends in one all-reduce
  (:func:`~heat_tpu_torch.core.communication.psum`, none backward). A block
  costs one all-reduce forward and one backward.
* Expert parallel (Switch, top 1): GShard dispatch and combine with the
  static capacity ``ceil(T * cf / E)``; overflow tokens fall through the
  residual. One all-to-all each way, the inverse one each way backward.
* Pipeline (GPipe): ``n_micro + pp - 1`` ticks; the stage outputs travel to
  the next stage by one ``permute`` round a tick, the last stage's outputs
  are broadcast to every stage. The backward runs the ticks in reverse with
  the cotangents travelling the other way, every rank posting its messages
  in the same order, so no rank waits on another at ``n_micro < pp`` either.

heat_tpu computes all of this outside Pallas; the plain torch form here is
the implementation, as heat_tpu's ``jnp`` form is.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.communication import all_gather, all_to_all, copy_to, psum
from ..core.tree import tree_flatten

__all__ = [
    "column_parallel_dense",
    "row_parallel_dense",
    "tp_mlp",
    "tp_attention_qkv",
    "tp_attention_out",
    "switch_moe",
    "moe_capacity",
    "pipeline_apply",
]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def column_parallel_dense(x, w_shard, b_shard=None, *, axis=None, gather_output: bool = False):
    """``y = x @ W`` with ``W`` column-sharded over the tp communicator
    ``axis`` (heat_tpu ``parallel.py:56``): ``x`` is replicated over tp and
    enters through ``copy_to`` (its cotangent is summed over tp backward),
    the output is feature-sharded. ``gather_output`` all-gathers it along
    the last axis for replicated work (each rank's cotangent its own
    columns). Without ``axis`` the caller owns ``x``'s cotangent."""
    if axis is not None:
        x = copy_to(x, axis)
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    if gather_output:
        if axis is None:
            raise ValueError("gather_output=True needs the tp axis")
        y = all_gather(y, axis, axis=-1)
    return y


def row_parallel_dense(x_shard, w_shard, b=None, *, axis):
    """``y = psum_tp(x_shard @ W_shard)`` with ``W`` row-sharded over tp
    (heat_tpu ``parallel.py:74``): the block's one all-reduce; the
    replicated bias is added after it."""
    y = psum(x_shard @ w_shard, axis)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x, w_up_shard, w_down_shard, *, axis, activation: Callable = _gelu,
           b_up_shard=None, b_down=None):
    """The tensor-parallel MLP (heat_tpu ``parallel.py:87``): column-parallel
    up-projection, the activation on the shard, row-parallel down-projection
    (one all-reduce)."""
    h = column_parallel_dense(x, w_up_shard, b_up_shard, axis=axis)
    return row_parallel_dense(activation(h), w_down_shard, b_down, axis=axis)


def tp_attention_qkv(x, wqkv_shard, n_heads_shard: int, *, axis=None):
    """The QKV projection with heads sharded over tp (heat_tpu
    ``parallel.py:95``): ``wqkv_shard`` is ``(D, 3 * H_shard * Dh)``;
    returns ``(q, k, v)``, each ``(..., S, H_shard, Dh)``. With ``axis``,
    ``x`` enters through ``copy_to``."""
    if axis is not None:
        x = copy_to(x, axis)
    q, k, v = torch.chunk(x @ wqkv_shard, 3, dim=-1)
    Dh = q.shape[-1] // n_heads_shard

    def heads(t):
        return t.reshape(*t.shape[:-1], n_heads_shard, Dh)

    return heads(q), heads(k), heads(v)


def tp_attention_out(attn_shard, wproj_shard, *, axis):
    """The output projection of tp-sharded attention (heat_tpu
    ``parallel.py:112``): flatten the local heads, row-parallel product,
    one all-reduce."""
    flat = attn_shard.reshape(*attn_shard.shape[:-2], -1)
    return row_parallel_dense(flat, wproj_shard, axis=axis)


def moe_capacity(tokens_local: int, n_experts: int, capacity_factor: float) -> int:
    """The static buffer per (source rank, expert) (heat_tpu
    ``parallel.py:123``)."""
    return max(1, int(math.ceil(tokens_local * capacity_factor / n_experts)))


def _route(x, router_w, E: int, C: int):
    """Top-1 routing (heat_tpu ``parallel.py:151-162``): the softmax's
    argmax per token, its probability as the gate, the token's slot in its
    expert from a running count, and the slots past ``C`` dropped. Returns the
    ``(T, E, C)`` dispatch and combine tensors, one-hot rows of the kept
    tokens' (expert, slot) as heat_tpu's, and the kept mask ``(T,)``.

    The count runs in integers along each expert's row (heat_tpu's cumsum
    runs in the compute dtype down the token axis: the same values in
    float32, in bfloat16 exact only below 256 tokens an expert), and the
    dispatch tensor is written by one scatter of the kept flags rather
    than built from one-hot rows."""
    probs = torch.softmax(x @ router_w, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]
    T = x.shape[0]
    rows = F.one_hot(expert_idx, E).t().to(torch.int32)           # (E, T)
    slot = rows.cumsum(dim=1).gather(0, expert_idx[None])[0] - 1  # (T,)
    kept = slot < C
    # each token writes its own row: 1 at (expert, slot) if kept, else a 0
    col = expert_idx * C + slot.clamp(max=C - 1)
    dispatch = torch.zeros((T, E * C), dtype=x.dtype, device=x.device)
    dispatch.scatter_(1, col[:, None], kept.to(x.dtype)[:, None])
    dispatch = dispatch.view(T, E, C)
    return dispatch, dispatch * gate[:, None, None], kept


def switch_moe(x, router_w, expert_up_shard, expert_down_shard, *, axis,
               capacity_factor: float = 1.25, activation: Callable = _gelu, tp_axis=None):
    """Top-1 (Switch) mixture of experts with the experts sharded over the
    communicator ``axis`` (heat_tpu ``parallel.py:128``).

    ``x``: ``(T, D)`` local tokens (batch x sequence flattened); ``router_w``:
    ``(D, E)`` replicated, ``E = ep * E_local``; ``expert_up_shard``:
    ``(E_local, D, F)``, ``expert_down_shard``: ``(E_local, F, D)``, this
    rank's experts. GShard dispatch and combine with the static capacity
    ``C = ceil(T * capacity_factor / E)`` per (source rank, expert);
    overflow tokens get a zero output (they fall through the caller's
    residual). One all-to-all each way. ``tp_axis``: the communicator the
    experts' hidden dimension is sharded over; the expert inputs and the
    combine weights enter the tp-sharded work by ``copy_to`` (one
    all-reduce each backward), and the caller sums the partial outputs over
    it (the transformer's ``_psum_tp``)."""
    T, D = x.shape
    E_local = expert_up_shard.shape[0]
    ep = axis.size
    E = ep * E_local
    C = moe_capacity(T, E, capacity_factor)
    dispatch, combine, _ = _route(x, router_w, E, C)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x).reshape(ep, E_local, C, D)
    expert_in = all_to_all(expert_in, axis, 0, 0)  # (ep_src, E_local, C, D)
    if tp_axis is not None:
        expert_in = copy_to(expert_in, tp_axis)
    h = activation(torch.einsum("secd,edf->secf", expert_in, expert_up_shard))
    expert_out = torch.einsum("secf,efd->secd", h, expert_down_shard)
    expert_out = all_to_all(expert_out, axis, 0, 0).reshape(E, C, D)
    if tp_axis is not None:
        # the outputs are partial sums over tp: the gates' cotangents too
        combine = copy_to(combine, tp_axis)
    return torch.einsum("tec,ecd->td", combine, expert_out)


# --------------------------------------------------------------------- #
# GPipe pipeline parallelism                                            #
# --------------------------------------------------------------------- #

def _check_stage_dtype(y, x):
    if y.dtype != x.dtype:
        raise TypeError(
            f"pipeline stage changed activation dtype {x.dtype} -> {y.dtype}; keep compute "
            "dtype uniform across stages (cast params inside the stage, not activations "
            "between stages)")


def _rounds(pp: int, n_micro: int, t: int, reverse: bool):
    """The stage boundaries a microbatch crosses after tick ``t``: forward
    ``(j, j + 1)`` where stage ``j`` ran a microbatch at ``t``; reverse
    ``(j + 1, j)`` where stage ``j + 1`` did."""
    if reverse:
        return [(j + 1, j) for j in range(pp - 1) if 0 <= t - (j + 1) < n_micro]
    return [(j, j + 1) for j in range(pp - 1) if 0 <= t - j < n_micro]


def _gpipe_forward(comm, stage_fn, unflatten, x_micro, leaves, record: bool):
    """The forward ticks. With ``record``, every microbatch's graph of this
    stage is kept, from aliases of the parameters and of its input, for
    :class:`_Pipeline`'s backward."""
    pp, s = comm.size, comm.rank
    n_micro = x_micro.shape[0]
    T = n_micro + pp - 1
    alias = [p.detach().requires_grad_(p.requires_grad) for p in leaves] if record else leaves
    params = unflatten(alias)
    graphs = {}
    outs = [None] * n_micro
    recv = None
    for t in range(T):
        m = t - s
        y = None
        if 0 <= m < n_micro:
            x_in = x_micro[m] if s == 0 else recv
            if record:
                x_in = x_in.detach().requires_grad_(True)
            with torch.set_grad_enabled(record):
                y = stage_fn(params, x_in)
            _check_stage_dtype(y, x_in)
            if record:
                graphs[m] = (x_in, y)
            if s == pp - 1:
                outs[m] = y.detach()
        if t < T - 1:
            send = x_micro[0] if y is None else y.detach()
            recv = comm.Permute(send.contiguous(), _rounds(pp, n_micro, t, False),
                                x_micro.shape[1:])
    out = torch.stack(outs) if s == pp - 1 else torch.empty_like(x_micro)
    return comm.Bcast(out, pp - 1), graphs, alias


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule on a pp communicator as one autograd node: the
    forward runs the ticks, keeping each microbatch's graph of this
    stage; the backward runs them in reverse, one microbatch's graph at a
    time, sending each input cotangent to the previous stage."""

    @staticmethod
    def forward(ctx, comm, stage_fn, unflatten, x_micro, *leaves):
        out, graphs, alias = _gpipe_forward(comm, stage_fn, unflatten, x_micro, leaves, True)
        ctx.comm, ctx.graphs, ctx.alias = comm, graphs, alias
        ctx.n_micro, ctx.x_shape = x_micro.shape[0], x_micro.shape
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        comm, graphs, alias = ctx.comm, ctx.graphs, ctx.alias
        pp, s, n_micro = comm.size, comm.rank, ctx.n_micro
        T = n_micro + pp - 1
        wants = [a for a in alias if a.requires_grad]
        pgrads = [None] * len(wants)
        dx = torch.zeros(ctx.x_shape, dtype=dout.dtype, device=dout.device)
        recv = None
        for t in reversed(range(T)):
            m = t - s
            g_in = None
            if 0 <= m < n_micro:
                x_in, y = graphs.pop(m)
                dy = dout[m] if s == pp - 1 else recv
                got = torch.autograd.grad(y, [x_in] + wants, dy, allow_unused=True)
                g_in = got[0] if got[0] is not None else torch.zeros_like(x_in)
                for i, g in enumerate(got[1:]):
                    if g is not None:
                        pgrads[i] = g if pgrads[i] is None else pgrads[i] + g
                if s == 0:
                    dx[m] = g_in
            if t > 0:
                send = dx[0] if g_in is None else g_in
                recv = comm.Permute(send.contiguous(), _rounds(pp, n_micro, t, True),
                                    ctx.x_shape[1:])
        # the input is replicated over pp and read by stage 0 alone: every
        # stage gets stage 0's cotangent (heat_tpu's psum of the masked ones)
        dx = comm.Bcast(dx, 0)
        it = iter(pgrads)
        leaf_grads = [next(it) if a.requires_grad else None for a in alias]
        return (None, None, None, dx) + tuple(leaf_grads)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, *, axis):
    """Run the ``pp`` pipeline stages over microbatches (heat_tpu
    ``parallel.py:199``).

    ``stage_fn(params, x) -> y``: one stage, keeping the activation's shape
    and dtype; ``stage_params``: this rank's stage parameters (a tree of
    tensors); ``x_micro``: ``(n_micro, mb, ...)``, replicated over the pp
    communicator ``axis``. Returns ``(n_micro, mb, ...)``, the last stage's
    outputs on every stage.

    GPipe schedule: ``T = n_micro + pp - 1`` ticks; at tick ``t`` stage
    ``s`` runs microbatch ``t - s`` when there is one (stage 0 reads
    ``x_micro``, a later stage what the previous one sent), then one
    ``permute`` round sends the outputs on: ``T - 1`` rounds, then one
    broadcast from the last stage. The backward mirrors it: ``T - 1``
    reverse rounds and one broadcast of stage 0's input cotangent, which
    every stage returns, as the cotangent of a replicated input is.
    Differentiating a loss computed alike on every stage counts it once:
    only the last stage's cotangent enters the pipeline (heat_tpu's masked
    ``psum`` and its transpose). At pp = 1 the stage runs per microbatch.
    """
    pp = axis.size
    if pp == 1:
        outs = []
        for m in range(x_micro.shape[0]):
            y = stage_fn(stage_params, x_micro[m])
            _check_stage_dtype(y, x_micro)
            outs.append(y)
        return torch.stack(outs)
    leaves, unflatten = tree_flatten(stage_params)
    if torch.is_grad_enabled() and (x_micro.requires_grad or any(p.requires_grad
                                                                 for p in leaves)):
        return _Pipeline.apply(axis, stage_fn, unflatten, x_micro, *leaves)
    with torch.no_grad():
        return _gpipe_forward(axis, stage_fn, unflatten, x_micro, leaves, False)[0]
