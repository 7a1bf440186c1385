"""Collectives that carry a gradient (training over a mesh).

The reference differentiates its sharded programs and XLA inserts the
backward's collectives.  Here each collective of a rank's training graph
is a :class:`torch.autograd.Function` whose backward is itself a
collective over the same axis:

=================  ========================  ===============================
op                 forward                   backward
=================  ========================  ===============================
``psum`` (g)       sum over the axis         identity
``copy`` (f)       identity                  sum over the axis
``all_gather``     gather                    reduce-scatter (this rank's
                                             slice of the summed gradient)
``reduce_scatter`` reduce-scatter            all-gather
``all_to_all``     all-to-all                the inverse all-to-all
``ppermute``       permute                   the inverse permutation
=================  ========================  ===============================

Every rank must issue the backward's collectives in the same order, and
every one of them, or a peer waits for good.  Two things hold that:

* a **token**: a scalar that every collective of the graph takes in and
  hands on (``RankContext.grad_token``), so the backward's collectives
  form one chain, run in the reverse of the forward's order on every
  rank, and none of them is pruned (:func:`value_and_grad` asks for the
  first token's gradient, so each node lies on a path autograd runs);
* the same graph on every rank: a rank-only branch (a pipeline stage's
  embedding, its head) holds no collective.

A collective runs through its Function only while a token is set, grad
mode is on, the group has more than one rank and the tensor is floating
point; otherwise it is the plain ``parallel.comm.AxisGroup`` call
(serving, metrics, integer positions), with the same communication.
Under ``torch.utils.checkpoint`` (non-reentrant) the recompute repeats
the forward's collectives at the same point of every rank's backward;
the token stays set through the backward so that the recompute builds
the same nodes as the forward did.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _inverse(perm):
    return [(dst, src) for src, dst in perm]


def _fwd(kind: str, group, x: torch.Tensor, args: tuple) -> torch.Tensor:
    if kind == "psum":
        return group.psum(x)
    if kind == "copy":
        return x.clone()
    if kind == "all_gather":
        return group.all_gather(x, *args)
    if kind == "reduce_scatter":
        return group.reduce_scatter(x, *args)
    if kind == "all_to_all":
        return group.all_to_all(x, *args)
    if kind == "ppermute":
        return group.ppermute(x, *args)
    raise ValueError(f"unknown collective {kind!r}")


def _bwd(kind: str, group, g: torch.Tensor, args: tuple) -> torch.Tensor:
    if kind == "psum":
        return g
    if kind == "copy":
        return group.psum(g)
    if kind == "all_gather":
        return group.reduce_scatter(g.contiguous(), *args)
    if kind == "reduce_scatter":
        return group.all_gather(g.contiguous(), *args)
    if kind == "all_to_all":
        split_dim, concat_dim = args
        return group.all_to_all(g.contiguous(), concat_dim, split_dim)
    if kind == "ppermute":
        return group.ppermute(g.contiguous(), _inverse(args[0]))
    raise ValueError(f"unknown collective {kind!r}")


class Collective(torch.autograd.Function):
    """One collective of a training graph: ``(y, token') = op(x, token)``.
    The backward runs the op's adjoint (module docstring) whether or not
    ``x`` needs a gradient, since the peers run theirs."""

    @staticmethod
    def forward(ctx, kind, group, args, token, x):
        ctx.kind, ctx.group, ctx.args = kind, group, args
        return _fwd(kind, group, x, args), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        dx = _bwd(ctx.kind, ctx.group, g, ctx.args)
        return None, None, None, g_token, dx


def collective(ctx, kind: str, axis: str, x: torch.Tensor, *args):
    """``kind`` over ``axis`` of the rank context ``ctx``: through
    :class:`Collective` while ``ctx`` builds a training graph, else the
    plain group call (module docstring)."""
    group = ctx.groups[axis]
    token = getattr(ctx, "grad_token", None)
    if group.size == 1:
        return x
    if token is None or not torch.is_grad_enabled() or not x.is_floating_point():
        return x if kind == "copy" else _fwd(kind, group, x, args)
    y, ctx.grad_token = Collective.apply(kind, group, tuple(args), token, x)
    return y


def value_and_grad(ctx, loss: Callable, leaves: Sequence[torch.Tensor]):
    """``loss()`` and its gradient with respect to ``leaves`` on one rank of
    a mesh, with the collectives of the graph chained by a token (module
    docstring).  Leaves the loss does not reach get zeros.  Returns
    ``(value, grads)``."""
    token = torch.zeros((), dtype=torch.float32, device=leaves[0].device, requires_grad=True)
    ctx.grad_token = token
    try:
        with torch.enable_grad():
            value = loss()
            # The last token joins the loss with weight 0, so that the chain
            # is a path from the loss to the first token.
            tied = value + ctx.grad_token.to(value.dtype) * 0
            grads = torch.autograd.grad(tied, list(leaves) + [token], allow_unused=True)[:-1]
    finally:
        ctx.grad_token = None
    return value.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def psum_axes(ctx, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` summed over each of ``axes`` in turn."""
    for axis in axes:
        x = ctx.psum(x, axis)
    return x
