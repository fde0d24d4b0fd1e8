"""The autograd-aware collectives the parallel paths insert into a model.

GSPMD inserts these all-reduces for the JAX package; the port's modules
call them where a tensor crosses from replicated to sharded work or back:

- :func:`copy_to_group` (Megatron's ``f``): identity forward, gradient
  all-reduced over the group; before the column-sharded ``qkv``/``fc1``;
- :func:`reduce_from_group` (``g``): all-reduce forward, identity
  backward; after the row-sharded ``proj``/``fc2``;
- :func:`broadcast_from`: a tensor one rank holds, on every rank of the
  group, whose backward sums every rank's gradient onto the holder (the
  class token's features under sequence parallelism);
- :func:`all_reduce_sum`: a differentiable all-reduce (BatchNorm's
  statistics under a data mesh).

Every function is the identity when ``group`` is None.

The point-to-point transfers of the ring and the pipeline (:func:`isend`,
:func:`recv`, :func:`ring_exchange`) go through pinned host buffers when
the group's backend is gloo and the tensor lies on the card, as it does
when two ranks share one card: gloo's send and receive hand the tensor's
address to its TCP transport, which reads and writes host memory only (a
CUDA tensor aborts the process there: "writev: Bad address" on an H100
with torch 2.11), while its collectives stage CUDA tensors themselves.
The staging copies the bytes and nothing else; NCCL groups and CPU
tensors transfer as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        x = x.contiguous().clone()
        dist.broadcast(x, src=src, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank() != ctx.src:
            g.zero_()
        return g, None, None


def copy_to_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Optional[dist.ProcessGroup]):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]):
    return x if group is None else _AllReduceSum.apply(x, group)


def broadcast_from(x: torch.Tensor, group_rank: int,
                   group: Optional[dist.ProcessGroup]):
    """``x`` of the rank at ``group_rank`` within ``group`` on every rank
    of it (every rank passes a tensor of the same shape)."""
    if group is None:
        return x
    return _BroadcastFrom.apply(
        x, dist.get_global_rank(group, group_rank), group)


def _staged(t: torch.Tensor, group: dist.ProcessGroup) -> bool:
    """Whether a point-to-point transfer of ``t`` over ``group`` goes
    through host memory (see the module)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host buffer shaped as ``t`` (pinned where ``t`` is on the card)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)


class _StagedSend:
    """The work of a staged send: it keeps the host copy alive until the
    send is waited on."""

    def __init__(self, work, buf: torch.Tensor):
        self.work, self.buf = work, buf

    def wait(self):
        return self.work.wait()


def isend(t: torch.Tensor, dst: int, group: dist.ProcessGroup):
    """``dist.isend`` of ``t`` to global rank ``dst``; returns its work."""
    t = t.contiguous()
    if not _staged(t, group):
        return dist.isend(t, dst, group=group)
    buf = _host(t)
    buf.copy_(t)               # synchronous: the bytes are on the host
    return _StagedSend(dist.isend(buf, dst, group=group), buf)


def recv(like: torch.Tensor, src: int, group: dist.ProcessGroup
         ) -> torch.Tensor:
    """A tensor shaped, typed and placed as ``like``, received from global
    rank ``src``."""
    if not _staged(like, group):
        buf = torch.empty_like(like)
        dist.recv(buf, src, group=group)
        return buf
    buf = _host(like)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


def ring_exchange(send: torch.Tensor, group: dist.ProcessGroup
                  ) -> torch.Tensor:
    """Send ``send`` to the next rank of ``group`` and return what the
    previous one sent (one step of a ring)."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_group_rank(group, dist.get_rank())
    n = len(ranks)
    send = send.contiguous()
    staged = _staged(send, group)
    if staged:
        out, into = _host(send), _host(send)
        out.copy_(send)
    else:
        out, into = send, torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, ranks[(me + 1) % n], group),
        dist.P2POp(dist.irecv, into, ranks[(me - 1) % n], group)])
    for r in reqs:
        r.wait()
    return into.to(send.device)


# the batch group of the active data-parallel loss (detection engines):
# a loss's denominator (a count of images, boxes or matches) is the global
# one, as GSPMD's sum over the sharded batch is in JAX
_DENOMINATORS: list = []


class global_denominators:
    """Context manager under which :func:`global_sum` all-reduces over
    ``group`` (None: the identity)."""

    def __init__(self, group: Optional[dist.ProcessGroup]):
        self.group = group

    def __enter__(self):
        _DENOMINATORS.append(self.group)
        return self

    def __exit__(self, *exc):
        _DENOMINATORS.pop()
        return False


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a loss denominator, no gradient) summed over the active data
    group of :class:`global_denominators`."""
    if not _DENOMINATORS or _DENOMINATORS[-1] is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=_DENOMINATORS[-1])
    return x
