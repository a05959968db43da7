"""The collectives of the port's multi-device step, on torch.distributed.

JAX leaves these to GSPMD, which inserts them from the shardings. Here a
rank holds and computes only its rows of a batch axis (``Rows``), and the
models call these where JAX's partitioner gathers or reduces:

- ``Rows.gather``: every rank's rows of a batch, in rank order, on every
  rank: an all_gather, each share padded to the largest and trimmed (an
  uneven split, as GSPMD pads one: a tree layer of one frame over two
  frame ranks leaves one rank empty). Its backward sums the gathered
  cotangent over the group (an all_reduce) and keeps this rank's rows.
- ``Rows.sum``: a value summed over the group, every rank going on with
  the whole (the loss terms and metrics of a split batch). Every rank then
  computes the same loss from the same whole values, so the backward
  hands each rank's cotangent to its own summand unchanged: the gradients,
  summed over the mesh after the backward, count the whole loss once.
- ``Rows.noise``: a quantizer's noise drawn for the whole batch, as one
  process draws it, of which the rank keeps its rows. This is what makes
  the sharded step equal the unsharded one.

A rank's rows of n are ``split_rows``'s: ceil(n / parts) a rank, the last
ranks short or empty. Every rank of a group must make the same collective
calls in the same order. A model that splits its rows keeps the same ops
on every rank, on an empty share too, and routes every gathered tensor
into the rank's loss: autograd runs a device's nodes in reverse order of
creation, so the gathers' all_reduces meet in the same order everywhere.

``placement(mesh, row_axes)`` is the mesh of the running step (JAX's
``with mesh:``): the models read from it which group splits their rows
(``rows_over``). Without it every ``Rows`` is ``WHOLE``: no collective,
the single-process step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

_PLACEMENT = None  # (mesh, row_axes) of the running step
_TIME_BATCH = None  # (Rows, n): the frames of the batch a time attention mixes


def split_rows(n: int, parts: int) -> list:
    """The rows of each of ``parts`` ranks in a batch of n: ceil(n / parts)
    a rank in rank order, the last short or empty."""
    each = -(-n // parts)
    return [max(0, min(each, n - i * each)) for i in range(parts)]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, counts, index):
        ctx.group = group
        ctx.lo = sum(counts[:index])
        ctx.hi = ctx.lo + counts[index]
        top = max(counts)
        if t.shape[0] < top:
            t = torch.cat([t, t.new_zeros((top - t.shape[0],) + t.shape[1:])])
        parts = [torch.empty_like(t) for _ in counts]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.lo:ctx.hi], None, None, None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class RowNoise:
    """A noise source for a rank's rows [lo, hi) of a batch of n: each call
    draws from ``source`` for the whole batch and keeps those rows."""

    def __init__(self, source, lo: int, hi: int, n: int):
        self.source, self.lo, self.hi, self.n = source, lo, hi, n

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.hi - self.lo:
            raise RuntimeError(f"a draw for {x.shape[0]} rows, this rank holds "
                               f"{self.hi - self.lo} of {self.n}")
        return self.source(x.new_empty((self.n,) + tuple(x.shape[1:])))[self.lo:self.hi]


@dataclass(frozen=True)
class Rows:
    """How a batch axis splits over a process group: ``parts`` ranks, this
    one the ``index``-th (``WHOLE``: one process holds every row)."""

    group: object = None
    parts: int = 1
    index: int = 0

    def counts(self, n: int) -> list:
        return split_rows(n, self.parts)

    def span(self, n: int) -> tuple:
        """(lo, hi): this rank's rows of a batch of n."""
        counts = self.counts(n)
        lo = sum(counts[:self.index])
        return lo, lo + counts[self.index]

    def gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's rows t of a batch of n -> the batch, on every rank."""
        if self.parts == 1:
            return t
        counts = self.counts(n)
        if not max(counts):
            return t
        return _GatherRows.apply(t, self.group, tuple(counts), self.index)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the group, on every rank (backward: identity)."""
        return t if self.parts == 1 else _GroupSum.apply(t, self.group)

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """t, its gradient taken on the group's first rank alone (a term
        every rank computes whole, as the entropy bottlenecks' aux loss)."""
        return t if self.index == 0 else t.detach()

    def noise(self, source, n: int):
        """``source`` for this rank's rows of a batch of n."""
        if source is None or self.parts == 1:
            return source
        return RowNoise(source, *self.span(n), n)


WHOLE = Rows()


@contextlib.contextmanager
def placement(mesh, row_axes: tuple = ()):
    """The mesh of the running step, for the scope, and the mesh axes that
    split a GOP's batch rows (MCVC's B*V)."""
    global _PLACEMENT
    saved = _PLACEMENT
    _PLACEMENT = (mesh, tuple(row_axes))
    try:
        yield
    finally:
        _PLACEMENT = saved


def rows_over(axes) -> Rows:
    """The ``Rows`` of the running step's mesh over ``axes`` (those of size
    1 dropped); ``WHOLE`` outside a step on a mesh."""
    if _PLACEMENT is None:
        return WHOLE
    from fastvideocodec_torch.parallel.mesh import axis_group

    group, parts, index = axis_group(_PLACEMENT[0], axes)
    return WHOLE if parts == 1 else Rows(group, parts, index)


def gop_rows() -> Rows:
    """The ``Rows`` that split the running step's GOP batch axis."""
    return WHOLE if _PLACEMENT is None else rows_over(_PLACEMENT[1])


def gop_share(frame_axis: str = "") -> Rows:
    """The ``Rows`` of the ranks that share one GOP of the running step:
    those its batch rows split over, and its model's ``frame_axis``."""
    if _PLACEMENT is None:
        return WHOLE
    return rows_over(_PLACEMENT[1] + ((frame_axis,) if frame_axis else ()))


def frame_rows(axis: str) -> Rows:
    """The ``Rows`` of a frame-sharded LSVC (``axis`` its ``frame_axis``):
    ``WHOLE`` when ``axis`` is empty; outside a step on a mesh a sharded
    axis raises, as JAX's sharding constraint does outside a mesh."""
    if not axis:
        return WHOLE
    if _PLACEMENT is None:
        raise ValueError(f"a model sharded over the {axis!r} axis runs inside a step on a mesh "
                         "(make_train_step(..., mesh=...))")
    return rows_over((axis,))


@contextlib.contextmanager
def time_batch(rows: Rows, n: int):
    """The batch of n frames, split by ``rows``, that a SpaceTimeAttention
    called in the scope mixes in its time attention."""
    global _TIME_BATCH
    saved = _TIME_BATCH
    _TIME_BATCH = (rows, n) if rows.parts > 1 else None
    try:
        yield
    finally:
        _TIME_BATCH = saved


def current_time_batch():
    """(Rows, n) of the frames a time attention mixes, or None (all local)."""
    return _TIME_BATCH
