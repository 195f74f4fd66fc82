"""Collectives over the mesh's axes, each with the gradient rule its place
in the model needs (the autograd counterparts of the JAX package's
shard_map collectives and GSPMD's inserted ones).

Gradients follow one convention: every rank's backward starts from the
loss's cotangent 1, a collective's backward sums the cotangents of the
ranks that read its output, and `parallel.grads.sync_grads` then averages
the parameter gradients over ('data', 'fsdp') and sums them over 'seq'
(each seq rank computes the whole, identical loss, so its gradients are
the part that flows through its time block).

  copy_to_model      Megatron's f: identity; backward all-reduce over
                     'model' (the input of a column-parallel linear).
  reduce_from_model  Megatron's g: all-reduce over 'model'; backward
                     identity (the output of a row-parallel linear).
  gather(x, dim, axis, grad)  all-gather along `dim` over `axis`; backward
                     'sum' reduce-scatters (the ranks read different parts:
                     K/V gathered for local queries, parameters gathered
                     over 'fsdp'), 'slice' keeps the rank's own part (every
                     rank reads the whole and computes the same: the
                     separated spectrogram gathered for the loss).
  mean_over_rows     the mean of a per-rank statistic over the batch axes
                     ('data', 'fsdp'; equal rows a rank); backward the same
                     mean of the cotangents (BatchNorm's statistics, the
                     loss's per-permutation means).

A mesh always takes these paths, even when every axis has size 1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from av_separation_torch.parallel.mesh import sizes

BATCH_AXES = ("fsdp", "data")


def group(mesh, axis: str):
    return mesh.get_group(axis)


def all_reduce_(t: torch.Tensor, mesh, axes: Sequence[str],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over each axis of `axes` in turn, no gradient."""
    for axis in axes:
        dist.all_reduce(t, op=op, group=group(mesh, axis))
    return t


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy, for a collective that writes in place."""
    return t.clone(memory_format=torch.contiguous_format)


def all_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's x along `axis`, concatenated along `dim`; no
    gradient (`gather` carries one)."""
    n = sizes(mesh)[axis]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, dim: int, mesh, axis: str
                    ) -> torch.Tensor:
    """The rank's part along `dim` of the sum of `g` over `axis` (NCCL
    and gloo both carry it, gloo on CUDA tensors too:
    tools/torch_gloo_cuda_probe.py)."""
    n = sizes(mesh)[axis]
    stacked = torch.stack(g.chunk(n, dim)).contiguous()
    out = torch.empty_like(stacked[0])
    # The parts one after another along dim 0, as gloo checks the shapes.
    dist.reduce_scatter_tensor(out, stacked.flatten(0, 1),
                               group=group(mesh, axis))
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_copy(g), ctx.mesh, ("model",)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(_copy(x), mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, mesh, axis: str, grad: str):
        ctx.args = (dim, mesh, axis, grad)
        return all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, grad = ctx.args
        if grad == "sum":
            part = _reduce_scatter(g, dim, mesh, axis)
        else:
            n = sizes(mesh)[axis]
            part = g.chunk(n, dim)[mesh.get_local_rank(axis)]
        return part, None, None, None, None


class _MeanOverRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _rows_mean(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _rows_mean(g, ctx.mesh), None


def _rows_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    out = all_reduce_(_copy(x.detach()), mesh, BATCH_AXES)
    return out / rows_size(mesh)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather(x: torch.Tensor, dim: int, mesh, axis: str,
           grad: str = "sum") -> torch.Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"gather grad {grad!r}: 'sum' or 'slice'")
    return _Gather.apply(x, dim, mesh, axis, grad)


def rows_size(mesh) -> int:
    """The ranks the batch rows split over: data * fsdp."""
    s = sizes(mesh)
    return s["data"] * s["fsdp"]


def mean_over_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    return _MeanOverRows.apply(x, mesh)


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch from every rank's rows (block d * F + f), on
    every rank; no gradient."""
    return all_gather(all_gather(x, 0, mesh, "fsdp"), 0, mesh, "data")


def seq_size(mesh) -> int:
    return sizes(mesh)["seq"]


def gather_time(x: torch.Tensor, mesh) -> torch.Tensor:
    """A model output's time blocks (last dim) put back together over
    'seq' for the loss, which every seq rank computes whole: the backward
    keeps the rank's own block.  x itself when 'seq' is 1."""
    if seq_size(mesh) == 1:
        return x
    return gather(x, x.dim() - 1, mesh, "seq", grad="slice")


def seq_block(t_len: int, mesh) -> slice:
    """This rank's block of a time axis of `t_len` steps split over 'seq';
    raises a ValueError naming the axis when it does not divide."""
    n = sizes(mesh)["seq"]
    if t_len % n:
        raise ValueError(f"time axis {t_len} does not divide over the "
                         f"mesh's 'seq' axis of {n}")
    step = t_len // n
    i = mesh.get_local_rank("seq")
    return slice(i * step, (i + 1) * step)
