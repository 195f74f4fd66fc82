"""Sequence parallelism (port of `av_separation_tpu/parallel/sequence.py`).

Each rank of the 'seq' axis holds a block of the time axis:

- `sequence_parallel_attention`: the rank's query block against K and V
  all-gathered along time (backward: reduce-scatter), through the flash
  kernels: the route the model takes under 'seq' (`ops/attention.py`).
- `ring_attention`: K and V blocks rotate around the ring by
  `batch_isend_irecv` under an online softmax, O(T / n) memory a rank.
  Point-to-point ops carry no gradient, so it is one autograd function
  whose backward runs the ring again: each block's dK / dV accumulators
  travel with it and are home after a full turn.  The JAX version is plain
  jnp, and so is this one (no kernel).
- `make_sp_forward`: the whole model with the audio time axis split over
  'seq', the outputs gathered back.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from av_separation_torch.ops.attention import (merge_heads,
                                               multi_head_attention,
                                               split_heads)
from av_separation_torch.parallel import comm


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, nhead: int, mesh,
                                axis: str = "seq") -> torch.Tensor:
    """All-gather-KV attention on the rank's (B, T/n, d) blocks; returns
    the rank's block of the output.  Equal to dense attention."""
    k = comm.gather(k, 1, mesh, axis)
    v = comm.gather(v, 1, mesh, axis)
    return multi_head_attention(q, k, v, nhead)


def _rotate(tensors, mesh, axis: str):
    """Send each tensor to the next rank of `axis`, receive the previous
    rank's."""
    g = comm.group(mesh, axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    i = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(g, (i + 1) % n)
    prv = dist.get_global_rank(g, (i - 1) % n)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format)
           for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, g) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, g) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ring(torch.autograd.Function):
    """(B, H, Tq, dh) x (B, H, Tk, dh) blocks -> the rank's output block,
    softmax over every rank's keys."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis: str):
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf = q.float()
        m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        kc, vc = k, v
        for hop in range(n):
            s = torch.matmul(qf, kc.float().transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vc.float())
            m = m_new
            if hop < n - 1:
                kc, vc = _rotate((kc, vc), mesh, axis)
        out = acc / l
        ctx.save_for_backward(q, k, v, out, (m + torch.log(l)).squeeze(-1))
        ctx.args = (mesh, axis)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis = ctx.args
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, dof = q.float(), do.float()
        delta = (dof * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kc, vc = k.float(), v.float()
        dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
        for _ in range(n):
            p = torch.exp(torch.matmul(qf, kc.transpose(-1, -2)) * scale
                          - lse.unsqueeze(-1))
            dv = dv + torch.matmul(p.transpose(-1, -2), dof)
            ds = p * (torch.matmul(dof, vc.transpose(-1, -2)) - delta) \
                * scale
            dq = dq + torch.matmul(ds, kc)
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf)
            # Each block's accumulators travel with it; after n hops they
            # are back at the block's own rank.
            kc, vc, dk, dv = _rotate((kc, vc, dk, dv), mesh, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   nhead: int, mesh, axis: str = "seq") -> torch.Tensor:
    """Ring self- or cross-attention on the rank's (B, Tq/n, d) query and
    (B, Tk/n, d) key / value blocks; the rank's output block, equal to
    dense attention (no dropout, as in JAX)."""
    out = _Ring.apply(split_heads(q, nhead), split_heads(k, nhead),
                      split_heads(v, nhead), mesh, axis)
    return merge_heads(out)


def make_sp_forward(model: torch.nn.Module, mesh
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """Inference of a model sharded over `mesh` (`parallel.shard
    .shard_model`) with the audio time axis split over 'seq': fn(the
    rank's rows of mixed_spec (B, F, T), of lip_frames) -> (separated,
    masks), each (B, S, F, T) with T gathered back."""

    @torch.no_grad()
    def forward(mixed_spec: torch.Tensor, lip_frames: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            separated, masks = model(mixed_spec, lip_frames)
        finally:
            model.train(was_training)
        return comm.gather_time(separated, mesh), comm.gather_time(masks,
                                                                   mesh)

    return forward
