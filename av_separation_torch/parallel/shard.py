"""A model and its training state over a mesh: parameters cut into the
rank's pieces by `parallel.mesh.PARAM_RULES`, the gradients reduced as the
one JAX program reduces them, the global-norm clip over every piece once,
and the full state for checkpoints.

`shard_model` keeps each `nn.Parameter` object and narrows its data to the
rank's piece; a parameter split over 'fsdp' is gathered at each use by a
parametrization (`torch.nn.utils.parametrize`) whose backward
reduce-scatters its gradient, as ZeRO-3 and XLA's FSDP shardings do.  The
registry `model.avsep_shards` keeps the parameters in the order and under
the names of the unsharded model, so the optimizer's state indices, the
state dict and the checkpoints are those of one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from av_separation_torch.parallel import comm
from av_separation_torch.parallel.mesh import (Placement, coords,
                                               placement_for, shard_tensor,
                                               sizes)


@dataclass
class Shard:
    param: nn.Parameter
    placement: Placement
    # A row-parallel bias: added by model rank 0 only, so its gradient is
    # summed over 'model'.
    sum_model: bool = False


class _GatherFsdp(nn.Module):
    """Parametrization: the whole parameter from its 'fsdp' pieces."""

    def __init__(self, dim: int, mesh):
        super().__init__()
        self.dim = dim
        self.mesh = mesh

    def forward(self, piece: torch.Tensor) -> torch.Tensor:
        return comm.gather(piece, self.dim, self.mesh, "fsdp")


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Cut `model` (whole, on any device) into this rank's pieces, in
    place, and point its mesh-aware modules at `mesh`.  Raises a
    ValueError naming the 'model' axis when it does not divide the heads,
    and NotImplementedError for the conformer block, which has no mesh
    route yet."""
    if getattr(model, "avsep_shards", None) is not None:
        raise ValueError("the model is already sharded")
    if model.cfg.encoder_block == "conformer":
        k = model.cfg.conv_kernel
        raise NotImplementedError(
            f"the conformer block has no mesh route yet: under 'seq' its "
            f"depthwise convolution needs a halo of K - 1 = {k - 1} frames "
            f"from the neighbouring time blocks, under 'model' its "
            f"convolution module needs a column split (pointwise1's two GLU "
            f"halves, the depthwise channels, pointwise2's rows), and its "
            f"BatchNorm's statistics over 'data' / 'fsdp' are untested")
    s, c = sizes(mesh), coords(mesh)
    nhead = model.cfg.nhead
    if nhead % s["model"]:
        raise ValueError(f"{nhead} heads do not divide over the mesh's "
                         f"'model' axis of {s['model']}")
    shards: Dict[str, Shard] = {}
    for name, p in list(model.named_parameters()):
        placement = placement_for(name, p.shape, s)
        owner, attr = _owner(model, name)
        row_bias = attr == "bias" and getattr(owner, "tp", None) == "row"
        with torch.no_grad():
            p.data = shard_tensor(p.data, placement, s, c)
        shards[name] = Shard(p, placement, row_bias)
    for name, sh in shards.items():
        if sh.placement.fsdp_dim is not None:
            owner, attr = _owner(model, name)
            parametrize.register_parametrization(
                owner, attr, _GatherFsdp(sh.placement.fsdp_dim, mesh),
                unsafe=True)
    for module in model.modules():
        if hasattr(type(module), "mesh"):
            module.mesh = mesh
    model.avsep_shards = shards
    return model


def sharded_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The rank's parameter pieces, in the unsharded model's order."""
    return [sh.param for sh in model.avsep_shards.values()]


@torch.no_grad()
def sync_grads(model: nn.Module, mesh) -> None:
    """Average the gradients over ('data', 'fsdp') and sum them over 'seq'
    (and over 'model' for the row-parallel biases).  An 'fsdp' piece's
    gradient was already summed over 'fsdp' by its gather's backward."""
    s = sizes(mesh)
    buckets: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for sh in model.avsep_shards.values():
        p = sh.param
        if p.grad is None:
            # A row-parallel bias off model rank 0 takes no gradient.
            p.grad = torch.zeros_like(p)
        axes = ("data", "seq") if sh.placement.fsdp_dim is not None \
            else ("fsdp", "data", "seq")
        if sh.sum_model:
            axes += ("model",)
        buckets.setdefault(axes, []).append(p.grad)
    scale = 1.0 / (s["data"] * s["fsdp"])
    for axes, grads in buckets.items():
        flat = torch._utils._flatten_dense_tensors(grads)
        comm.all_reduce_(flat, mesh, axes)
        flat.mul_(scale)
        for g, new in zip(grads, torch._utils._unflatten_dense_tensors(
                flat, grads)):
            g.copy_(new)


def norm_weights(model: nn.Module, mesh) -> List[float]:
    """Per parameter piece, the weight its squared sum takes in the
    global norm's all-reduce over every rank: pieces / world, so that the
    copies of a piece on the ranks that replicate it count once."""
    s = sizes(mesh)
    world = s["data"] * s["fsdp"] * s["seq"] * s["model"]
    return [sh.placement.shards(s) / world
            for sh in model.avsep_shards.values()]


@torch.no_grad()
def full_tensor(piece: torch.Tensor, placement: Placement, mesh
                ) -> torch.Tensor:
    """The whole tensor from every rank's piece (a collective)."""
    t = piece
    if placement.fsdp_dim is not None:
        t = comm.all_gather(t, placement.fsdp_dim, mesh, "fsdp")
    dim = placement.model_dim
    if dim is not None:
        if dim == 0 and placement.blocks > 1:
            t = comm.all_gather(t.unflatten(0, (placement.blocks, -1)), 1,
                                 mesh, "model").flatten(0, 1)
        else:
            t = comm.all_gather(t, dim, mesh, "model")
    return t


def full_state_dict(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The unsharded model's state dict (parameters under their own names,
    then the buffers), on every rank (a collective)."""
    out = {name: full_tensor(sh.param.detach(), sh.placement, mesh)
           for name, sh in model.avsep_shards.items()}
    out.update({name: b for name, b in model.named_buffers()})
    return out


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                         mesh) -> None:
    """Copy the rank's pieces of an unsharded state dict into `model`."""
    s, c = sizes(mesh), coords(mesh)
    missing = set(model.avsep_shards) | {n for n, _ in model.named_buffers()}
    missing -= set(state)
    if missing:
        raise KeyError(f"state dict lacks {sorted(missing)[:5]}")
    for name, sh in model.avsep_shards.items():
        sh.param.copy_(shard_tensor(state[name], sh.placement, s, c))
    for name, b in model.named_buffers():
        b.copy_(state[name])


def full_optimizer_state(model: nn.Module, adam: torch.optim.Optimizer,
                         mesh) -> dict:
    """Adam's state dict with each moment whole (a collective); its
    indices are the unsharded model's parameter order."""
    sd = adam.state_dict()
    placements = [sh.placement for sh in model.avsep_shards.values()]
    state = {}
    for i, st in sd["state"].items():
        state[i] = {k: (full_tensor(v, placements[i], mesh)
                        if k in ("exp_avg", "exp_avg_sq") else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state(model: nn.Module, adam: torch.optim.Optimizer,
                              full: Mapping, mesh) -> None:
    s, c = sizes(mesh), coords(mesh)
    placements = [sh.placement for sh in model.avsep_shards.values()]
    state = {}
    for i, st in full["state"].items():
        state[i] = {k: (shard_tensor(v, placements[int(i)], s, c)
                        if k in ("exp_avg", "exp_avg_sq") else v)
                    for k, v in st.items()}
    adam.load_state_dict({"state": state,
                          "param_groups": full["param_groups"]})


def bits_seed(seed: int, mesh) -> int:
    """The seed of a rank's device dropout generator: seed + 2 on the rank
    at the origin (so a mesh of one draws as one device does), other
    values on ranks that hold other rows or time blocks, the same on the
    ranks of one 'model' group (their residual streams are one)."""
    s, c = sizes(mesh), coords(mesh)
    block = (c["data"] * s["fsdp"] + c["fsdp"]) * s["seq"] + c["seq"]
    return (seed + 2 + block * 0x9E3779B1) & 0x7FFF_FFFF_FFFF_FFFF
