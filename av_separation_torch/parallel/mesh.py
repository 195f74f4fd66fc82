"""The device mesh and the parameter placement rules (port of
`av_separation_tpu/parallel/mesh.py`).

The mesh is a 4-D `torch.distributed.DeviceMesh` named
('data', 'fsdp', 'seq', 'model') with 'model' innermost, so rank r sits
where the JAX mesh puts device r.  One rank holds one device.

  'data'  utterance batches (DP): batch rows split, gradients averaged.
  'fsdp'  ZeRO-3: parameters and Adam moments split on the dim the rules
          give, gathered at use (backward: reduce-scatter); rows split too,
          so the batch block of a rank is d * F + f.
  'seq'   the audio time axis split (`models/model.py`); attention gathers
          K/V along time (`ops/attention.py`).
  'model' Megatron-style TP: q, k and v split by heads (each of the three
          row blocks of `in_proj_weight` on its own, so every rank holds
          whole heads of all three), `out_proj` and the FFN's second linear
          split by input columns and ending in one all-reduce, the FFN's
          first linear by output rows.

`PARAM_RULES` is the JAX table over the port's parameter names (torch
layout: a Linear weight is (out, in), a Conv1d weight (out, in, k)); a name
no rule matches is replicated.  The per-dimension guard of the JAX
`param_shardings` drops an axis from a dim that its size does not divide
and keeps the other dims' axes (conv2 keeps 'fsdp' where conv1's C_in 257
drops it).  Two deliberate departures from the JAX table, because their
CUDA kernels take whole weights: the audio projection (`csrc/audio_proj.cu`
fuses conv1 and conv2) and the mask decoder (`csrc/mask_decoder.cu` applies
the sigmoid and the mixture product to the whole fc2 output) are kept whole
on 'model' and split on 'fsdp' only (`KEPT_WHOLE_ON_MODEL`); each rank runs
them on its local rows.  The JAX package demotes both to XLA under a mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from av_separation_torch.config import MeshConfig

AXES = ("data", "fsdp", "seq", "model")

Spec = Tuple[Optional[str], ...]

# (regex over the port's parameter name, spec over the tensor's dims,
# row blocks) -- first match wins.  `in_proj_weight` / `in_proj_bias` stack
# the q, k and v projections as 3 row blocks; the spec applies to each.
PARAM_RULES: Sequence[Tuple[str, Spec, int]] = (
    # q/k/v: heads (output rows) over 'model', input columns over 'fsdp'
    # (JAX q_proj/kernel (in, out) P('fsdp', 'model')).
    (r".*\.in_proj_weight", ("model", "fsdp"), 3),
    (r".*\.in_proj_bias", ("model",), 3),
    # out_proj: input columns over 'model' (JAX P('model', 'fsdp')).
    (r".*\.out_proj\.weight", ("fsdp", "model"), 1),
    # The FFN: (d -> 4d) by output rows, (4d -> d) by input columns.
    (r".*\.(linear1|ff\.0)\.weight", ("model", "fsdp"), 1),
    (r".*\.(linear1|ff\.0)\.bias", ("model",), 1),
    (r".*\.(linear2|ff\.3)\.weight", ("fsdp", "model"), 1),
    # The decoder MLP (JAX fc1 / fc2 under the FFN rules), whole on 'model'.
    (r"decoder\.decoder\.0\.weight", (None, "fsdp"), 1),
    (r"decoder\.decoder\.3\.weight", ("fsdp", None), 1),
    # The audio conv projections (JAX (k, C_in, C_out) P(None, 'fsdp',
    # 'model')), whole on 'model'.
    (r"audio_encoder\.input_proj\.[02]\.weight", (None, "fsdp", None), 1),
)

# The parameters whose 'model' split in the JAX table the port leaves out
# (their kernels take whole weights).
KEPT_WHOLE_ON_MODEL = (r"decoder\.decoder\.(0\.weight|0\.bias|3\.weight)",
                       r"audio_encoder\.input_proj\.[02]\.(weight|bias)")


def spec_for_path(name: str) -> Tuple[Spec, int]:
    """(spec, row blocks) of the port parameter `name`; () replicates."""
    for pattern, spec, blocks in PARAM_RULES:
        if re.fullmatch(pattern, name):
            return spec, blocks
    return (), 1


@dataclass(frozen=True)
class Placement:
    """Where a parameter's shards lie: the dim each mesh axis splits (after
    the guard), and the row blocks that dim 0 stacks."""

    model_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None
    blocks: int = 1

    def shards(self, sizes: Mapping[str, int]) -> int:
        """How many distinct pieces the parameter is cut into."""
        return (sizes["model"] if self.model_dim is not None else 1) \
            * (sizes["fsdp"] if self.fsdp_dim is not None else 1)


def guarded_spec(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int],
                 blocks: int = 1) -> Spec:
    """`spec` with each axis kept only where its size divides the dim (the
    per-block rows for dim 0 of a stacked parameter)."""
    kept = []
    for d, axis in enumerate(spec[:len(shape)]):
        dim = shape[d] // blocks if d == 0 else shape[d]
        total = sizes.get(axis, 0) if axis is not None else 0
        kept.append(axis if total and dim % total == 0 else None)
    return tuple(kept)


def placement_for(name: str, shape: Sequence[int],
                  sizes: Mapping[str, int]) -> Placement:
    spec, blocks = spec_for_path(name)
    spec = guarded_spec(spec, shape, sizes, blocks)
    return Placement(model_dim=spec.index("model") if "model" in spec
                     else None,
                     fsdp_dim=spec.index("fsdp") if "fsdp" in spec else None,
                     blocks=blocks)


def make_mesh(cfg: MeshConfig):
    """A ('data', 'fsdp', 'seq', 'model') DeviceMesh over the job's ranks
    (the process group must be up: `parallel.distributed.initialize`), of
    device type 'cuda' under NCCL, else 'cpu'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.data}x{cfg.fsdp}x{cfg.seq}x{cfg.model} "
                         f"needs {cfg.num_devices} ranks, the job has "
                         f"{world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type,
                            (cfg.data, cfg.fsdp, cfg.seq, cfg.model),
                            mesh_dim_names=AXES)


def sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a mesh."""
    return {a: int(mesh.size(i)) for i, a in enumerate(mesh.mesh_dim_names)}


def coords(mesh) -> Dict[str, int]:
    """{axis: this rank's index along it}."""
    return {a: int(i) for a, i in zip(mesh.mesh_dim_names,
                                      mesh.get_coordinate())}


def mesh_config(mesh) -> MeshConfig:
    return MeshConfig(**sizes(mesh))


def split_rows(n: int, mesh) -> slice:
    """The rows of an n-row global batch this rank holds (rows split over
    ('data', 'fsdp'), block d * F + f); raises a ValueError naming the
    axes when they do not divide n."""
    s, c = sizes(mesh), coords(mesh)
    block, blocks = c["data"] * s["fsdp"] + c["fsdp"], s["data"] * s["fsdp"]
    if n % blocks:
        raise ValueError(f"batch {n} does not divide over the mesh's "
                         f"('data', 'fsdp') = {blocks} row blocks")
    rows = n // blocks
    return slice(block * rows, (block + 1) * rows)


def shard_tensor(t: torch.Tensor, placement: Placement,
                 mesh_sizes: Mapping[str, int],
                 mesh_coords: Mapping[str, int]) -> torch.Tensor:
    """This rank's piece of the full tensor `t` (a contiguous copy)."""
    for axis, dim in (("model", placement.model_dim),
                      ("fsdp", placement.fsdp_dim)):
        if dim is None:
            continue
        n, i = mesh_sizes[axis], mesh_coords[axis]
        if dim == 0 and placement.blocks > 1:
            parts = t.unflatten(0, (placement.blocks, -1))
            step = parts.shape[1] // n
            t = parts[:, i * step:(i + 1) * step].flatten(0, 1)
        else:
            step = t.shape[dim] // n
            t = t.narrow(dim, i * step, step)
    return t.contiguous()
