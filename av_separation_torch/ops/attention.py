"""Multi-head attention over projected Q/K/V (port of
`av_separation_tpu/ops/attention.py`).

Q/K/V arrive packed as (B, T, H*dh), usually as column slices of one fused
projection, and go to the flash kernels as (B, H, T, dh) stride views: no
head transpose is copied in either direction, forward or backward.  The
kernel wrappers pick the CUDA kernels for a CUDA tensor and the plain
versions for a CPU tensor.

Under a mesh (`parallel/mesh.py`) each rank calls the same flash kernels on
its own block, the JAX dispatcher's sharded routes (attention.py:91-357):
  - data / fsdp / model (`_flash_sharded`, `_flash_sharded_packed`): the
    rank's batch rows and its head group (the TP split of the projections
    gives whole heads), with the seed folded by the rank's position
    pos = (d * F + f) * M + m: seed + pos * (0x9E3779B1 - 2**32), wrapped
    to int32;
  - seq (`_attn_seq_sharded`): the rank's query block against K and V
    gathered along time over 'seq' (backward: reduce-scatter), the seed
    folded by (pos * S + s) + 1.
So each shard's dropout mask is the JAX shard's, bit for bit (the hash
keys on the local (b, h) and the local Tq, Tk).  Where the JAX dispatcher
demotes to XLA because a mesh axis does not divide a shape, the port
raises a ValueError naming the axis and the shape: a CUDA tensor has no
plain route on the card.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from av_separation_torch.config import MeshConfig
from av_separation_torch.ops.kernels.attention import flash_attention

# 0x9E3779B1 as a wrapped int32 (the golden-ratio multiplier).
_GOLDEN = 0x9E3779B1 - (1 << 32)


def split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, T, H*dh) -> (B, H, T, dh) view."""
    return x.unflatten(-1, (nhead, x.shape[-1] // nhead)).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, H*dh); a view when x lies in packed memory."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _int32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def draw_seed(generator: torch.Generator) -> int:
    """One int32 attention-dropout seed per call, as the JAX dispatcher's
    `jax.random.bits(rng, (1,), "uint32").astype(int32)` draws one.  The
    generator lives on the CPU, so no device-to-host copy is needed; the
    seed reaches the kernel as a launch argument."""
    return _int32(int(torch.randint(0, 1 << 32, (1,), dtype=torch.int64,
                                    generator=generator)))


def fold_seed(seed: int, pos: int) -> int:
    """seed + pos * (0x9E3779B1 - 2**32) in int32 arithmetic."""
    return _int32(seed + pos * _GOLDEN)


def shard_seed(seed: int, cfg: MeshConfig, at: Mapping[str, int]) -> int:
    """The seed the rank at mesh coordinates `at` gives its flash call: the
    JAX data / fsdp / model routes fold pos = (d * F + f) * M + m, the seq
    route (pos * S + s) + 1."""
    pos = (at["data"] * cfg.fsdp + at["fsdp"]) * cfg.model + at["model"]
    if cfg.seq > 1:
        return fold_seed(seed, pos * cfg.seq + at["seq"] + 1)
    return fold_seed(seed, pos)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         nhead: int, dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         mesh=None) -> torch.Tensor:
    """Packed (B, Tq, d), (B, Tk, d), (B, Tk, d) -> (B, Tq, d), in the
    inputs' dtype (float32 or bfloat16).

    Attention-probability dropout at `dropout_rate` runs in the kernels,
    seeded from the CPU `generator`; without a generator there is no
    dropout (as the JAX dispatcher does without a dropout key).  Under a
    `mesh` the tensors are the rank's block (its rows, its `nhead` heads,
    under 'seq' its time block): K and V are gathered along time over
    'seq' and the seed is folded by the rank's position.
    """
    rate, seed = 0.0, 0
    if dropout_rate > 0.0 and generator is not None:
        rate, seed = float(dropout_rate), draw_seed(generator)
    if mesh is not None:
        from av_separation_torch.parallel import comm
        from av_separation_torch.parallel.mesh import coords, mesh_config
        cfg = mesh_config(mesh)
        if cfg.seq > 1:
            k = comm.gather(k, 1, mesh, "seq")
            v = comm.gather(v, 1, mesh, "seq")
        seed = shard_seed(seed, cfg, coords(mesh))
    out = flash_attention(split_heads(q, nhead), split_heads(k, nhead),
                          split_heads(v, nhead), rate, seed)
    return merge_heads(out)

