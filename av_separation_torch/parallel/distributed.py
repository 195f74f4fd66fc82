"""Multi-process start-up and failure detection (port of
`av_separation_tpu/parallel/distributed.py`), over `torch.distributed`.

- `initialize` joins the job's process group (NCCL on the card, gloo on the
  CPU) through a TCP store at the coordinator's address; it is a no-op in a
  one-process run given none of its arguments.  Nothing in the environment
  tells a program of a cluster, so the caller gives the address, the
  process count and this process's id.
- `global_mesh` lays the ('data', 'fsdp', 'seq', 'model') mesh over every
  rank of the job, one device a rank.
- `host_local_batch_to_global` gives a rank its rows of the global batch on
  its device: torch has no global array, so every rank iterates the same
  deterministic global stream and keeps its block, as the JAX CLI's
  processes do (av_separation_tpu/cli.py:280-295).
- `barrier` / `check_alive`: an all-reduce of ones over every rank, run in a
  side thread with a timeout, so a lost rank surfaces as a TimeoutError
  (whether the collective hangs or the transport reports the peer gone)
  instead of a hang (restart from the latest checkpoint).
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from av_separation_torch.config import MeshConfig
from av_separation_torch.parallel.mesh import make_mesh, split_rows


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, cpu: bool = False,
               backend: Optional[str] = None) -> bool:
    """Join the job's process group; returns whether one is up.

    A no-op (False) when none of the arguments is given and no group is up:
    a one-process run.  Otherwise all three are needed ('host:port' of the
    rank-0 store, the process count, this process's id).  `cpu` picks gloo
    on the CPU; otherwise the rank takes the CUDA device `process_id %
    device_count` under NCCL, or under `backend` 'gloo' (which lets several
    ranks share one card; NCCL refuses that)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process job needs the coordinator "
                         "address, the process count and the process id")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a job of "
                         f"{num_processes} processes")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator_address!r} is not "
                         f"host:port")
    backend = backend or ("gloo" if cpu else "nccl")
    kwargs = {}
    if not cpu:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(cfg: MeshConfig):
    """The mesh over every rank of the job ('model' innermost)."""
    return make_mesh(cfg)


def host_local_batch_to_global(batch: Mapping[str, np.ndarray | torch.Tensor],
                               mesh, device: torch.device | str
                               ) -> Dict[str, torch.Tensor]:
    """This rank's rows (block d * F + f of the global batch) as tensors
    on `device`.  Raises a ValueError when ('data', 'fsdp') does not divide
    the batch."""
    out = {}
    for k, v in batch.items():
        rows = split_rows(len(v), mesh)
        out[k] = torch.as_tensor(v[rows], device=device)
    return out


def barrier(timeout_s: float = 60.0) -> None:
    """An all-reduce of ones over every rank, with a timeout: a lost or
    hung rank raises TimeoutError instead of blocking the job forever; a
    wrong sum raises RuntimeError."""
    if not dist.is_initialized():
        return
    backend = dist.get_backend()
    device = torch.device("cuda", torch.cuda.current_device()) \
        if backend == "nccl" else torch.device("cpu")
    result = {}

    def run():
        try:
            ones = torch.ones((), device=device)
            dist.all_reduce(ones)
            result["sum"] = float(ones)
        except Exception as e:  # noqa: BLE001 — reported below
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive() or "error" in result:
        # Hung, or the transport saw the peer go (gloo reports a closed
        # connection): either way the collective cannot complete.
        raise TimeoutError(
            f"collective barrier did not complete within {timeout_s}s: a "
            f"rank is unreachable ({result.get('error', 'no reply')!r}); "
            f"restart from the latest checkpoint")
    expected = float(dist.get_world_size())
    if abs(result["sum"] - expected) > 0.5:
        raise RuntimeError(
            f"barrier sum mismatch: {result['sum']} != {expected}")


def check_alive(timeout_s: float = 60.0) -> bool:
    try:
        barrier(timeout_s)
        return True
    except (TimeoutError, RuntimeError):
        return False


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
