"""Checkpoint and resume (port of `av_separation_tpu/utils/checkpoint.py`).

A checkpoint is one `torch.save` file, `<directory>/<step>.pt`, holding the
model's parameters and buffers (BatchNorm statistics included), Adam's
state, the step and the states of both generators of `Generators`.  The
JAX module saves through Orbax asynchronously; here `save_checkpoint`
copies every tensor to host memory before it returns, then a background
thread writes the file (to a temporary name, renamed when complete) and
drops the oldest files beyond `max_to_keep`.  `wait=True`, or
`wait_until_finished`, blocks until the write has landed; a failed write
raises there, or at the next save to the same directory.  Saves to one
directory are written in order.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Mapping, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class _Writer:
    """The one in-flight write of a directory and the error of the last."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def wait(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise RuntimeError("checkpoint write failed") from err


_writers: Dict[str, _Writer] = {}
_writers_lock = threading.Lock()


def _writer(directory: str) -> _Writer:
    with _writers_lock:
        return _writers.setdefault(os.path.abspath(directory), _Writer())


def _host_copy(obj: Any) -> Any:
    """The same structure with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _write(directory: str, step: int, payload: dict, max_to_keep: int,
           writer: _Writer) -> None:
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{step}.pt")
        tmp = os.path.join(directory, f".{step}.pt.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in _steps(directory)[:-max_to_keep]:
            os.remove(os.path.join(directory, f"{old}.pt"))
    except BaseException as e:  # noqa: BLE001 — re-raised by wait()
        writer.error = e


def save_checkpoint(directory: str, step: int, state: Any,
                    max_to_keep: int = 3, wait: bool = False) -> None:
    """Save `state` (a `train.TrainState`) as `directory/<step>.pt`.

    Returns once the tensors are copied to host memory; the file is written
    on a background thread.  wait=True blocks until it is written."""
    if max_to_keep < 1:
        raise ValueError(f"max_to_keep {max_to_keep} must be at least 1")
    payload = _host_copy({
        "step": int(step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.adam.state_dict(),
        "generators": {"seeds": state.generators.seeds.get_state(),
                       "bits": state.generators.bits.get_state()},
    })
    writer = _writer(directory)
    writer.wait()  # one write at a time per directory, in order
    writer.thread = threading.Thread(
        target=_write, args=(directory, step, payload, max_to_keep, writer),
        name=f"checkpoint-{step}")
    writer.thread.start()
    if wait:
        writer.wait()


def wait_until_finished(directory: str) -> None:
    """Block until the write in flight for `directory`, if any, has landed;
    raise if it failed."""
    _writer(directory).wait()


def latest_step(directory: str) -> Optional[int]:
    """The newest step saved under `directory`, or None."""
    wait_until_finished(directory)
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: Optional[int]) -> Optional[dict]:
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(directory, f"{step}.pt"),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(directory: str, state: Any,
                       step: Optional[int] = None) -> Any:
    """Load the checkpoint at `step` (default: the newest) into `state`, in
    place, and return it; a missing directory or an empty one returns
    `state` unchanged."""
    if not os.path.isdir(directory):
        return state
    saved = _load(directory, step)
    if saved is None:
        return state
    state.model.load_state_dict(saved["model"])
    state.optimizer.adam.load_state_dict(saved["optimizer"])
    state.generators.seeds.set_state(saved["generators"]["seeds"])
    state.generators.bits.set_state(saved["generators"]["bits"])
    state.step = saved["step"]
    return state


def restore_variables(directory: str, step: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """The model's state dict (parameters and buffers) of the checkpoint at
    `step` (default: the newest), on the CPU, for inference.  Raises
    FileNotFoundError when there is none."""
    saved = _load(directory, step) if os.path.isdir(directory) else None
    if saved is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return saved["model"]
