"""NaN checks for a debugging run (the counterpart of `jax_debug_nans`,
which the JAX CLI's `--debug-nans` sets).

Inside `debug_nans(model)` a NaN produced by a step raises
`FloatingPointError` naming what produced it:

  - forward: a hook on every module of the model reads each output, so the
    first module whose output holds a NaN raises with its qualified name
    (the kernels' outputs are read through the modules that call them);
  - backward: `torch.autograd.detect_anomaly(check_nan=True)` names the
    backward function that returned the NaN (the flash kernels'
    `autograd.Function` among them).

NaN only, as `jax_debug_nans`: an infinity passes (that is
`jax_debug_infs`, which the JAX CLI does not set).  The hooks only read:
with finite data a step gives the numbers it gives without them.  Each
check reads a flag back from the device, and anomaly mode synchronises
after every backward op, so a step under the flag is slower.  Nothing is
registered outside the block.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _has_nan(t: torch.Tensor) -> bool:
    return t.is_floating_point() and bool(torch.isnan(t).any())


@contextlib.contextmanager
def debug_nans(model: torch.nn.Module) -> Iterator[None]:
    """Raise FloatingPointError at the first NaN a forward or backward of
    `model` produces inside the block."""
    names = {m: name or type(model).__name__
             for name, m in model.named_modules()}

    def check(module, args, output):
        if any(_has_nan(t) for t in _tensors(output)):
            raise FloatingPointError(
                f"NaN in the output of module {names[module]} "
                f"({type(module).__name__})")

    handles = [m.register_forward_hook(check) for m in names]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"NaN in the backward: {e}") from e
    finally:
        for h in handles:
            h.remove()
