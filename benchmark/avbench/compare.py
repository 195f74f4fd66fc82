"""The numbers that decide `correct`, each against its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

ZERO_GRAD_SHARE = 1e-3  # a leaf whose reference gradient is under this
#                         share of the median leaf's moves by round-off


def rel_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| / max |ref|."""
    ref = ref.double()
    scale = float(ref.abs().max())
    gap = float((prog.double().to(ref.device) - ref).abs().max())
    return gap / scale if scale > 0 else gap


def abs_max(prog: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((prog.double().to(ref.device) - ref).abs().max())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's |prog norm - ref norm|, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    names = list(ref if names is None else names)
    median = statistics.median(ref[k] for k in names)
    worst = 0.0
    for k in names:
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], median))
    return worst


def moving_leaves(ref_grads: Dict[str, float]) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's."""
    median = statistics.median(ref_grads.values())
    return [k for k, g in ref_grads.items() if g >= ZERO_GRAD_SHARE * median]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every limit, and whether all hold (a
    number that is missing or not finite fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        if not math.isfinite(value) or value > limit:
            ok = False
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": limit}
    return {"checks": checks, "correct": ok}
