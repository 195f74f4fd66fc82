"""Linear time-resampling of the visual stream to the audio frame rate (port
of `av_separation_tpu/ops/interpolate.py`).

`F.interpolate(mode='linear', align_corners=False)` semantics along axis -2:
output index ``i`` reads source coordinate ``(i + 0.5) * N_in / N_out - 0.5``,
clamped at 0, blended between ``floor`` and ``floor + 1`` (right-clamped).
The indices and weights are computed in float64 NumPy, as in the reference,
so both packages round them identically.  The blend runs in float32 and is
rounded to x's dtype, as the JAX blend of a bf16 x with float32 weights.
"""

from __future__ import annotations

import numpy as np
import torch


def interpolate_time_linear(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Resample (..., N, d) -> (..., target_len, d) along axis -2."""
    n_in = x.shape[-2]
    if n_in == target_len:
        return x
    scale = n_in / target_len
    src = (np.arange(target_len, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    w_lo = (1.0 - w_hi).astype(np.float32)

    dev = x.device
    lo_t = torch.as_tensor(lo, device=dev)
    hi_t = torch.as_tensor(hi, device=dev)
    wdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    w_lo_t = torch.as_tensor(w_lo, device=dev)[:, None].to(wdt)
    w_hi_t = torch.as_tensor(w_hi, device=dev)[:, None].to(wdt)
    return (x.index_select(-2, lo_t) * w_lo_t
            + x.index_select(-2, hi_t) * w_hi_t).to(x.dtype)
