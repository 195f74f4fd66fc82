"""Permutation-invariant SI-SNR + L1 separation loss (port of
`av_separation_tpu/losses.py`).

The reference's semantics (reference losses.py:14-87), with its two quirks:
`si_snr` flattens all speakers, bins and frames of an item into ONE vector,
and the default PIT mode picks one best permutation per batch (`global`);
`per_sample` is the standard per-utterance PIT.  The S! permutations are
scored from pairwise speaker statistics (one batched (S, F*T) x (F*T, S)
product and one S^2 L1 pass), as in the JAX package; `separation_loss_direct`
is the S!-pass oracle it is held against.
"""

from __future__ import annotations

import functools
import itertools
from typing import Tuple

import numpy as np
import torch

from av_separation_torch.parallel import comm


def permutation_table(n: int) -> np.ndarray:
    """All n! permutations of range(n) as an (n!, n) int array."""
    return np.asarray(list(itertools.permutations(range(n))), dtype=np.int64)


@functools.lru_cache(maxsize=16)
def _perms_on(n: int, device: torch.device) -> torch.Tensor:
    """`permutation_table(n)` on `device`, made once: copied from the host
    each step, it would wait for the device's queue to drain (a pageable
    copy synchronises).  Read only; made outside inference mode, so that
    training may use it after a served call."""
    with torch.inference_mode(False):
        return torch.as_tensor(permutation_table(n), device=device)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Float32, or float64 when given float64 (a float64 reference run)."""
    return x if x.dtype == torch.float64 else x.float()


def si_snr(estimate: torch.Tensor, target: torch.Tensor, eps: float = 1e-8,
           *, reduce_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SNR in dB over (B, ...): everything past the batch
    axis is one vector per item; the batch mean, or per item (B,)."""
    b = estimate.shape[0]
    est = _at_least_f32(estimate.reshape(b, -1))
    tgt = _at_least_f32(target.reshape(b, -1))
    est = est - est.mean(dim=-1, keepdim=True)
    tgt = tgt - tgt.mean(dim=-1, keepdim=True)
    dot = (est * tgt).sum(dim=-1, keepdim=True)
    tgt_energy = (tgt * tgt).sum(dim=-1, keepdim=True) + eps
    proj = dot / tgt_energy * tgt
    noise = est - proj
    snr = 10.0 * torch.log10(
        (proj * proj).sum(dim=-1) / ((noise * noise).sum(dim=-1) + eps)
        + eps)
    return snr.mean() if reduce_mean else snr


def _pit_per_perm(separated: torch.Tensor, targets: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-item SI-SNR and L1 of every speaker permutation, from pairwise
    statistics: (snr (B, P), l1 (B, P))."""
    b, s = separated.shape[:2]
    sep = _at_least_f32(separated.reshape(b, s, -1))
    tgt = _at_least_f32(targets.reshape(b, s, -1))
    # Per-item means over the concatenated vector: the same for every perm.
    e = sep - sep.mean(dim=(1, 2), keepdim=True)
    t = tgt - tgt.mean(dim=(1, 2), keepdim=True)

    d = torch.einsum("bjk,bik->bji", e, t)        # (B, S, S): <E_j, T_i>
    est_sq = (e * e).sum(dim=(1, 2))              # (B,)
    tgt_sq = (t * t).sum(dim=(1, 2))              # (B,)
    # L1 over the uncentred tensors (reference losses.py:68).
    l1m = (sep[:, :, None] - tgt[:, None]).abs().mean(dim=-1)

    perms = _perms_on(s, sep.device)
    idx = torch.arange(s, device=sep.device)
    dots = d[:, perms, idx].sum(dim=-1)           # (B, P)
    l1 = l1m[:, perms, idx].mean(dim=-1)          # (B, P)

    tgt_energy = (tgt_sq + eps)[:, None]
    dot_sq = dots * dots
    proj_sq = dot_sq * tgt_sq[:, None] / (tgt_energy * tgt_energy)
    # ||E||^2 - 2 dot^2 / (||T||^2 + eps) + ||proj||^2 cancels when est ~
    # proj; round-off can go below 0, where the direct ||est - proj||^2
    # cannot (losses.py:102-107): clamp.
    noise_sq = torch.clamp(
        est_sq[:, None] - 2.0 * dot_sq / tgt_energy + proj_sq, min=0.0)
    snr = 10.0 * torch.log10(proj_sq / (noise_sq + eps) + eps)
    return snr, l1


def separation_loss(separated: torch.Tensor, targets: torch.Tensor,
                    l1_weight: float = 0.5, pit_mode: str = "global",
                    eps: float = 1e-8, mesh=None) -> torch.Tensor:
    """PIT loss over (B, S, F, T): -si_snr(separated[:, perm], targets) +
    l1_weight * L1, minimised over the S! permutations.  With a `mesh`
    the rows are the rank's and the loss is the global batch's: the batch
    means are taken over every rank's rows (`parallel.comm
    .mean_over_rows`), so 'global' picks the one best permutation of the
    whole batch."""
    snr, l1 = _pit_per_perm(separated, targets, eps)
    if pit_mode == "global":
        per_perm = -snr.mean(dim=0) + l1_weight * l1.mean(dim=0)
        if mesh is not None:
            per_perm = comm.mean_over_rows(per_perm, mesh)
        return per_perm.min()
    if pit_mode == "per_sample":
        loss = (-snr + l1_weight * l1).min(dim=1).values.mean()
        return loss if mesh is None else comm.mean_over_rows(loss, mesh)
    raise ValueError(f"unknown pit_mode {pit_mode!r}")


def separation_loss_direct(separated: torch.Tensor, targets: torch.Tensor,
                           l1_weight: float = 0.5, pit_mode: str = "global",
                           eps: float = 1e-8) -> torch.Tensor:
    """Direct S!-pass evaluation over the permuted tensors: the oracle the
    pairwise-statistics path is held against."""
    losses = []
    for perm in permutation_table(separated.shape[1]):
        perm_sep = separated[:, torch.as_tensor(perm)]
        if pit_mode == "global":
            snr = si_snr(perm_sep, targets, eps)
            l1 = (perm_sep - targets).abs().mean()
        else:
            snr = si_snr(perm_sep, targets, eps, reduce_mean=False)
            l1 = (perm_sep - targets).abs().mean(
                dim=tuple(range(1, separated.dim())))
        losses.append(-snr + l1_weight * l1)
    stacked = torch.stack(losses)  # (P,) or (P, B)
    if pit_mode == "global":
        return stacked.min()
    return stacked.min(dim=0).values.mean()


def best_permutation(separated: torch.Tensor, targets: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm indices (B, S), per-sample best SI-SNR (B,))."""
    perms = _perms_on(separated.shape[1], separated.device)
    snrs, _ = _pit_per_perm(separated, targets, 1e-8)
    best = snrs.argmax(dim=1)
    return perms[best], snrs.max(dim=1).values
