"""Training (port of `av_separation_tpu/train.py`): train state, the update
step and the eval step, on one device.

  step = model in training mode -> `separation_loss` -> backward ->
         global-norm clip 1.0 -> Adam(3e-4, 0.9, 0.999, 1e-8)

as optax's `chain(clip_by_global_norm, adam)` does it (reference
demo.py:88,103).  The step runs eagerly and updates the model and the
optimizer state in place (torch's idiom; the JAX step returns a new state).
The mesh, the scan-fused on-device steps, remat, bf16 and checkpointing come
with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from av_separation_torch.config import ExperimentConfig
from av_separation_torch.losses import separation_loss
from av_separation_torch.models.layers import Generators
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              build_model, resolve_device)
from av_separation_torch.utils.metrics import input_snr, permutation_snr

Batch = Mapping[str, np.ndarray | torch.Tensor]


class ClippedAdam:
    """optax `chain(clip_by_global_norm(max_norm), adam(lr))`.

    The clip is optax's: with g_norm = sqrt(sum of every gradient squared),
    the gradients are scaled by max_norm / g_norm only when g_norm >
    max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm, so it
    is another function).  Adam is `torch.optim.Adam`, whose update is
    optax's: lr * mu_hat / (sqrt(nu_hat) + eps).  Nothing leaves the device.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], max_norm: float,
                 lr: float):
        self.params = list(params)
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update; returns the unclipped global norm (a 0-d tensor)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        scale = torch.where(norm > self.max_norm, self.max_norm / norm, 1.0)
        for g in grads:
            g.mul_(scale)
        self.adam.step()
        return norm


def make_optimizer(cfg: ExperimentConfig,
                   params: Iterable[torch.nn.Parameter]) -> ClippedAdam:
    return ClippedAdam(params, cfg.train.grad_clip_norm,
                       cfg.train.learning_rate)


@dataclass
class TrainState:
    step: int
    model: AVSeparationTransformer
    optimizer: ClippedAdam
    generators: Generators


def create_train_state(cfg: ExperimentConfig,
                       device: torch.device | str = "cuda") -> TrainState:
    """A training-mode model with weights from `cfg.train.seed`, its
    optimizer and its two generators, on `device` (the card unless the
    caller asks for 'cpu')."""
    device = resolve_device(device)
    seed = cfg.train.seed
    model = build_model(cfg.model, device=device, seed=seed).train()
    gens = Generators(seeds=torch.Generator().manual_seed(seed + 1),
                      bits=torch.Generator(device=device)
                      .manual_seed(seed + 2))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      generators=gens)


def _to_device(batch: Batch, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("mixed_spec", "lip_frames", "clean_specs"))


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(cfg: ExperimentConfig
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state, {'loss', 'grad_norm'}): one update, in
    place.  batch: mixed_spec (B, F, T), lip_frames (B, N, H, W),
    clean_specs (B, S, F, T), NumPy or tensors.  The metrics are 0-d
    tensors on the model's device (reading them synchronises)."""
    loss_cfg = cfg.loss

    def step_fn(state: TrainState, batch: Batch):
        model = state.model.train()
        mixed, frames, clean = _to_device(batch, _device_of(model))
        separated, _ = model(mixed, frames, state.generators)
        loss = separation_loss(separated, clean, l1_weight=loss_cfg.l1_weight,
                               pit_mode=loss_cfg.pit_mode, eps=loss_cfg.eps)
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step_fn


def make_eval_step() -> Callable[[torch.nn.Module, Batch],
                                 Dict[str, torch.Tensor]]:
    """(model, batch) -> input / best-permutation output SNR means and the
    mask range, with the model in eval mode (its mode is restored)."""

    @torch.no_grad()
    def eval_fn(model: torch.nn.Module, batch: Batch):
        was_training = model.training
        model.eval()
        try:
            mixed, frames, clean = _to_device(batch, _device_of(model))
            separated, masks = model(mixed, frames)
        finally:
            model.train(was_training)
        return {"input_snr": input_snr(mixed, clean).mean(),
                "output_snr": permutation_snr(separated, clean).mean(),
                "mask_min": masks.min(), "mask_max": masks.max()}

    return eval_fn
