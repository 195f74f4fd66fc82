"""Training (port of `av_separation_tpu/train.py`): train state, the update
step and the eval step, on one device or over a mesh.

  step = model in training mode -> `separation_loss` -> backward ->
         global-norm clip 1.0 -> Adam(3e-4, 0.9, 0.999, 1e-8)

as optax's `chain(clip_by_global_norm, adam)` does it (reference
demo.py:88,103).  The step runs eagerly and updates the model and the
optimizer state in place (torch's idiom; the JAX step returns a new state).
`make_fused_train_steps` runs K steps whose batches are generated on the
model's device (`data/device_synthetic.py`), with no read back to the host
in between.  Both run at the config's compute dtype (float32 or bfloat16:
parameters, gradients and the Adam state stay float32, the loss is taken
on float32 outputs) and with its remat.  Under a profiler the step's
phases are the ranges `avsep.train.forward`, `.loss`, `.backward` and
`.optimizer` (`utils.profiling.span`).

Given a mesh (`parallel/mesh.py`; every rank runs the same calls), the
state holds the rank's pieces of the parameters and of Adam's moments
(`parallel/shard.py`), a step takes the rank's rows of the global batch
(`parallel.distributed.host_local_batch_to_global`), gathers the time
blocks of the outputs over 'seq' for the loss, averages the gradients over
'data' and 'fsdp' and sums them over 'seq', and clips by the norm of the
whole gradient.  The loss and the grad norm are the global ones, the same
on every rank.  A mesh always takes this path, even when every axis is 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from av_separation_torch.config import ExperimentConfig
from av_separation_torch.data.device_synthetic import (generate_batch,
                                                       step_generator)
from av_separation_torch.losses import separation_loss
from av_separation_torch.models.layers import Generators
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              build_model, resolve_device)
from av_separation_torch.parallel import comm, shard
from av_separation_torch.parallel.mesh import split_rows
from av_separation_torch.utils.metrics import input_snr, permutation_snr
from av_separation_torch.utils.profiling import span

Batch = Mapping[str, np.ndarray | torch.Tensor]


class ClippedAdam:
    """optax `chain(clip_by_global_norm(max_norm), adam(lr))`.

    The clip is optax's: with g_norm = sqrt(sum of every gradient squared),
    the gradients are scaled by max_norm / g_norm only when g_norm >
    max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm, so it
    is another function).  Adam is `torch.optim.Adam`, whose update is
    optax's: lr * mu_hat / (sqrt(nu_hat) + eps).  Nothing leaves the device.

    Over a mesh the parameters are the rank's pieces, and `norm_weights`
    gives each piece's squared sum its weight in one all-reduce over every
    rank (`parallel.shard.norm_weights`), so that the norm is the whole
    gradient's, each piece counted once.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], max_norm: float,
                 lr: float, norm_weights: Optional[Sequence[float]] = None):
        self.params = list(params)
        self.norm_weights = norm_weights
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update; returns the unclipped global norm (a 0-d tensor)."""
        if self.norm_weights is None:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        else:
            grads = [p.grad for p in self.params]
            sq = torch.stack([g.square().sum() for g in grads])
            total = (sq * torch.tensor(self.norm_weights, dtype=sq.dtype,
                                       device=sq.device)).sum()
            dist.all_reduce(total)  # every rank of the job
            norm = total.sqrt()
        scale = torch.where(norm > self.max_norm, self.max_norm / norm, 1.0)
        for g in grads:
            g.mul_(scale)
        self.adam.step()
        return norm


def make_optimizer(cfg: ExperimentConfig,
                   params: Iterable[torch.nn.Parameter],
                   norm_weights: Optional[Sequence[float]] = None
                   ) -> ClippedAdam:
    return ClippedAdam(params, cfg.train.grad_clip_norm,
                       cfg.train.learning_rate, norm_weights)


@dataclass
class TrainState:
    step: int
    model: AVSeparationTransformer
    optimizer: ClippedAdam
    generators: Generators
    mesh: Any = None


def create_train_state(cfg: ExperimentConfig,
                       device: torch.device | str = "cuda",
                       mesh=None) -> TrainState:
    """A training-mode model with weights from `cfg.train.seed`, its
    optimizer and its two generators, on `device` (the card unless the
    caller asks for 'cpu').  With a `mesh`, the same weights cut into the
    rank's pieces by the placement rules, Adam over those pieces, and the
    device generator seeded for the rank's rows (`shard.bits_seed`)."""
    device = resolve_device(device)
    seed = cfg.train.seed
    if mesh is None:
        model = build_model(cfg.model, device=device, seed=seed).train()
        return TrainState(
            step=0, model=model,
            optimizer=make_optimizer(cfg, model.parameters()),
            generators=Generators(
                seeds=torch.Generator().manual_seed(seed + 1),
                bits=torch.Generator(device=device).manual_seed(seed + 2)))
    model = shard.shard_model(build_model(cfg.model, device="cpu",
                                          seed=seed), mesh)
    model = model.train().to(device)
    return TrainState(
        step=0, model=model,
        optimizer=make_optimizer(cfg, shard.sharded_parameters(model),
                                 shard.norm_weights(model, mesh)),
        generators=Generators(
            seeds=torch.Generator().manual_seed(seed + 1),
            bits=torch.Generator(device=device)
            .manual_seed(shard.bits_seed(seed, mesh))),
        mesh=mesh)


def _to_device(batch: Batch, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("mixed_spec", "lip_frames", "clean_specs"))


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(cfg: ExperimentConfig, mesh=None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state, {'loss', 'grad_norm'}): one update, in
    place.  batch: mixed_spec (B, F, T), lip_frames (B, N, H, W),
    clean_specs (B, S, F, T), NumPy or tensors; with a `mesh`, the rank's
    rows of the global batch.  The metrics are 0-d tensors on the model's
    device (reading them synchronises)."""
    loss_cfg = cfg.loss

    def step_fn(state: TrainState, batch: Batch):
        model = state.model.train()
        with span("train.forward"):
            mixed, frames, clean = _to_device(batch, _device_of(model))
            separated, _ = model(mixed, frames, state.generators)
            if mesh is not None:
                separated = comm.gather_time(separated, mesh)
        with span("train.loss"):
            loss = separation_loss(separated, clean,
                                   l1_weight=loss_cfg.l1_weight,
                                   pit_mode=loss_cfg.pit_mode,
                                   eps=loss_cfg.eps, mesh=mesh)
        with span("train.backward"):
            state.optimizer.zero_grad()
            loss.backward()
            if mesh is not None:
                shard.sync_grads(model, mesh)
        with span("train.optimizer"):
            grad_norm = state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step_fn


def make_fused_train_steps(cfg: ExperimentConfig, steps_per_call: int,
                           mesh=None
                           ) -> Callable[[TrainState],
                                         Tuple[TrainState, torch.Tensor]]:
    """(state) -> (state, last_loss): `steps_per_call` updates, each on a
    batch generated on the model's device from the generator of
    (cfg.train.seed + 17, state.step), as the JAX scan body keys it
    (`fold_in(key(seed + 17), step)`).  Nothing is read back to the host
    inside the K steps; the loss is a 0-d tensor on the device.  With a
    `mesh`, every rank draws the whole batch's variates and synthesizes
    its own rows (their STFT included), so row i is the same whatever the
    mesh."""
    step_fn = make_train_step(cfg, mesh)
    data_cfg, batch_size = cfg.data, cfg.train.batch_size
    seed = cfg.train.seed + 17
    rows = slice(None) if mesh is None else split_rows(batch_size, mesh)

    def multi(state: TrainState):
        device = _device_of(state.model)
        loss = None
        for _ in range(steps_per_call):
            batch = generate_batch(step_generator(seed, state.step, device),
                                   data_cfg, batch_size, rows)
            state, metrics = step_fn(state, batch)
            loss = metrics["loss"]
        return state, loss

    return multi


def make_eval_step(mesh=None) -> Callable[[torch.nn.Module, Batch],
                                          Dict[str, torch.Tensor]]:
    """(model, batch) -> input / best-permutation output SNR means and the
    mask range, with the model in eval mode (its mode is restored).  With
    a `mesh`, batch is the rank's rows and the metrics are the global
    batch's, on every rank."""

    @torch.no_grad()
    def eval_fn(model: torch.nn.Module, batch: Batch):
        was_training = model.training
        model.eval()
        try:
            mixed, frames, clean = _to_device(batch, _device_of(model))
            separated, masks = model(mixed, frames)
        finally:
            model.train(was_training)
        out = {"input_snr": input_snr(mixed, clean).mean()}
        if mesh is None:
            return {**out, "output_snr": permutation_snr(separated,
                                                         clean).mean(),
                    "mask_min": masks.min(), "mask_max": masks.max()}
        separated = comm.gather_time(separated, mesh)
        masks = comm.gather_time(masks, mesh)
        out["output_snr"] = permutation_snr(separated, clean).mean()
        out = {k: comm.mean_over_rows(v, mesh) for k, v in out.items()}
        lo, hi = masks.min(), masks.max()
        comm.all_reduce_(lo, mesh, comm.BATCH_AXES, dist.ReduceOp.MIN)
        comm.all_reduce_(hi, mesh, comm.BATCH_AXES, dist.ReduceOp.MAX)
        return {**out, "mask_min": lo, "mask_max": hi}

    return eval_fn
