"""The system under test: the port's objects built from a configuration
file and the weights the benchmark made.  This is the one module of the
harness that names the port's configuration and model classes."""

from __future__ import annotations

from typing import Dict

import torch

from av_separation_torch.config import (DataConfig, ExperimentConfig,
                                        LossConfig, ModelConfig, TrainConfig)
from av_separation_torch.models.model import AVSeparationTransformer


def experiment(cfg: dict, batch_size: int = 1) -> ExperimentConfig:
    """The port's ExperimentConfig of a configuration file (no mesh: the
    cell runs on one chip)."""
    data = dict(cfg["data"])
    data["speaker_freqs"] = tuple(data["speaker_freqs"])
    return ExperimentConfig(
        name=cfg["name"], model=ModelConfig(**cfg["model"]),
        data=DataConfig(**data),
        loss=LossConfig(l1_weight=cfg["loss"]["l1_weight"],
                        pit_mode=cfg["loss"]["pit_mode"],
                        eps=cfg["loss"]["eps"]),
        train=TrainConfig(batch_size=batch_size,
                          learning_rate=cfg["train"]["learning_rate"],
                          grad_clip_norm=cfg["train"]["grad_clip_norm"]))


def state_dict(weights: Dict[str, torch.Tensor],
               buffers: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The model's state dict: the weights and BatchNorm's running
    statistics at their initial values (mean 0, variance 1, no batches)."""
    out = dict(weights)
    dev = next(iter(weights.values())).device
    for name, shape in buffers.items():
        fill = 0.0 if name.endswith("running_mean") else 1.0
        out[name] = torch.full(shape, fill, device=dev)
        count = name.rsplit(".", 1)[0] + ".num_batches_tracked"
        out[count] = torch.zeros((), dtype=torch.long, device=dev)
    return out


def model(exp: ExperimentConfig, weights: Dict[str, torch.Tensor],
          buffers: Dict[str, tuple], device) -> AVSeparationTransformer:
    """The port's model with these weights, on `device`: built on the meta
    device and materialised there, so no weight is drawn on the host."""
    with torch.device("meta"):
        net = AVSeparationTransformer(exp.model)
    net = net.to_empty(device=device)
    sd = state_dict(weights, buffers)
    names = set(dict(net.named_parameters())) | set(dict(net.named_buffers()))
    if names != set(sd):
        raise ValueError(f"the port's parameters differ from the "
                         f"configuration's: {sorted(names ^ set(sd))}")
    net.load_state_dict(sd)
    return net
