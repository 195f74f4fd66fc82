"""Weights carried into the port: JAX variables or reference goldens -> a
`state_dict` for `models.model.AVSeparationTransformer`.

`from_jax_variables` is the inverse of
`av_separation_tpu/utils/transplant.py:from_reference_state_dict`:
  - flax Dense kernels (in, out) -> torch Linear weights (out, in);
  - the separate q/k/v Dense layers -> one `in_proj_weight` (3d, d) of the
    transposed kernels, concatenated, and `in_proj_bias`;
  - flax conv1d (k, in, out) -> (out, in, k); conv2d (kh, kw, in, out) ->
    (out, in, kh, kw);
  - 'batch_stats' -> BatchNorm running stats (num_batches_tracked = 0).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from av_separation_torch.models.layers import sinusoidal_pe

Tree = Mapping[str, object]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _linear(p: Tree, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(np.asarray(p["kernel"]).T),
            f"{name}.bias": _t(p["bias"])}


def _layernorm(p: Tree, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(p["scale"]), f"{name}.bias": _t(p["bias"])}


def _mha(p: Tree, name: str) -> Dict[str, torch.Tensor]:
    qkv = ("q_proj", "k_proj", "v_proj")
    return {
        f"{name}.in_proj_weight": _t(np.concatenate(
            [np.asarray(p[n]["kernel"]).T for n in qkv], axis=0)),
        f"{name}.in_proj_bias": _t(np.concatenate(
            [np.asarray(p[n]["bias"]) for n in qkv])),
        **_linear(p["out_proj"], f"{name}.out_proj"),
    }


def _transformer(p: Tree, name: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        layer, pre = p[f"layer_{i}"], f"{name}.layers.{i}"
        sd.update(_mha(layer["self_attn"], f"{pre}.self_attn"))
        for part in ("linear1", "linear2"):
            sd.update(_linear(layer[part], f"{pre}.{part}"))
        for part in ("norm1", "norm2"):
            sd.update(_layernorm(layer[part], f"{pre}.{part}"))
    return sd


def from_jax_variables(variables: Tree) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the JAX model, as NumPy
    arrays -> a state_dict that `load_state_dict` takes strictly."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    ae = params["audio_encoder"]
    for conv, slot in (("conv1", 0), ("conv2", 2)):
        pre = f"audio_encoder.input_proj.{slot}"
        sd[f"{pre}.weight"] = _t(
            np.asarray(ae[conv]["kernel"]).transpose(2, 1, 0))
        sd[f"{pre}.bias"] = _t(ae[conv]["bias"])
    sd.update(_transformer(ae["transformer"], "audio_encoder.transformer"))

    ve, ve_stats = params["visual_encoder"], stats["visual_encoder"]
    # Reference conv stem slots: conv at 0/3/6, BatchNorm at 1/4/7.
    for j, (ci, bi) in enumerate(((0, 1), (3, 4), (6, 7)), start=1):
        pre = "visual_encoder.conv"
        sd[f"{pre}.{ci}.weight"] = _t(
            np.asarray(ve[f"conv{j}"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{pre}.{ci}.bias"] = _t(ve[f"conv{j}"]["bias"])
        sd[f"{pre}.{bi}.weight"] = _t(ve[f"bn{j}"]["scale"])
        sd[f"{pre}.{bi}.bias"] = _t(ve[f"bn{j}"]["bias"])
        sd[f"{pre}.{bi}.running_mean"] = _t(ve_stats[f"bn{j}"]["mean"])
        sd[f"{pre}.{bi}.running_var"] = _t(ve_stats[f"bn{j}"]["var"])
        sd[f"{pre}.{bi}.num_batches_tracked"] = torch.tensor(0)
    sd.update(_linear(ve["frame_proj"], "visual_encoder.frame_proj"))
    sd.update(_transformer(ve["transformer"], "visual_encoder.transformer"))

    fusion = params["fusion"]
    for i in range(len(fusion) - 1):  # layer_0 .. layer_{n-1}, plus 'norm'
        layer, pre = fusion[f"layer_{i}"], f"fusion.layers.{i}"
        sd.update(_mha(layer["cross_attn"], f"{pre}.cross_attn"))
        sd.update(_linear(layer["ff1"], f"{pre}.ff.0"))
        sd.update(_linear(layer["ff2"], f"{pre}.ff.3"))
        for part in ("norm1", "norm2"):
            sd.update(_layernorm(layer[part], f"{pre}.{part}"))
    sd.update(_layernorm(fusion["norm"], "fusion.norm"))

    dec = params["decoder"]
    sd.update(_linear(dec["fc1"], "decoder.decoder.0"))
    sd.update(_linear(dec["fc2"], "decoder.decoder.3"))
    return sd


def load_reference_state_dict(npz_path: str) -> Dict[str, torch.Tensor]:
    """The reference state dict stored under 'w::<name>' in a golden .npz.

    The reference's `*.pos_enc.pe` tables have no parameter here (the PE is
    computed for each input's length); each is checked against
    `sinusoidal_pe` and dropped, so the rest loads with `strict=True`.  The
    reference built its table in float32, whose rounding of the angle
    reaches 4e-4 by row 5000, hence the check's 1e-3.
    """
    sd: Dict[str, torch.Tensor] = {}
    with np.load(npz_path) as data:
        for key in data.files:
            if not key.startswith("w::"):
                continue
            name, value = key[len("w::"):], data[key]
            if name.endswith(".pos_enc.pe"):
                table = value.reshape(value.shape[-2:])
                ours = sinusoidal_pe(*table.shape).numpy()
                if not np.allclose(table, ours, rtol=0.0, atol=1e-3):
                    raise ValueError(f"{name} is not the sinusoidal table")
                continue
            sd[name] = torch.from_numpy(np.array(value))
    return sd
