"""The four model components and the end-to-end AVSeparationTransformer
(port of `av_separation_tpu/models/model.py`).

  AudioEncoder      (B, F, T)    -> (B, T, d)   fused conv1d projection + encoder
  VisualEncoder     (B, N, H, W) -> (B, T, d)   conv stem + encoder + resample
  CrossModalFusion  audio x visual -> (B, T, d) audio queries, raw visual K/V
  SeparationDecoder (B, T, d)    -> (separated, masks), each (B, S, F, T)

Module names are the reference's torch names (reference model.py:22-301), so
its state dict loads as it is.  The audio projection and the mask decoder
hold their weights in the reference's `nn.Sequential` slots but run as the
fused kernels of `ops/kernels/`, with their backward rules; attention runs
through `ops/attention.py`.  The visual conv stem is `F.conv2d`, as it is
XLA's convolution in the JAX package.

`compute_dtype` "bfloat16" follows the JAX model's rules: parameters stay
float32 and are cast at use; the spectrogram and the lip frames are cast
at entry; the encoders and the fusion layers compute in bf16 (the flash
kernels and the projection kernel at bf16, LayerNorm and BatchNorm
statistics in float32); the fusion's final LayerNorm returns float32, so
the decoder runs in float32 on the float32 mixture; the outputs are
float32.  `remat` recomputes each encoder and fusion layer in the
backward, replaying its dropout draws.

Eval mode serves; training mode applies dropout (from the `Generators`
passed to `forward`) and BatchNorm batch statistics, as the JAX model does
with `deterministic=False`.  The decoder's fused kernel runs in eval mode or
at dropout 0; training with dropout runs the plain MLP with `gelu_dropout`,
as at `av_separation_tpu/models/model.py:309-333`.

Under a mesh (`parallel/shard.py`) every rank runs the model on its batch
rows, with the layers' tensor-parallel splits (`models/layers.py`).  Under
'seq' the time axis is split where the JAX model pins it to the axis: after
the audio projection (which runs on the whole T, so its k=3 convolutions
need no halo), on the visual stream, whose frames the visual encoder's
layers split too (their attention is the seq route), gathered and resampled
to T before the rank's time block is taken, and so on through the fusion
and the decoder: the outputs are the rank's time block, and
`parallel.comm.gather_time` puts T back together for the loss.

`encoder_block` "conformer" (port-only) puts conformer layers in both
encoders' stacks (`models/layers.py:ConformerLayer`); the rest of the model
is the same.  It has no mesh route yet (`parallel/shard.py` refuses it).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from av_separation_torch.config import ModelConfig
from av_separation_torch.models.layers import (
    ConformerEncoder,
    Conv2d,
    Generators,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    PositionalEncoding,
    TorchBatchNorm,
    TransformerEncoder,
    bits,
    call_layers,
    cast_once,
    cast_parameters,
    tp_part,
    train_rate,
)
from av_separation_torch.ops.activations import gelu_dropout
from av_separation_torch.ops.dropout import Dropout
from av_separation_torch.ops.interpolate import interpolate_time_linear
from av_separation_torch.ops.kernels.audio_proj import (audio_projection,
                                                     proj_input)
from av_separation_torch.ops.kernels.decoder import mask_decoder
from av_separation_torch.parallel import comm


def _cdt(cfg: ModelConfig) -> Optional[torch.dtype]:
    """The modules' dtype argument: None keeps float32 (the JAX `_cdt`),
    else torch.bfloat16."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         f"bfloat16")
    return None if cfg.compute_dtype == "float32" else torch.bfloat16


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return device


def encoder_stack(cfg: ModelConfig) -> nn.Module:
    """The layer stack of each encoder by `cfg.encoder_block`: the
    reference's pre-norm transformer layers, or (port-only) conformer
    layers.  Either sits in the reference's `transformer` slot."""
    args = (cfg.d_model, cfg.nhead, cfg.num_encoder_layers)
    if cfg.encoder_block == "conformer":
        return ConformerEncoder(*args, cfg.conv_kernel, cfg.dropout,
                                _cdt(cfg), cfg.remat)
    return TransformerEncoder(*args, cfg.dropout, _cdt(cfg), cfg.remat)


class Projection(nn.Module):
    """The fused projection kernel as a module without parameters (the
    weights stay in `AudioEncoder.input_proj`, the reference's slots), so
    that module hooks (`utils/debug.py`) read its output."""

    def forward(self, x, w1, b1, w2, b2) -> torch.Tensor:
        return audio_projection(x, w1, b1, w2, b2)


def _seq_split(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The rank's block of x along `dim` under a 'seq' axis above 1."""
    if mesh is None or comm.seq_size(mesh) == 1:
        return x
    blk = comm.seq_block(x.shape[dim], mesh)
    return x.narrow(dim, blk.start, blk.stop - blk.start)


class AudioEncoder(nn.Module):
    """Mixed-spectrogram encoder (reference model.py:22-60); its layers as
    `encoder_stack` builds them."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.input_proj = nn.Sequential(
            nn.Conv1d(cfg.freq_bins, d, 3, padding=1), nn.ReLU(),
            nn.Conv1d(d, d, 3, padding=1), nn.ReLU())
        self.projection = Projection()
        self.pos_enc = PositionalEncoding(d, cfg.dropout)
        self.transformer = encoder_stack(cfg)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        conv1, conv2 = self.input_proj[0], self.input_proj[2]
        # torch Conv1d weights (out, in, k) -> the kernel's (k, in, out);
        # x in the compute dtype (in the layout its kernel reads), y and h
        # in x's.
        y = self.projection(proj_input(x),
                            conv1.weight.permute(2, 1, 0).contiguous(),
                            conv1.bias,
                            conv2.weight.permute(2, 1, 0).contiguous(),
                            conv2.bias)
        y = _seq_split(y, 1, self.mesh)  # the JAX pin after the projection
        return self.transformer(self.pos_enc(y, gens), gens)


class VisualEncoder(nn.Module):
    """Lip-frame encoder (reference model.py:67-117): stride-2 3x3 conv + BN
    + ReLU x3 (1 -> 32 -> 64 -> 128), global average pool, frame
    projection, encoder, then linear resampling to the audio frame rate.
    Under 'seq' the encoder's layers run on the rank's block of frames;
    the frames are gathered before the resampling, and the rank's block
    of the T output steps is returned."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = _cdt(cfg)
        layers = []
        for cin, cout in ((1, 32), (32, 64), (64, 128)):
            layers += [Conv2d(cin, cout, 3, stride=2, padding=1, dtype=dt),
                       TorchBatchNorm(cout), nn.ReLU()]
        self.conv = nn.Sequential(*layers)
        self.frame_proj = Linear(128, cfg.d_model, dt)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.dropout)
        self.transformer = encoder_stack(cfg)

    def forward(self, frames: torch.Tensor, target_len: int,
                gens: Optional[Generators] = None) -> torch.Tensor:
        b, n, h, w = frames.shape
        x = self.conv(frames.reshape(b * n, 1, h, w)).mean(dim=(2, 3))
        x = self.frame_proj(x).reshape(b, n, -1)
        mesh = self.mesh
        x = self.transformer(self.pos_enc(_seq_split(x, 1, mesh), gens),
                             gens)
        if mesh is not None and comm.seq_size(mesh) > 1:
            x = comm.gather(x, 1, mesh, "seq")
        return _seq_split(interpolate_time_linear(x, target_len), 1, mesh)


class CrossAttentionLayer(nn.Module):
    """Pre-norm cross-attention block (reference model.py:152-173): queries
    from norm1(audio), keys and values from the raw, un-normalised visual
    stream (the reference's quirk, kept).  The FFN keeps the reference's
    `ff` slots (Linear, GELU, dropout, Linear) and runs GELU and its
    dropout fused, with the port's quantized mask."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, dt = cfg.d_model, _cdt(cfg)
        self.dropout = cfg.dropout
        self.cross_attn = MultiHeadAttention(d, cfg.nhead, cfg.dropout, dt)
        self.norm1 = LayerNorm(d, eps=1e-5, dtype=dt)
        self.norm2 = LayerNorm(d, eps=1e-5, dtype=dt)
        self.ff = nn.Sequential(Linear(d, 4 * d, dt, tp="column"),
                                nn.GELU(), Dropout(cfg.dropout),
                                Linear(4 * d, d, dt, tp="row"))
        self.drop1 = Dropout(cfg.dropout)
        self.drop2 = Dropout(cfg.dropout)

    def forward(self, audio: torch.Tensor, visual: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        attn = self.cross_attn(self.norm1(audio), visual, gens)
        audio = self.drop1(attn, bits(gens), residual=audio)
        h = gelu_dropout(self.ff[0](self.norm2(audio)),
                         train_rate(self, self.dropout, gens), bits(gens),
                         tp_part(self.mesh))
        return self.drop2(self.ff[3](h), bits(gens), residual=audio)


class CrossModalFusion(nn.Module):
    """Cross-attention stack + final LayerNorm (reference model.py:124-149);
    the layers are recomputed in the backward with `remat` (the JAX
    model.py:262-264).  The final norm has no dtype, as the JAX one: a
    bf16 stream comes out float32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.layers = nn.ModuleList(
            CrossAttentionLayer(cfg) for _ in range(cfg.num_fusion_layers))
        self.norm = LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, audio: torch.Tensor, visual: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        return self.norm(call_layers(self.layers, self.remat, gens, audio,
                                     visual))


class SeparationDecoder(nn.Module):
    """Per-speaker soft-mask head (reference model.py:180-220):
    Linear(d -> 2d) + GELU + Linear(2d -> S*F) + sigmoid, times the mixture.
    Runs as the fused mask-decoder kernel in eval mode or at dropout 0; in
    training with dropout, as the plain MLP with `gelu_dropout`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_speakers = cfg.num_speakers
        self.dropout = cfg.dropout
        d = cfg.d_model
        self.decoder = nn.Sequential(
            nn.Linear(d, 2 * d), nn.GELU(), Dropout(cfg.dropout),
            nn.Linear(2 * d, cfg.freq_bins * cfg.num_speakers), nn.Sigmoid())

    def forward(self, fused: torch.Tensor, mixed_spec: torch.Tensor,
                gens: Optional[Generators] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        fc1, fc2 = self.decoder[0], self.decoder[3]
        rate = train_rate(self, self.dropout, gens)
        if rate == 0.0:
            # The kernel reads the torch Linear weights as they are.
            return mask_decoder(
                fused.contiguous(), fc1.weight, fc1.bias, fc2.weight,
                fc2.bias, mixed_spec.contiguous(), self.num_speakers)
        b, t, _ = fused.shape
        h = gelu_dropout(fc1(fused), rate, bits(gens))
        masks = torch.sigmoid(fc2(h).reshape(b, t, self.num_speakers, -1))
        masks = masks.permute(0, 2, 3, 1)  # (B, S, F, T)
        return masks * mixed_spec[:, None], masks


class AVSeparationTransformer(nn.Module):
    """End-to-end model (reference model.py:227-276):
    (mixed_spec (B, F, T), lip_frames (B, N, H, W)) ->
    (separated (B, S, F, T), masks (B, S, F, T)); under a mesh, the rank's
    rows and, under 'seq', its time block of them."""

    mesh = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.audio_encoder = AudioEncoder(cfg)
        self.visual_encoder = VisualEncoder(cfg)
        self.fusion = CrossModalFusion(cfg)
        self.decoder = SeparationDecoder(cfg)

    def forward(self, mixed_spec: torch.Tensor, lip_frames: torch.Tensor,
                gens: Optional[Generators] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """In training mode with dropout > 0, `gens` must be given.  The
        inputs are cast to the compute dtype at entry, and the parameters
        that the encoders and the fusion compute in it in one op
        (`cast_once`); the decoder runs on the float32 mixture; the outputs
        are float32."""
        dt = _cdt(self.cfg)
        casts = self.__dict__.get("_casts")
        if casts is None:  # found once: the walk costs the host ~1 ms
            casts = self.__dict__["_casts"] = cast_parameters(self)
        with cast_once(casts, dt):
            audio = self.audio_encoder(
                mixed_spec if dt is None else mixed_spec.to(dt), gens)
            visual = self.visual_encoder(
                lip_frames if dt is None else lip_frames.to(dt),
                mixed_spec.shape[-1], gens)
            fused = self.fusion(audio, visual, gens)
        mixed_spec = _seq_split(mixed_spec, -1, self.mesh)
        if dt is None:
            return self.decoder(fused, mixed_spec, gens)
        separated, masks = self.decoder(fused.float(), mixed_spec, gens)
        return separated.float(), masks.float()


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw every parameter from `generator` with the JAX package's
    initializers (torch defaults): weights and biases U(+-1/sqrt(fan_in)),
    conv2d biases 0, norms at identity, BatchNorm running stats at (0, 1)."""
    def uniform_(t: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator))

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            fan_in = module.weight[0].numel()
            uniform_(module.weight, fan_in)
            uniform_(module.bias, fan_in)
        elif isinstance(module, nn.Conv2d):
            uniform_(module.weight, module.weight[0].numel())
            module.bias.zero_()
        elif isinstance(module, MultiHeadAttention):
            uniform_(module.in_proj_weight, module.d_model)
            uniform_(module.in_proj_bias, module.d_model)
        elif isinstance(module, (nn.LayerNorm, TorchBatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, TorchBatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)


def build_model(cfg: ModelConfig, *, device: torch.device | str = "cuda",
                seed: int = 0) -> AVSeparationTransformer:
    """An eval-mode model with weights drawn from a `torch.Generator` seeded
    with `seed`, on `device` (the card unless the caller asks for 'cpu')."""
    device = resolve_device(device)
    model = AVSeparationTransformer(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)
