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
XLA's convolution in the JAX package.  Float32 only.

Eval mode serves; training mode applies dropout (from the `Generators`
passed to `forward`) and BatchNorm batch statistics, as the JAX model does
with `deterministic=False`.  The decoder's fused kernel runs in eval mode or
at dropout 0; training with dropout runs the plain MLP with `gelu_dropout`,
as at `av_separation_tpu/models/model.py:309-333`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from av_separation_torch.config import ModelConfig
from av_separation_torch.models.layers import (
    Generators,
    MultiHeadAttention,
    PositionalEncoding,
    TorchBatchNorm,
    TransformerEncoder,
    bits,
    train_rate,
)
from av_separation_torch.ops.activations import gelu_dropout
from av_separation_torch.ops.dropout import Dropout
from av_separation_torch.ops.interpolate import interpolate_time_linear
from av_separation_torch.ops.kernels.audio_proj import audio_projection
from av_separation_torch.ops.kernels.decoder import mask_decoder


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return device


class AudioEncoder(nn.Module):
    """Mixed-spectrogram encoder (reference model.py:22-60)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.input_proj = nn.Sequential(
            nn.Conv1d(cfg.freq_bins, d, 3, padding=1), nn.ReLU(),
            nn.Conv1d(d, d, 3, padding=1), nn.ReLU())
        self.pos_enc = PositionalEncoding(d, cfg.dropout)
        self.transformer = TransformerEncoder(d, cfg.nhead,
                                              cfg.num_encoder_layers,
                                              cfg.dropout)

    def forward(self, x: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        conv1, conv2 = self.input_proj[0], self.input_proj[2]
        # torch Conv1d weights (out, in, k) -> the kernel's (k, in, out).
        y = audio_projection(x.transpose(1, 2).contiguous(),
                             conv1.weight.permute(2, 1, 0).contiguous(),
                             conv1.bias,
                             conv2.weight.permute(2, 1, 0).contiguous(),
                             conv2.bias)
        return self.transformer(self.pos_enc(y, gens), gens)


class VisualEncoder(nn.Module):
    """Lip-frame encoder (reference model.py:67-117): stride-2 3x3 conv + BN
    + ReLU x3 (1 -> 32 -> 64 -> 128), global average pool, frame
    projection, encoder, then linear resampling to the audio frame rate."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        layers = []
        for cin, cout in ((1, 32), (32, 64), (64, 128)):
            layers += [nn.Conv2d(cin, cout, 3, stride=2, padding=1),
                       TorchBatchNorm(cout), nn.ReLU()]
        self.conv = nn.Sequential(*layers)
        self.frame_proj = nn.Linear(128, cfg.d_model)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.dropout)
        self.transformer = TransformerEncoder(cfg.d_model, cfg.nhead,
                                              cfg.num_encoder_layers,
                                              cfg.dropout)

    def forward(self, frames: torch.Tensor, target_len: int,
                gens: Optional[Generators] = None) -> torch.Tensor:
        b, n, h, w = frames.shape
        x = self.conv(frames.reshape(b * n, 1, h, w)).mean(dim=(2, 3))
        x = self.frame_proj(x).reshape(b, n, -1)
        x = self.transformer(self.pos_enc(x, gens), gens)
        return interpolate_time_linear(x, target_len)


class CrossAttentionLayer(nn.Module):
    """Pre-norm cross-attention block (reference model.py:152-173): queries
    from norm1(audio), keys and values from the raw, un-normalised visual
    stream (the reference's quirk, kept).  The FFN keeps the reference's
    `ff` slots (Linear, GELU, dropout, Linear) and runs GELU and its
    dropout fused, with the port's quantized mask."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.dropout = cfg.dropout
        self.cross_attn = MultiHeadAttention(d, cfg.nhead, cfg.dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.ff = nn.Sequential(nn.Linear(d, 4 * d), nn.GELU(),
                                Dropout(cfg.dropout), nn.Linear(4 * d, d))
        self.drop1 = Dropout(cfg.dropout)
        self.drop2 = Dropout(cfg.dropout)

    def forward(self, audio: torch.Tensor, visual: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        attn = self.cross_attn(self.norm1(audio), visual, gens)
        audio = audio + self.drop1(attn, bits(gens))
        h = gelu_dropout(self.ff[0](self.norm2(audio)),
                         train_rate(self, self.dropout, gens), bits(gens))
        return audio + self.drop2(self.ff[3](h), bits(gens))


class CrossModalFusion(nn.Module):
    """Cross-attention stack + final LayerNorm (reference model.py:124-149)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            CrossAttentionLayer(cfg) for _ in range(cfg.num_fusion_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, audio: torch.Tensor, visual: torch.Tensor,
                gens: Optional[Generators] = None) -> torch.Tensor:
        for layer in self.layers:
            audio = layer(audio, visual, gens)
        return self.norm(audio)


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
            # torch Linear weights (out, in) -> the kernel's (in, out).
            return mask_decoder(
                fused.contiguous(), fc1.weight.t().contiguous(), fc1.bias,
                fc2.weight.t().contiguous(), fc2.bias,
                mixed_spec.contiguous(), self.num_speakers)
        b, t, _ = fused.shape
        h = gelu_dropout(fc1(fused), rate, bits(gens))
        masks = torch.sigmoid(fc2(h).reshape(b, t, self.num_speakers, -1))
        masks = masks.permute(0, 2, 3, 1)  # (B, S, F, T)
        return masks * mixed_spec[:, None], masks


class AVSeparationTransformer(nn.Module):
    """End-to-end model (reference model.py:227-276):
    (mixed_spec (B, F, T), lip_frames (B, N, H, W)) ->
    (separated (B, S, F, T), masks (B, S, F, T))."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: only float32 is "
                f"served so far")
        self.cfg = cfg
        self.audio_encoder = AudioEncoder(cfg)
        self.visual_encoder = VisualEncoder(cfg)
        self.fusion = CrossModalFusion(cfg)
        self.decoder = SeparationDecoder(cfg)

    def forward(self, mixed_spec: torch.Tensor, lip_frames: torch.Tensor,
                gens: Optional[Generators] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """In training mode with dropout > 0, `gens` must be given."""
        audio = self.audio_encoder(mixed_spec, gens)
        visual = self.visual_encoder(lip_frames, mixed_spec.shape[-1], gens)
        fused = self.fusion(audio, visual, gens)
        return self.decoder(fused, mixed_spec, gens)


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
