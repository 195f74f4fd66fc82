"""Plain PyTorch reference of the audio-visual separation model with
conformer blocks in both encoders (`encoder_block` "conformer"), and its
training step: the interface `avsep.py` gives a training cell.

Written from the block's description (Gulati et al. 2020, "Conformer:
Convolution-augmented Transformer for Speech Recognition",
arXiv:2005.08100), not from the program: nothing here imports
`av_separation_torch`, JAX or the JAX package.  Everything but the encoder
layers is `avsep.py`'s, loaded from its file: the data, the dropout draws,
the numerics and their control, the attention, the audio projection, the
visual stem, the fusion, the decoder, the loss, the per-layer recompute
and Adam.  Each encoder layer (LN: LayerNorm; Drop: the dropout sites):

    x = x + Drop(W2 Drop(SiLU(W1 LN(x)))) / 2                  FFN1
    x = x + Drop(MHSA(LN(x)))                                  avsep's attention
    x = x + Drop(P2 SiLU(BN(DWConv_K(GLU(P1 LN(x))))))         convolution module
    x = x + Drop(W4 Drop(SiLU(W3 LN(x)))) / 2                  FFN2
    y = LN(x)

P1 is Linear(d, 2d), GLU(a || b) = a sigmoid(b), DWConv_K a depthwise
convolution over time (kernel K, centred zero padding, a bias), BN a
BatchNorm over (batch, time) with the batch's statistics in training and
the running ones in eval, P2 Linear(d, d); the FFNs are 4d wide.

Departures from the paper: MHSA has no relative-position term (as
`torchaudio.models.Conformer`; the sinusoidal encoding at the encoder's
input stays); K is odd (31 where the paper's table has 32, as ESPnet,
NeMo and torchaudio), so the padding is centred.

Rounding points in the compute dtype (`Numerics.r`, bf16 or the float8
control), beyond avsep's rules (products on rounded operands, activations
rounded where stored): each LayerNorm's output; each Linear's output;
SiLU's output in the FFNs, then the dropout's; the halved residual
branch's dropout output; GLU and the depthwise convolution in float32 on
the rounded P1 output, with GLU's output NOT rounded (the port's kernel
keeps it in float32), the convolution's output rounded; BatchNorm in
float32 on it, rounded; SiLU rounded; each residual sum rounded.  The
halved residual is x + r(keep ? y (s / 2) : 0), s the survivor scale in
the compute dtype (halving is exact), and x + r(y / 2) in eval.

The draws, in forward order, one tensor a site: FFN1's SiLU dropout and
its residual's, the attention's seed, its residual's, the convolution
module's residual's, FFN2's SiLU dropout and its residual's.
"""

from __future__ import annotations

import importlib.util
import math
import re
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def _load_base():
    path = Path(__file__).resolve().parent / "avsep.py"
    spec = importlib.util.spec_from_file_location("avsep_conformer_base",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


avsep = _load_base()
Params = avsep.Params
Draws = avsep.Draws
Numerics = avsep.Numerics
synthetic_batch = avsep.synthetic_batch
requests = avsep.requests
pit_loss = avsep.pit_loss
quantized_rate = avsep.quantized_rate


# ---------------------------------------------------------------- weights
def _encoder_layer_spec(p: str, d: int, k: int
                        ) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    out: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def lin(name, n_out, n_in):
        out.append((f"{name}.weight", (n_out, n_in), "uniform", n_in))
        out.append((f"{name}.bias", (n_out,), "uniform", n_in))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ones", 0))
        out.append((f"{name}.bias", (d,), "zeros", 0))

    def ffn(name):
        norm(f"{name}.norm")
        lin(f"{name}.linear1", 4 * d, d)
        lin(f"{name}.linear2", d, 4 * d)

    ffn(f"{p}.ffn1")
    norm(f"{p}.norm_attn")
    out.append((f"{p}.self_attn.in_proj_weight", (3 * d, d), "uniform", d))
    out.append((f"{p}.self_attn.in_proj_bias", (3 * d,), "uniform", d))
    lin(f"{p}.self_attn.out_proj", d, d)
    norm(f"{p}.conv.norm")
    lin(f"{p}.conv.pointwise1", 2 * d, d)
    out.append((f"{p}.conv.depthwise.weight", (d, 1, k), "uniform", k))
    out.append((f"{p}.conv.depthwise.bias", (d,), "uniform", k))
    norm(f"{p}.conv.batch_norm")
    lin(f"{p}.conv.pointwise2", d, d)
    ffn(f"{p}.ffn2")
    norm(f"{p}.norm_out")
    return out


_ENCODER_LAYER = re.compile(r"^(\w+_encoder\.transformer\.layers\.\d+)\.")


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in a fixed order:
    avsep's, with each encoder layer's entries replaced by the conformer
    layer's (the depthwise weight and bias at fan-in K)."""
    m = cfg["model"]
    d, k = m["d_model"], m["conv_kernel"]
    out, done = [], set()
    for entry in avsep.param_spec(cfg):
        found = _ENCODER_LAYER.match(entry[0])
        if found is None:
            out.append(entry)
            continue
        layer = found.group(1)
        if layer not in done:
            done.add(layer)
            out.extend(_encoder_layer_spec(layer, d, k))
    return out


def bn_buffers(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The BatchNorm running statistics: the visual stem's and every
    convolution module's, name -> shape (mean 0, var 1)."""
    m = cfg["model"]
    out = dict(avsep.bn_buffers(cfg))
    for enc in ("audio_encoder", "visual_encoder"):
        for i in range(m["num_encoder_layers"]):
            p = f"{enc}.transformer.layers.{i}.conv.batch_norm"
            out[f"{p}.running_mean"] = (m["d_model"],)
            out[f"{p}.running_var"] = (m["d_model"],)
    return out


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter from one uniform draw of a generator on `device`
    seeded with `seed`, float32, in `param_spec`'s order."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, init, _ in spec
                if init == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, at = {}, 0
    for name, shape, init, fan_in in spec:
        if init == "uniform":
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape) * (1.0 / math.sqrt(fan_in))
            at += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------- model
class Model(avsep.Model):
    """avsep's model with conformer layers in both encoders."""

    def __init__(self, cfg: dict, nx: Numerics, remat: bool = True):
        super().__init__(cfg, nx, remat)
        self.k = cfg["model"]["conv_kernel"]
        self.bn_stats: Optional[Params] = None

    def forward(self, p: Params, mixed_spec: torch.Tensor,
                lips: torch.Tensor, draws: Optional[Draws] = None,
                bn_stats: Optional[Params] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        self.bn_stats = bn_stats
        return super().forward(p, mixed_spec, lips, draws, bn_stats)

    def half_residual(self, x: torch.Tensor, y: torch.Tensor,
                      draws: Optional[Draws]) -> torch.Tensor:
        """x + Drop(y) / 2: the survivor scale halved."""
        r = self.nx.r
        if draws is None or self.rate == 0.0:
            return r(x + r(0.5 * y))
        n = quantized_rate(self.rate)
        keep = draws.keep(y.shape, n)
        return r(x + r(torch.where(keep, y * (0.5 * self.nx.scale(n)), 0.0)))

    def ffn(self, p: Params, name: str, x: torch.Tensor,
            draws: Optional[Draws]) -> torch.Tensor:
        h = self.linear(p, name + ".linear1",
                        self.layer_norm(p, name + ".norm", x))
        h = self.dropout(self.nx.r(F.silu(h)), draws)
        return self.linear(p, name + ".linear2", h)

    def conv_module(self, p: Params, name: str, x: torch.Tensor,
                    draws: Optional[Draws]) -> torch.Tensor:
        r, d, k = self.nx.r, self.d, self.k
        u = self.linear(p, name + ".pointwise1",
                        self.layer_norm(p, name + ".norm", x))
        g = F.glu(u, dim=-1)  # float32, not rounded
        y = F.conv1d(g.transpose(1, 2), r(p[name + ".depthwise.weight"]),
                     r(p[name + ".depthwise.bias"]), padding=(k - 1) // 2,
                     groups=d)
        y = r(y).transpose(1, 2)
        bn = name + ".batch_norm"
        if draws is not None:  # training: this batch's statistics
            mean = y.mean(dim=(0, 1))
            var = (y - mean).square().mean(dim=(0, 1))
        else:
            mean = self.bn_stats[bn + ".running_mean"]
            var = self.bn_stats[bn + ".running_var"]
        inv = torch.rsqrt(var + 1e-5) * p[bn + ".weight"]
        h = r((y - mean) * inv + p[bn + ".bias"])
        return self.linear(p, name + ".pointwise2", r(F.silu(h)))

    def encoder_layer(self, p: Params, name: str, x: torch.Tensor,
                      draws: Optional[Draws]) -> torch.Tensor:
        r = self.nx.r
        x = self.half_residual(x, self.ffn(p, name + ".ffn1", x, draws),
                               draws)
        h = self.layer_norm(p, name + ".norm_attn", x)
        a = self.attention(p, name + ".self_attn", h, h, draws)
        x = r(x + self.dropout(a, draws))
        x = r(x + self.dropout(self.conv_module(p, name + ".conv", x, draws),
                               draws))
        x = self.half_residual(x, self.ffn(p, name + ".ffn2", x, draws),
                               draws)
        return self.layer_norm(p, name + ".norm_out", x)


# ---------------------------------------------------------------- step
@contextmanager
def exact_float32():
    """float32 products and convolutions in full float32, not TF32 (the
    card's cuDNN default), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_steps(cfg: dict, weights: Params, batches: List[dict],
                draws: Draws, nx: Numerics, half_batch: bool = False
                ) -> dict:
    """avsep's `train_steps` over this model: each step's loss, every
    leaf's norm of the first clipped gradient, every leaf's norm of the
    parameters' change after the last step.  `half_batch` is the planted
    fault: the loss of the first half of the rows alone."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    tr = cfg["train"]
    opt = avsep.Adam(params, tr["learning_rate"], tr["grad_clip_norm"])
    model = Model(cfg, nx)
    losses, first = [], None
    for batch in batches:
        with exact_float32():
            sep, _ = model.forward(params, batch["mixed_spec"],
                                   batch["lip_frames"], draws)
            b = sep.shape[0]
            loss = pit_loss(sep, batch["clean_specs"],
                            cfg["loss"]["l1_weight"], cfg["loss"]["eps"],
                            slice(0, b // 2) if half_batch else None)
            loss.backward()
        del sep
        grads = opt.step()
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(g.norm()) for k, g in grads.items()}
        del grads
    change = {k: float((params[k].detach().double()
                        - start[k].double()).norm()) for k in params}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


@torch.no_grad()
def eval_forward(cfg: dict, weights: Params, mixed_spec: torch.Tensor,
                 lips: torch.Tensor, nx: Numerics,
                 stats: Optional[Params] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (no dropout; BatchNorm's running statistics,
    `stats` or the initial (0, 1)): (separated, masks)."""
    if stats is None:
        dev = mixed_spec.device
        stats = {k: (torch.zeros(s, device=dev) if k.endswith("mean")
                     else torch.ones(s, device=dev))
                 for k, s in bn_buffers(cfg).items()}
    with exact_float32():
        return Model(cfg, nx).forward(weights, mixed_spec, lips, None, stats)
