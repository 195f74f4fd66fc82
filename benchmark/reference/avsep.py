"""Plain PyTorch reference of the audio-visual separation model, its
training step, its synthetic batches and its waveform serving path.

Written from the model's description, not from the program: nothing here
imports `av_separation_torch`, JAX or the JAX package.  Every function
takes its weights as a dict keyed by the model's state-dict names
(`param_spec`), made by the benchmark from the seed and handed to both
sides.

  AudioEncoder      two k=3 conv1d + ReLU, positional encoding + dropout,
                    pre-norm transformer layers (self-attention, 4d ReLU FFN)
  VisualEncoder     3 x (stride-2 3x3 conv, BatchNorm, ReLU), mean pool,
                    frame projection, the same layers, linear resampling
                    of the frame axis to the audio frames
  CrossModalFusion  cross-attention layers (audio queries, raw visual K / V,
                    4d GELU FFN), a final LayerNorm
  Decoder           Linear(d, 2d), GELU, dropout, Linear(2d, S F), sigmoid:
                    masks, times the mixture
  Loss              -SI-SNR + 0.5 L1, each item's S speakers, bins and frames
                    one vector, minimised over speaker permutations with one
                    permutation for the whole batch
  Step              global-norm clip, then Adam; parameters float32

Numerics.  The model states a compute dtype: activations are held in it and
parameters are cast to it at use, while sums run in float32 (matrix
products, the LayerNorm and BatchNorm statistics, softmax); the final
LayerNorm, the decoder and the loss run in float32 on the float32 mixture.
The reference computes every product in float32 on operands rounded to the
compute dtype (`Numerics.r`), which is what a bf16 product with a float32
accumulator computes, and rounds each activation where it is stored.
Autograd rounds the gradients at the same points.  `Numerics("fp8")` is
the control: the same computation with every such rounding made to
float8 e4m3 under a per-tensor scale, the precision below bfloat16.

Randomness.  Dropout draws are the model's rules, frozen here: residual,
positional-encoding and FFN dropout keep an element when a uint8 drawn
from a generator on the device is >= n = round(256 rate) and scale the
survivors by 1 / (1 - n / 256) rounded to the tensor's dtype; the draws
are made in forward order, one tensor a site.  Attention dropout keeps a
probability when a murmur3-finalizer hash of its tile coordinates and a
per-call int32 seed (drawn from a CPU generator) is >= rate * 2**32.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # largest float8 e4m3fn


# ---------------------------------------------------------------- numerics
class _Fp8Round(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    and the gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(x.dtype) * scale


class Numerics:
    """The rounding of stored activations and of product operands:
    'float32' (none), 'bfloat16', or the control 'fp8'."""

    def __init__(self, kind: str):
        if kind not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"numerics {kind!r}")
        self.kind = kind

    @property
    def lowered(self) -> bool:
        return self.kind != "float32"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        if self.kind == "bfloat16":
            return x.to(torch.bfloat16).to(x.dtype)
        return _Fp8Round.apply(x)

    def scale(self, n: int) -> float:
        """The dropout survivor scale 1 / (1 - n / 256) in the dtype the
        activations are stored in (bf16 for both lowered kinds)."""
        dt = torch.bfloat16 if self.lowered else torch.float32
        return float(torch.tensor(1.0 / (1.0 - n / 256.0), dtype=dt))


F32 = Numerics("float32")


# --------------------------------------------------------------- randomness
_M32 = 0xFFFFFFFF


def quantized_rate(rate: float) -> int:
    return min(max(int(round(rate * 256.0)), 1), 255)


class Draws:
    """The random draws of one training forward, in forward order: int32
    attention seeds from a CPU generator, uint8 dropout bits from a
    generator on the device."""

    def __init__(self, seeds: torch.Generator, bits: torch.Generator):
        self.seeds, self.bits = seeds, bits

    def attention_seed(self) -> int:
        x = int(torch.randint(0, 1 << 32, (1,), dtype=torch.int64,
                              generator=self.seeds)) & _M32
        return x - (1 << 32) if x >= 1 << 31 else x

    def keep(self, shape, n: int) -> torch.Tensor:
        bits = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                             device=self.bits.device, generator=self.bits)
        return bits >= n

    def snapshot(self):
        return self.seeds.get_state(), self.bits.get_state()

    def replay(self, snap) -> "Draws":
        return Draws(torch.Generator().set_state(snap[0]),
                     torch.Generator(device=self.bits.device)
                     .set_state(snap[1]))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def attention_keep(seed: int, b: int, h: int, tq: int, tk: int, rate: float,
                   device) -> torch.Tensor:
    """(B, H, Tq, Tk) keep mask of one attention call: the murmur3
    finalizer over (b * H + h, row // BQ, col // BK) and the in-tile
    (row % BQ, col % BK), BQ = min(512, ceil16(Tq)),
    BK = min(512, ceil128(Tk)); kept where hash >= rate * 2**32."""
    bq = min(512, -(-tq // 16) * 16)
    bk = min(512, -(-tk // 128) * 128)
    kw = dict(dtype=torch.int64, device=device)
    rows = torch.arange(tq, **kw)
    cols = torch.arange(tk, **kw)
    bh = torch.arange(b * h, **kw).view(b, h, 1, 1)
    tile = (((seed & _M32) * 0x9E3779B9) & _M32) ^ _mul32(bh, 0x85EBCA6B) \
        ^ _mul32(rows // bq, 0xC2B2AE35).view(tq, 1) \
        ^ _mul32(cols // bk, 0x27D4EB2F).view(1, tk)
    x = (_mul32(rows % bq, 0x01000193).view(tq, 1)
         + _mul32(cols % bk, 0x61C88647).view(1, tk) + tile) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= min(int(rate * (1 << 32)), (1 << 32) - 1)


# ---------------------------------------------------------------- weights
def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in a fixed order.
    init: 'uniform' U(+-1/sqrt(fan_in)), 'zeros' or 'ones'."""
    m = cfg["model"]
    d, f, s = m["d_model"], m["freq_bins"], m["num_speakers"]
    out: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def lin(name, n_out, n_in):
        out.append((f"{name}.weight", (n_out, n_in), "uniform", n_in))
        out.append((f"{name}.bias", (n_out,), "uniform", n_in))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "ones", 0))
        out.append((f"{name}.bias", (n,), "zeros", 0))

    def attn(name):
        out.append((f"{name}.in_proj_weight", (3 * d, d), "uniform", d))
        out.append((f"{name}.in_proj_bias", (3 * d,), "uniform", d))
        lin(f"{name}.out_proj", d, d)

    def enc_layers(prefix):
        for i in range(m["num_encoder_layers"]):
            p = f"{prefix}.transformer.layers.{i}"
            attn(f"{p}.self_attn")
            lin(f"{p}.linear1", 4 * d, d)
            lin(f"{p}.linear2", d, 4 * d)
            norm(f"{p}.norm1", d)
            norm(f"{p}.norm2", d)

    for j, (c_in, c_out) in ((0, (f, d)), (2, (d, d))):
        out.append((f"audio_encoder.input_proj.{j}.weight", (c_out, c_in, 3),
                    "uniform", 3 * c_in))
        out.append((f"audio_encoder.input_proj.{j}.bias", (c_out,),
                    "uniform", 3 * c_in))
    enc_layers("audio_encoder")
    for j, (c_in, c_out) in ((0, (1, 32)), (3, (32, 64)), (6, (64, 128))):
        out.append((f"visual_encoder.conv.{j}.weight", (c_out, c_in, 3, 3),
                    "uniform", 9 * c_in))
        out.append((f"visual_encoder.conv.{j}.bias", (c_out,), "zeros", 0))
        norm(f"visual_encoder.conv.{j + 1}", c_out)
    lin("visual_encoder.frame_proj", d, 128)
    enc_layers("visual_encoder")
    for i in range(m["num_fusion_layers"]):
        p = f"fusion.layers.{i}"
        attn(f"{p}.cross_attn")
        norm(f"{p}.norm1", d)
        norm(f"{p}.norm2", d)
        lin(f"{p}.ff.0", 4 * d, d)
        lin(f"{p}.ff.3", d, 4 * d)
    norm("fusion.norm", d)
    lin("decoder.decoder.0", 2 * d, d)
    lin("decoder.decoder.3", f * s, 2 * d)
    return out


def bn_buffers(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The BatchNorm running statistics: name -> shape (mean 0, var 1)."""
    out = {}
    for j, c in ((1, 32), (4, 64), (7, 128)):
        out[f"visual_encoder.conv.{j}.running_mean"] = (c,)
        out[f"visual_encoder.conv.{j}.running_var"] = (c,)
    return out


def make_weights(cfg: dict, seed: int, device) -> Params:
    """Every parameter from one uniform draw of a generator on `device`
    seeded with `seed`, float32: the same seed gives the same weights."""
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
            out[name] = (flat[at:at + n].view(shape)
                         * (1.0 / math.sqrt(fan_in)))
            at += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ---------------------------------------------------------------- blocks
def sinusoidal_pe(t: int, d: int) -> np.ndarray:
    pos = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * (-math.log(10000.0) / d))
    pe = np.zeros((t, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class Model:
    """The forward of one configuration at one precision; `draws` None
    means eval mode (no dropout, BatchNorm running statistics)."""

    def __init__(self, cfg: dict, nx: Numerics, remat: bool = True):
        m = cfg["model"]
        self.d, self.h = m["d_model"], m["nhead"]
        self.s, self.f = m["num_speakers"], m["freq_bins"]
        self.rate = m["dropout"]
        self.layers = (m["num_encoder_layers"], m["num_fusion_layers"])
        self.nx = nx
        self.remat = remat

    # -- pieces in the compute dtype
    def linear(self, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        r = self.nx.r
        return r(F.linear(x, r(p[name + ".weight"]), r(p[name + ".bias"])))

    def layer_norm(self, p: Params, name: str, x: torch.Tensor,
                   rounded: bool = True) -> torch.Tensor:
        y = F.layer_norm(x, (x.shape[-1],), p[name + ".weight"],
                         p[name + ".bias"], 1e-5)
        return self.nx.r(y) if rounded else y

    def dropout(self, x: torch.Tensor, draws: Optional[Draws]
                ) -> torch.Tensor:
        if draws is None or self.rate == 0.0:
            return x
        n = quantized_rate(self.rate)
        keep = draws.keep(x.shape, n)
        return self.nx.r(torch.where(keep, x * self.nx.scale(n), 0.0))

    def attention(self, p: Params, name: str, q_in: torch.Tensor,
                  kv_in: torch.Tensor, draws: Optional[Draws]
                  ) -> torch.Tensor:
        r, d, nh = self.nx.r, self.d, self.h
        w, b = r(p[name + ".in_proj_weight"]), r(p[name + ".in_proj_bias"])
        q = r(F.linear(q_in, w[:d], b[:d]))
        k = r(F.linear(kv_in, w[d:2 * d], b[d:2 * d]))
        v = r(F.linear(kv_in, w[2 * d:], b[2 * d:]))
        bsz, tq, _ = q.shape
        tk = k.shape[1]
        dh = d // nh
        qh = q.view(bsz, tq, nh, dh).transpose(1, 2)
        kh = k.view(bsz, tk, nh, dh).transpose(1, 2)
        vh = v.view(bsz, tk, nh, dh).transpose(1, 2)
        rate = self.rate if draws is not None else 0.0
        seed = draws.attention_seed() if rate > 0.0 else 0
        s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        pexp = torch.exp(s - s.detach().amax(dim=-1, keepdim=True))
        denom = pexp.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            keep = attention_keep(seed, bsz, nh, tq, tk, rate, q.device)
            pexp = torch.where(keep, pexp, 0.0)
        o = torch.matmul(r(pexp), vh) / (denom * (1.0 - rate))
        o = r(o).transpose(1, 2).reshape(bsz, tq, d)
        return self.linear(p, name + ".out_proj", o)

    def positional(self, x: torch.Tensor, draws: Optional[Draws]
                   ) -> torch.Tensor:
        pe = torch.as_tensor(sinusoidal_pe(x.shape[1], self.d),
                             device=x.device)
        return self.dropout(self.nx.r(x + self.nx.r(pe)), draws)

    def encoder_layer(self, p: Params, name: str, x: torch.Tensor,
                      draws: Optional[Draws]) -> torch.Tensor:
        r = self.nx.r
        h = self.layer_norm(p, name + ".norm1", x)
        a = self.attention(p, name + ".self_attn", h, h, draws)
        x = r(x + self.dropout(a, draws))
        h = self.linear(p, name + ".linear1",
                        self.layer_norm(p, name + ".norm2", x))
        h = torch.relu(h)
        h = self.dropout(h, draws)
        return r(x + self.dropout(self.linear(p, name + ".linear2", h),
                                  draws))

    def fusion_layer(self, p: Params, name: str, x: torch.Tensor,
                     visual: torch.Tensor, draws: Optional[Draws]
                     ) -> torch.Tensor:
        r = self.nx.r
        a = self.attention(p, name + ".cross_attn",
                           self.layer_norm(p, name + ".norm1", x), visual,
                           draws)
        x = r(x + self.dropout(a, draws))
        h = self.linear(p, name + ".ff.0",
                        self.layer_norm(p, name + ".norm2", x))
        h = r(F.gelu(h))
        h = self.dropout(h, draws)
        return r(x + self.dropout(self.linear(p, name + ".ff.3", h), draws))

    def stack(self, fn: Callable, names: List[str], x: torch.Tensor,
              rest: Tuple[torch.Tensor, ...], draws: Optional[Draws]
              ) -> torch.Tensor:
        """x through the layers in turn; in a training forward that builds
        a graph each layer is recomputed in the backward (to bound the
        reference's memory), replaying its draws."""
        for name in names:
            if not (self.remat and torch.is_grad_enabled()):
                x = fn(name, x, *rest, draws)
                continue
            snap = None if draws is None else draws.snapshot()
            ran: List[bool] = []

            def run(xx, *rr, _name=name, _snap=snap, _ran=ran):
                dd = draws if not _ran or _snap is None \
                    else draws.replay(_snap)
                _ran.append(True)
                return fn(_name, xx, *rr, dd)

            x = checkpoint(run, x, *rest, use_reentrant=False,
                           preserve_rng_state=False)
        return x

    # -- the model
    def forward(self, p: Params, mixed_spec: torch.Tensor,
                lips: torch.Tensor, draws: Optional[Draws] = None,
                bn_stats: Optional[Params] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F, T) magnitude, (B, N, H, W) frames -> separated, masks
        (B, S, F, T), float32."""
        r, d = self.nx.r, self.d
        n_enc, n_fus = self.layers
        bsz, _, t = mixed_spec.shape
        # audio projection: the convs in float32 on the rounded input
        x = r(mixed_spec)
        hid = torch.relu(F.conv1d(x, p["audio_encoder.input_proj.0.weight"],
                                  p["audio_encoder.input_proj.0.bias"],
                                  padding=1))
        y = torch.relu(F.conv1d(hid, p["audio_encoder.input_proj.2.weight"],
                                p["audio_encoder.input_proj.2.bias"],
                                padding=1))
        audio = r(y).transpose(1, 2)
        audio = self.positional(audio, draws)
        enc = lambda pre: (lambda name, xx, dd:  # noqa: E731
                           self.encoder_layer(p, name, xx, dd))
        audio = self.stack(enc("audio"), [
            f"audio_encoder.transformer.layers.{i}" for i in range(n_enc)],
            audio, (), draws)
        # visual stem
        _, n, hh, ww = lips.shape
        v = r(lips).reshape(bsz * n, 1, hh, ww)
        for j in (0, 3, 6):
            v = r(F.conv2d(v, r(p[f"visual_encoder.conv.{j}.weight"]),
                           r(p[f"visual_encoder.conv.{j}.bias"]), stride=2,
                           padding=1))
            v = torch.relu(self.batch_norm(p, f"visual_encoder.conv.{j + 1}",
                                           v, draws, bn_stats))
        v = r(v.mean(dim=(2, 3)))
        v = self.linear(p, "visual_encoder.frame_proj", v).reshape(bsz, n, d)
        v = self.positional(v, draws)
        v = self.stack(enc("visual"), [
            f"visual_encoder.transformer.layers.{i}" for i in range(n_enc)],
            v, (), draws)
        v = r(resample(v, t))
        fus = lambda name, xx, vv, dd: self.fusion_layer(  # noqa: E731
            p, name, xx, vv, dd)
        fused = self.stack(fus, [f"fusion.layers.{i}" for i in range(n_fus)],
                           audio, (v,), draws)
        fused = self.layer_norm(p, "fusion.norm", fused, rounded=False)
        # decoder, float32
        hdec = F.gelu(F.linear(fused, p["decoder.decoder.0.weight"],
                               p["decoder.decoder.0.bias"]))
        if draws is not None and self.rate > 0.0:
            nq = quantized_rate(self.rate)
            keep = draws.keep(hdec.shape, nq)
            hdec = torch.where(keep, hdec * F32.scale(nq), 0.0)
        logits = F.linear(hdec, p["decoder.decoder.3.weight"],
                          p["decoder.decoder.3.bias"])
        masks = torch.sigmoid(logits.reshape(bsz, t, self.s, self.f))
        masks = masks.permute(0, 2, 3, 1)
        return masks * mixed_spec[:, None], masks

    def batch_norm(self, p: Params, name: str, x: torch.Tensor,
                   draws: Optional[Draws], stats: Optional[Params]
                   ) -> torch.Tensor:
        if draws is not None:  # training: this batch's statistics
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        else:
            mean = stats[name + ".running_mean"]
            var = stats[name + ".running_var"]
        inv = torch.rsqrt(var + 1e-5) * p[name + ".weight"]
        y = (x - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) \
            + p[name + ".bias"].view(1, -1, 1, 1)
        return self.nx.r(y)


def resample(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """Linear resampling of axis 1 (align_corners=False), weights from
    float64 indices as float32."""
    n_in = x.shape[1]
    if n_in == t_out:
        return x
    src = np.maximum((np.arange(t_out, dtype=np.float64) + 0.5)
                     * (n_in / t_out) - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = torch.as_tensor((src - lo).astype(np.float32), device=x.device)
    w_lo = torch.as_tensor((1.0 - (src - lo)).astype(np.float32),
                           device=x.device)
    lo_t = torch.as_tensor(lo, device=x.device)
    hi_t = torch.as_tensor(hi, device=x.device)
    return x[:, lo_t] * w_lo[:, None] + x[:, hi_t] * w_hi[:, None]


# ---------------------------------------------------------------- loss
def pit_loss(separated: torch.Tensor, targets: torch.Tensor,
             l1_weight: float = 0.5, eps: float = 1e-8,
             rows: Optional[slice] = None) -> torch.Tensor:
    """min over permutations of -mean SI-SNR + l1_weight * mean |.|, in
    float64, one permutation for the whole batch; each item's speakers,
    bins and frames form one vector.  `rows` keeps only those rows."""
    if rows is not None:
        separated, targets = separated[rows], targets[rows]
    sep = separated.double()
    tgt = targets.double()
    b, s = sep.shape[:2]
    t = tgt.reshape(b, -1)
    t = t - t.mean(dim=1, keepdim=True)
    energy = (t * t).sum(dim=1, keepdim=True) + eps
    best = None
    for perm in itertools.permutations(range(s)):
        e = sep[:, list(perm)]
        l1 = (e - tgt).abs().mean()
        e = e.reshape(b, -1)
        e = e - e.mean(dim=1, keepdim=True)
        proj = (e * t).sum(dim=1, keepdim=True) / energy * t
        noise = e - proj
        snr = 10.0 * torch.log10((proj * proj).sum(dim=1)
                                 / ((noise * noise).sum(dim=1) + eps) + eps)
        loss = -snr.mean() + l1_weight * l1
        best = loss if best is None else torch.minimum(best, loss)
    return best


# ---------------------------------------------------------------- step
class Adam:
    """Global-norm clip then Adam, in float64 on float32 parameters."""

    def __init__(self, params: Params, lr: float, clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p, self.lr, self.clip = params, lr, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(v, dtype=torch.float64)
                  for k, v in params.items()}
        self.v = {k: torch.zeros_like(v, dtype=torch.float64)
                  for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradient of every leaf
        (float64), as the optimizer gets it."""
        grads = {k: v.grad.double() for k, v in self.p.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.where(norm > self.clip, self.clip / norm,
                            torch.ones_like(norm))
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k] * scale
            grads[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            p.copy_((p.double() - self.lr * upd).float())
            p.grad = None
        return grads


def train_steps(cfg: dict, weights: Params, batches: List[dict],
                draws: Draws, nx: Numerics, half_batch: bool = False
                ) -> dict:
    """The reference's first len(batches) training steps from `weights`:
    each step's loss, every leaf's norm of the first clipped gradient, and
    every leaf's norm of the parameters' change after the last step.
    `half_batch` is a planted fault: the loss of the first half of the
    rows alone."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    tr = cfg["train"]
    opt = Adam(params, tr["learning_rate"], tr["grad_clip_norm"])
    model = Model(cfg, nx)
    losses, first = [], None
    for batch in batches:
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


# ---------------------------------------------------------------- data
def step_seed(seed: int, step: int) -> int:
    """The generator seed of one generated batch: (seed, step) through
    numpy's SeedSequence, 63 bits."""
    word = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return int(word[0]) & 0x7FFF_FFFF_FFFF_FFFF


def hann(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (n_fft - 1))


def stft64(audio: torch.Tensor, n_fft: int, hop: int
           ) -> torch.Tensor:
    """Complex STFT (..., F, T) in float64: T = 1 + N // hop frames at
    i * hop, no centering, the tail zero-padded, symmetric Hann window."""
    n = audio.shape[-1]
    t = 1 + n // hop
    pad = max(0, (t - 1) * hop + n_fft - n)
    x = F.pad(audio.double(), (0, pad))
    frames = x.unfold(-1, n_fft, hop)[..., :t, :]
    w = torch.as_tensor(hann(n_fft), device=audio.device)
    return torch.fft.rfft(frames * w, dim=-1).transpose(-1, -2)


def istft64(spec: torch.Tensor, n_fft: int, hop: int, n: int
            ) -> torch.Tensor:
    """Least-squares inverse STFT of (..., F, T) complex float64: each
    frame's irfft times the window, overlap-added, divided by the summed
    squared window (floored at 1e-12); the first n samples."""
    t = spec.shape[-1]
    w = torch.as_tensor(hann(n_fft), device=spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * w
    total = (t - 1) * hop + n_fft
    out = torch.zeros(spec.shape[:-2] + (total,), dtype=torch.float64,
                      device=spec.device)
    norm = torch.zeros(total, dtype=torch.float64, device=spec.device)
    for i in range(t):
        out[..., i * hop:i * hop + n_fft] += frames[..., i, :]
        norm[i * hop:i * hop + n_fft] += w * w
    return out[..., :n] / torch.clamp(norm[:n], min=1e-12)


def lip_box(h: int, w: int) -> Tuple[int, int, int, int]:
    return h // 4, 3 * h // 4, w // 4, 3 * w // 4


def draw_batch_variates(gen: torch.Generator, data: dict, b: int) -> dict:
    """Amplitudes U(0.3, 1), frequency jitter U(0.95, 1.05), phases
    U(0, 2 pi) of (B, S), then the lip noise N(0, 0.05) of
    (B, S, frames, H/2, W/2), in that order from `gen`."""
    dev = gen.device
    s = len(data["speaker_freqs"])
    shape = (b, s)

    def uniform(lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    amps = uniform(0.3, 1.0)
    jitter = uniform(0.95, 1.05)
    phase = uniform(0.0, 2.0 * math.pi)
    h0, h1, w0, w1 = lip_box(data["frame_h"], data["frame_w"])
    noise = 0.05 * torch.randn(shape + (data["num_frames"], h1 - h0,
                                        w1 - w0), generator=gen, device=dev)
    return {"amps": amps, "jitter": jitter, "phase": phase, "noise": noise}


def tones(v: dict, data: dict) -> torch.Tensor:
    """(B, S, N) float64 tones amps * sin(w n + phase), with the angular
    step w = (2 pi / sr) * f * jitter taken in float32."""
    amps, jitter, phase = v["amps"], v["jitter"], v["phase"]
    n = int(data["sample_rate"] * data["duration"])
    dt = data["duration"] / n
    freqs = torch.stack([float(f) * jitter[:, i] for i, f in
                         enumerate(data["speaker_freqs"])], dim=1)
    w = ((2.0 * np.pi * dt) * freqs).double()
    idx = torch.arange(n, dtype=torch.float64, device=amps.device)
    return amps.double()[..., None] * torch.sin(
        w[..., None] * idx + phase.double()[..., None])


def lip_frames(clean: torch.Tensor, noise: torch.Tensor, data: dict
               ) -> torch.Tensor:
    """(B, S * frames, H, W): a box whose brightness is each video frame's
    mean-square energy x 20 (at most 1), plus the noise, clipped to [0, 1]."""
    b, s, n = clean.shape
    nf, hh, ww = data["num_frames"], data["frame_h"], data["frame_w"]
    step = n // nf
    energy = clean[..., :nf * step].reshape(b, s, nf, step).square() \
        .mean(dim=-1)
    bright = torch.clamp(energy * 20.0, max=1.0)
    patch = torch.clamp(bright[..., None, None] + noise.double(), 0.0, 1.0)
    h0, h1, w0, w1 = lip_box(hh, ww)
    frames = torch.zeros((b, s, nf, hh, ww), dtype=torch.float64,
                         device=clean.device)
    frames[..., h0:h1, w0:w1] = patch
    return frames.reshape(b, s * nf, hh, ww)


def synthetic_batch(seed: int, step: int, data: dict, b: int, device
                    ) -> Dict[str, torch.Tensor]:
    """One training batch of the on-device generator's distribution,
    float32: mixed_spec (B, F, T), lip_frames (B, S*nf, H, W),
    clean_specs (B, S, F, T)."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    v = draw_batch_variates(gen, data, b)
    clean = tones(v, data)
    mixed = clean.sum(dim=1)
    n_fft, hop = data["n_fft"], data["hop_length"]
    return {"mixed_spec": stft64(mixed, n_fft, hop).abs().float(),
            "lip_frames": lip_frames(clean, v["noise"], data).float(),
            "clean_specs": stft64(clean, n_fft, hop).abs().float()}


def requests(gen: torch.Generator, data: dict, count: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`count` serving requests of the same distribution, on the
    generator's device: mixtures (count, N) and lip frames
    (count, S*nf, H, W), float32."""
    v = draw_batch_variates(gen, data, count)
    clean = tones(v, data)
    return (clean.sum(dim=1).float(),
            lip_frames(clean, v["noise"], data).float())


@torch.no_grad()
def separate_waveform(cfg: dict, weights: Params, mixed: torch.Tensor,
                      lips: torch.Tensor, nx: Numerics
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveform serving: |STFT| of the mixture -> the eval forward -> the
    masks on the complex mixture STFT -> least-squares iSTFT.  Returns
    (waveforms (B, S, N) float64, masks (B, S, F, T) float32)."""
    data = cfg["data"]
    n_fft, hop = data["n_fft"], data["hop_length"]
    spec = stft64(mixed, n_fft, hop)
    stats = {k: (torch.zeros(s, device=mixed.device) if k.endswith("mean")
                 else torch.ones(s, device=mixed.device))
             for k, s in bn_buffers(cfg).items()}
    _, masks = Model(cfg, nx).forward(weights, spec.abs().float(), lips,
                                      None, stats)
    waves = istft64(masks.double() * spec[:, None], n_fft, hop,
                    mixed.shape[-1])
    return waves, masks
