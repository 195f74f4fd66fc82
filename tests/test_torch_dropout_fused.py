"""The fused dropout sites (`ops/kernels/dropout_fused.py`) on the CPU.

On the CPU every site runs the plain version, which must be the chain of
PyTorch ops the model ran before the fused kernels, bit for bit, forward
and backward (the CUDA kernels are held against the plain version on the
card by chip_smoke.py).  Besides: a dropped NaN gives 0, a TP rank's
column block takes the bits of the full-width draw, the saved mask is the
uint8 draw, eval mode and rate 0 never reach the fused op, and a training
step makes one forward and one backward call a site (two forwards under
remat), which is what the card's launch counts are held to.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av_separation_torch import config as tc
from av_separation_torch.ops import kernels, upcast
from av_separation_torch.ops.activations import gelu_dropout, relu_dropout
from av_separation_torch.ops.dropout import (Dropout, keep_bits, keep_scale,
                                             quantized_rate)
from av_separation_torch.ops.kernels import dropout_fused
from av_separation_torch.ops.kernels.dropout_fused import (EPILOGUES,
                                                           fused_dropout,
                                                           row_stride)
from av_separation_torch.train import create_train_state, make_train_step

DTYPES = [torch.float32, torch.bfloat16]
N = quantized_rate(0.1)


def rand(shape, seed, dtype=torch.float32, scale=2.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def chain(kind, x, res, keep, s, g):
    """The model's ops before the fusion: the output and dx (each
    `ops/dropout.py` / `ops/activations.py` formula as it stood)."""
    if kind == "relu_dropout":
        out = torch.where(keep, torch.relu(x) * s, 0.0)
        return out, torch.where(out > 0, g * s, 0.0)
    if kind == "gelu_dropout":
        xf = upcast(x)
        out = torch.where(keep, F.gelu(xf).to(x.dtype) * s, 0.0)
        cdf = 0.5 * (1.0 + torch.erf(xf * (1.0 / math.sqrt(2.0))))
        pdf = torch.exp(-0.5 * xf * xf) * (1.0 / math.sqrt(2.0 * math.pi))
        dgelu = (cdf + xf * pdf).to(x.dtype)
        return out, torch.where(keep, g * dgelu * s, 0.0)
    out = torch.where(keep, x * s, 0.0)
    if kind == "dropout_add":
        out = res + out
    return out, torch.where(keep, g * s, 0.0)


def fused(kind, x, res, bits, s, g):
    """Output, dx and d res (None without a residual) through autograd."""
    x = x.clone().requires_grad_()
    res = None if kind != "dropout_add" else res.clone().requires_grad_()
    out = fused_dropout(kind, x, bits, N, s, res)
    out.backward(g)
    return out.detach(), x.grad, None if res is None else res.grad


class TestPlainVersion:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kind", EPILOGUES)
    def test_is_the_chain_bit_for_bit(self, kind, dtype):
        shape = (3, 37, 48)
        x, res, g = (rand(shape, i, dtype) for i in (1, 2, 3))
        bits = keep_bits(shape, torch.Generator().manual_seed(4), "cpu")
        s = keep_scale(N, dtype)
        want, want_dx = chain(kind, x, res, bits >= N, s, g)
        out, dx, dres = fused(kind, x, res, bits, s, g)
        assert out.dtype == dtype and dx.dtype == dtype
        assert torch.equal(out, want)
        assert torch.equal(dx, want_dx)
        if kind == "dropout_add":
            assert torch.equal(dres, g)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kind", EPILOGUES)
    def test_a_dropped_nan_gives_zero(self, kind, dtype):
        shape = (4, 64)
        bits = keep_bits(shape, torch.Generator().manual_seed(5), "cpu")
        dropped = bits < N
        assert dropped.any() and not dropped.all()
        x, res = rand(shape, 6, dtype), rand(shape, 7, dtype)
        g = rand(shape, 8, dtype)
        x[dropped] = float("nan")
        g[dropped] = float("nan")
        out, dx, _ = fused(kind, x, res, bits, keep_scale(N, dtype), g)
        want = res[dropped] if kind == "dropout_add" else 0.0
        assert torch.equal(out[dropped], torch.zeros_like(out[dropped])
                           + want)
        if kind != "relu_dropout":  # relu reads its output, zero there
            assert torch.equal(dx[dropped], torch.zeros_like(dx[dropped]))
        assert not out[~dropped].isnan().any()

    @pytest.mark.parametrize("kind,saved", [
        ("dropout", [torch.uint8]), ("dropout_add", [torch.uint8]),
        ("relu_dropout", [torch.bfloat16]),
        ("gelu_dropout", [torch.bfloat16, torch.uint8])])
    def test_the_backward_keeps_the_draw_not_a_bool_mask(self, kind, saved):
        x = rand((8, 32), 9, torch.bfloat16).requires_grad_()
        bits = keep_bits(x.shape, torch.Generator().manual_seed(1), "cpu")
        got = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: got.append(t.dtype) or t, lambda t: t):
            fused_dropout(kind, x, bits, N, keep_scale(N, x.dtype),
                          x.detach() if kind == "dropout_add" else None)
        assert got == saved


class TestDraws:
    @pytest.mark.parametrize("part", [(0, 2), (1, 2), (3, 4)])
    def test_a_column_block_takes_the_full_width_bits(self, part):
        i, count = part
        shape = (2, 5, 32)
        full = keep_bits(shape[:-1] + (32 * count,),
                         torch.Generator().manual_seed(11), "cpu")
        mine = keep_bits(shape, torch.Generator().manual_seed(11), "cpu",
                         part)
        assert mine.dtype == torch.uint8
        assert torch.equal(mine, full[..., 32 * i:32 * (i + 1)])
        assert row_stride(mine) == 32 * count
        x_full = rand(full.shape, 12)
        x = x_full[..., 32 * i:32 * (i + 1)].contiguous()
        for act in (relu_dropout, gelu_dropout):
            whole = act(x_full, 0.1, torch.Generator().manual_seed(11))
            block = act(x, 0.1, torch.Generator().manual_seed(11), part)
            assert torch.equal(block, whole[..., 32 * i:32 * (i + 1)])

    def test_row_stride_takes_only_rows_of_a_draw(self):
        bits = torch.zeros(3, 4, 64, dtype=torch.uint8)
        assert row_stride(bits) == 64
        assert row_stride(bits[..., 16:48]) == 64
        assert row_stride(bits[0, 0]) == 64
        with pytest.raises(ValueError, match="rows"):
            row_stride(bits.transpose(0, 1))
        with pytest.raises(ValueError, match="rows"):
            row_stride(bits[..., ::2])


MODEL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=2,
             num_fusion_layers=1, num_speakers=2)
DATA = dict(num_samples=4, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)


def small(dropout=0.1, dtype="float32", remat=False):
    return tc.ExperimentConfig(
        name="dropout_fused", model=tc.ModelConfig(
            **MODEL, dropout=dropout, compute_dtype=dtype, remat=remat),
        data=tc.DataConfig(**DATA), train=tc.TrainConfig(batch_size=2))


def batch(b=2):
    d = tc.DataConfig(**DATA)
    rng = np.random.default_rng(0)
    t = d.num_stft_frames
    return {"mixed_spec": np.abs(rng.normal(size=(b, d.freq_bins, t))
                                 ).astype(np.float32),
            "lip_frames": rng.uniform(size=(b, d.total_lip_frames,
                                            d.frame_h, d.frame_w)
                                      ).astype(np.float32),
            "clean_specs": np.abs(rng.normal(size=(b, 2, d.freq_bins, t))
                                  ).astype(np.float32)}


@pytest.fixture
def calls(monkeypatch):
    """(direction, kind, dtype) of every forward and backward of a site."""
    seen = []
    for direction in ("fwd", "bwd"):
        real = getattr(dropout_fused, f"dropout_{direction}")

        def spy(kind, a, *rest, _real=real, _direction=direction):
            seen.append((_direction, kind, a.dtype))
            return _real(kind, a, *rest)

        monkeypatch.setattr(dropout_fused, f"dropout_{direction}", spy)
    return seen


def want_calls(m: tc.ModelConfig, low: torch.dtype, remat: bool) -> dict:
    """Calls of a step by (direction, kind, dtype): the two PE sites;
    drop1 and drop2 of every layer, the encoders' ReLU and the fusion's
    GELU FFN, whose forwards run twice under remat; the decoder's GELU,
    float32 in a bf16 model too."""
    enc, fus = 2 * m.num_encoder_layers, m.num_fusion_layers
    want = {("fwd", "dropout", low): 2, ("bwd", "dropout", low): 2}
    for kind, n in (("dropout_add", 2 * (enc + fus)), ("relu_dropout", enc),
                    ("gelu_dropout", fus)):
        want[("fwd", kind, low)] = n * (2 if remat else 1)
        want[("bwd", kind, low)] = n
    for direction in ("fwd", "bwd"):
        key = (direction, "gelu_dropout", torch.float32)
        want[key] = want.get(key, 0) + 1
    return want


class TestSites:
    @pytest.mark.parametrize("dtype,remat", [
        ("float32", False), ("float32", True), ("bfloat16", False),
        ("bfloat16", True)])
    def test_one_call_a_site_each_way(self, calls, dtype, remat):
        cfg = small(dtype=dtype, remat=remat)
        state = create_train_state(cfg, device="cpu")
        make_train_step(cfg)(state, batch())
        low = torch.float32 if dtype == "float32" else torch.bfloat16
        got = {}
        for key in calls:
            got[key] = got.get(key, 0) + 1
        assert got == want_calls(cfg.model, low, remat)

    @pytest.mark.parametrize("how", ["eval", "rate0"])
    def test_eval_and_rate_zero_never_reach_the_fused_op(self, monkeypatch,
                                                         how):
        def refuse(*_):
            raise AssertionError("the fused op was reached")

        monkeypatch.setattr(dropout_fused.FusedDropout, "apply", refuse)
        kernels.reset_launch_counts()
        if how == "eval":
            cfg = small()
            state = create_train_state(cfg, device="cpu")
            b = batch()
            with torch.no_grad():
                state.model.eval()(torch.as_tensor(b["mixed_spec"]),
                                   torch.as_tensor(b["lip_frames"]))
        else:
            cfg = small(dropout=0.0)
            state = create_train_state(cfg, device="cpu")
            make_train_step(cfg)(state, batch())
        assert not any(kernels.LAUNCHES.values())
        x = rand((4, 16), 3)
        assert Dropout(0.1).eval()(x, None, residual=x).equal(x + x)
        assert Dropout(0.0).train()(x, None, residual=x).equal(x + x)


def test_the_residual_gradient_is_the_incoming_one():
    """dropout_add hands g to the residual as it is: no copy."""
    x = rand((4, 32), 1).requires_grad_()
    res = rand((4, 32), 2).requires_grad_()
    bits = keep_bits(x.shape, torch.Generator().manual_seed(0), "cpu")
    out = fused_dropout("dropout_add", x, bits, N, keep_scale(N), res)
    g = rand((4, 32), 3)
    (dx, dres) = torch.autograd.grad(out, (x, res), g)
    assert torch.equal(dres, g)
