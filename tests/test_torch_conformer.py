"""The conformer block (`ModelConfig.encoder_block` "conformer", port-only)
against its plain reference `benchmark/reference/avsep_conformer.py` on the
CPU, at a small size (d 64, 4 heads, 2 + 1 layers, K 7, T 41, 2 x 10 lips
of 16 x 16) on the reference's seeded weights.

Tolerances.  float32: the two sides sum in other orders (PyTorch's CPU
kernels against the reference's float32 ops), ~1e-7 relative a sum; the
model's depth brings the worst leaf to ~5e-6 of the median leaf's scale,
so 1e-4 (the reference in bf16 reads 1e-1 there).  bf16: each side rounds
at the same points, but a product's float32 sum rounds to another bf16
neighbour now and then; ~1e-2 of the median leaf at worst, so 5e-2 (the
float8 control reads 0.8).  A leaf's gap is its largest elementwise
difference over the larger of its own largest gradient and the median
leaf's: the depthwise and stem conv biases feed a BatchNorm with batch
statistics, so their true gradient is 0 and what they hold is round-off.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import statistics
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from av_separation_torch import config as tc
from av_separation_torch.inference import Separator
from av_separation_torch.losses import separation_loss
from av_separation_torch.models.layers import (ConformerLayer, Generators,
                                               LayerNorm, TorchBatchNorm,
                                               cast_parameters, remat_layer)
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              build_model)
from av_separation_torch.ops.activations import silu_dropout
from av_separation_torch.ops.dropout import keep_bits, keep_scale
from av_separation_torch.ops.kernels.glu_dwconv import glu_dwconv
from av_separation_torch.parallel.shard import shard_model
from av_separation_torch.train import create_train_state, make_train_step
from av_separation_torch.utils import roofline

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R = _load(BENCH / "reference" / "avsep_conformer.py", "avsep_conformer_ref")

CFG = {"name": "tiny_conformer",
       "model": {"freq_bins": 33, "d_model": 64, "nhead": 4,
                 "num_encoder_layers": 2, "num_fusion_layers": 1,
                 "num_speakers": 2, "dropout": 0.1,
                 "compute_dtype": "float32", "remat": False,
                 "encoder_block": "conformer", "conv_kernel": 7},
       "data": {"sample_rate": 2560, "duration": 0.5, "n_fft": 64,
                "hop_length": 32, "num_frames": 10, "frame_h": 16,
                "frame_w": 16, "speaker_freqs": [220.0, 440.0]},
       "loss": {"l1_weight": 0.5, "pit_mode": "global", "eps": 1e-8},
       "train": {"learning_rate": 3e-4, "grad_clip_norm": 1.0}}
SEED = 5
LIMITS = {"float32": 1e-4, "bfloat16": 5e-2}
BELOW = {"float32": "bfloat16", "bfloat16": "fp8"}


def config(**model) -> dict:
    return dict(CFG, model=dict(CFG["model"], **model))


def port(cfg: dict) -> AVSeparationTransformer:
    """The port's model on the reference's weights, BatchNorm at (0, 1)."""
    net = AVSeparationTransformer(tc.ModelConfig(**cfg["model"]))
    sd = dict(R.make_weights(cfg, SEED, "cpu"))
    for name, shape in R.bn_buffers(cfg).items():
        sd[name] = (torch.zeros(shape) if name.endswith("mean")
                    else torch.ones(shape))
        sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    net.load_state_dict(sd)
    return net


def batch(cfg: dict, b: int = 3) -> dict:
    return R.synthetic_batch(7, 0, cfg["data"], b, "cpu")


def gens() -> Generators:
    return Generators(torch.Generator().manual_seed(11),
                      torch.Generator().manual_seed(12))


def leaf_gap(prog: dict, ref: dict) -> float:
    scale = {k: float(v.abs().max()) for k, v in ref.items()}
    median = statistics.median(scale.values())
    return max(float((prog[k].double() - ref[k].double()).abs().max())
               / max(scale[k], median) for k in ref)


def reference_step(cfg: dict, b: dict, kind: str):
    """The reference's loss and every leaf's gradient, draws replayed."""
    params = {k: v.clone().requires_grad_(True)
              for k, v in R.make_weights(cfg, SEED, "cpu").items()}
    draws = R.Draws(torch.Generator().manual_seed(11),
                    torch.Generator().manual_seed(12))
    sep, _ = R.Model(cfg, R.Numerics(kind)).forward(
        params, b["mixed_spec"], b["lip_frames"], draws)
    loss = R.pit_loss(sep, b["clean_specs"], 0.5, 1e-8)
    loss.backward()
    return (sep.detach(), float(loss.detach()),
            {k: v.grad for k, v in params.items()})


@pytest.mark.parametrize("dtype,dropout", [("float32", 0.0),
                                           ("float32", 0.1),
                                           ("bfloat16", 0.1)])
def test_forward_loss_and_every_gradient_match(dtype, dropout):
    cfg = config(compute_dtype=dtype, dropout=dropout)
    b = batch(cfg)
    net = port(cfg).train()
    sep, _ = net(b["mixed_spec"], b["lip_frames"], gens())
    loss = separation_loss(sep, b["clean_specs"], l1_weight=0.5,
                           pit_mode="global", eps=1e-8)
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    ref_sep, ref_loss, ref_grads = reference_step(cfg, b, dtype)
    assert set(grads) == set(ref_grads)
    gap = leaf_gap(grads, ref_grads)
    sep_gap = float((sep.detach() - ref_sep).abs().max()
                    / ref_sep.abs().max())
    assert gap < LIMITS[dtype]
    assert sep_gap < LIMITS[dtype] / 10
    assert abs(float(loss) - ref_loss) < LIMITS[dtype] / 10
    # The same step below the stated precision falls outside.
    _, _, low = reference_step(cfg, b, BELOW[dtype])
    assert leaf_gap(low, ref_grads) > 2 * LIMITS[dtype]


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-6),
                                         ("bfloat16", 1e-2)])
def test_eval_forward_matches(dtype, limit):
    cfg = config(compute_dtype=dtype)
    b = batch(cfg)
    net = port(cfg).eval()
    with torch.no_grad():
        _, masks = net(b["mixed_spec"], b["lip_frames"])
    w = R.make_weights(cfg, SEED, "cpu")
    _, ref = R.eval_forward(cfg, w, b["mixed_spec"], b["lip_frames"],
                            R.Numerics(dtype))
    _, low = R.eval_forward(cfg, w, b["mixed_spec"], b["lip_frames"],
                            R.Numerics(BELOW[dtype]))
    gap = float((masks - ref).abs().max())
    assert gap < limit
    assert float((low - ref).abs().max()) > 3 * max(gap, limit / 10)


def test_training_steps_match_the_reference_interface():
    """The port's training step (three steps, Adam) against the
    reference's `train_steps`, as the benchmark's check compares them."""
    cfg = config(compute_dtype="float32")
    exp = tc.ExperimentConfig(model=tc.ModelConfig(**cfg["model"]),
                              train=tc.TrainConfig(batch_size=3))
    net = port(cfg).train()
    from av_separation_torch.train import TrainState, make_optimizer
    state = TrainState(0, net, make_optimizer(exp, net.parameters()), gens())
    step = make_train_step(exp)
    batches = [R.synthetic_batch(7, i, cfg["data"], 3, "cpu")
               for i in range(3)]
    losses = [float(step(state, bb)[1]["loss"]) for bb in batches]
    ref = R.train_steps(cfg, R.make_weights(cfg, SEED, "cpu"), batches,
                        R.Draws(torch.Generator().manual_seed(11),
                                torch.Generator().manual_seed(12)),
                        R.Numerics("float32"))
    assert max(abs(a - b) for a, b in zip(losses, ref["losses"])) < 1e-5


def test_remat_moves_each_batch_norm_once():
    cfg = config(remat=True)
    plain = port(config()).train()
    remat = port(cfg).train()
    b = batch(cfg)
    for net in (plain, remat):
        sep, _ = net(b["mixed_spec"], b["lip_frames"], gens())
        separation_loss(sep, b["clean_specs"]).backward()
    bufs = dict(remat.named_buffers())
    for name, want in plain.named_buffers():
        assert torch.equal(bufs[name], want), name
    counts = [v for k, v in bufs.items() if k.endswith("num_batches_tracked")]
    assert len(counts) == 3 + 2 * 2 and all(int(c) == 1 for c in counts)
    grads = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        assert torch.equal(grads[name].grad, p.grad), name


def test_remat_layer_without_draws_moves_batch_norm_once():
    layer = ConformerLayer(16, 2, 5, dropout=0.0).train()
    x = torch.randn(2, 9, 16, requires_grad=True)
    remat_layer(layer, None, x).sum().backward()
    bn = layer.conv.batch_norm
    assert int(bn.num_batches_tracked) == 1
    fresh = TorchBatchNorm(16).train()
    fresh.load_state_dict({k: v for k, v in
                           ConformerLayer(16, 2, 5).conv.batch_norm
                           .state_dict().items()})
    assert not torch.equal(bn.running_mean, fresh.running_mean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_glu_dwconv_cpu_route_is_glu_then_depthwise_conv(dtype):
    gen = torch.Generator().manual_seed(3)
    d, k = 24, 7
    u = torch.randn(2, 13, 2 * d, generator=gen).to(dtype).requires_grad_()
    w = (torch.randn(d, 1, k, generator=gen) / math.sqrt(k)).to(dtype) \
        .requires_grad_()
    bias = torch.randn(d, generator=gen).to(dtype).requires_grad_()
    y = glu_dwconv(u, w, bias)
    uf, wf, bf = (t.detach().double().requires_grad_() for t in (u, w, bias))
    want = F.conv1d(F.glu(uf, dim=-1).transpose(1, 2), wf, bf,
                    padding=(k - 1) // 2, groups=d).transpose(1, 2)
    g = torch.randn(y.shape, generator=gen).to(dtype)
    y.backward(g)
    want.backward(g.double())
    assert y.dtype == dtype and y.shape == (2, 13, d)
    # float32: a sum's order (1e-6); bf16: y rounded once (2^-8), the
    # gradients once each.
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for got, ref in ((y, want), (u.grad, uf.grad), (w.grad, wf.grad),
                     (bias.grad, bf.grad)):
        assert float((got.double() - ref.detach()).abs().max()) \
            < tol * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_dropout_is_the_plain_chain(dtype):
    x = (torch.randn(3, 5, 32, generator=torch.Generator().manual_seed(2))
         * 3).to(dtype).requires_grad_()
    out = silu_dropout(x, 0.1, torch.Generator().manual_seed(4))
    bits = keep_bits(x.shape, torch.Generator().manual_seed(4), "cpu")
    s = keep_scale(26, dtype)
    xf = x.detach().float().requires_grad_()
    want = torch.where(bits >= 26, F.silu(xf).to(dtype) * s, 0.0)
    assert torch.equal(out, want)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)) \
        .to(dtype)
    out.backward(g)
    sig = torch.sigmoid(xf.detach())
    dsilu = sig * (1 + xf.detach() * (1 - sig))
    chain = torch.where(bits >= 26, g.float() * dsilu * s, 0.0)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    assert float((x.grad.float() - chain).abs().max()) \
        <= tol * float(chain.abs().max())
    assert torch.equal(silu_dropout(x, 0.0, None), F.silu(xf).to(dtype))


def test_a_mesh_is_refused_naming_what_is_missing():
    model = build_model(tc.ModelConfig(**config()["model"]), device="cpu")
    with pytest.raises(NotImplementedError) as err:
        shard_model(model, object())
    msg = str(err.value)
    assert "'seq'" in msg and "halo of K - 1 = 6 frames" in msg
    assert "'model'" in msg and "column split" in msg


def test_the_named_config_and_its_checks():
    cfg = tc.get_config("conformer_l")
    m = cfg.model
    assert (m.encoder_block, m.conv_kernel, m.d_model, m.nhead,
            m.num_encoder_layers, m.num_fusion_layers, m.num_speakers,
            m.dropout) == ("conformer", 31, 512, 8, 17, 4, 2, 0.1)
    assert cfg.data == tc.get_config("scaled").data
    for name in ("demo", "scaled", "three_speaker", "lrs2", "multihost"):
        got = tc.get_config(name).model
        assert (got.encoder_block, got.conv_kernel) == ("transformer", 31)
    with pytest.raises(ValueError, match="encoder_block"):
        tc.ModelConfig(encoder_block="lstm")
    with pytest.raises(ValueError, match="odd"):
        tc.ModelConfig(conv_kernel=32)
    with pytest.raises(ValueError, match="built for"):
        tc.ModelConfig(conv_kernel=9)  # odd, but no kernel is built for it


@pytest.mark.parametrize("remat", [False, True])
def test_casting_once_a_forward_changes_no_number(remat):
    """The forward's parameters cast in one op (`cast_once`) give the
    outputs, the loss and every gradient that a cast at each use gives,
    bit for bit, with and without remat (whose recompute casts at use)."""
    cfg = config(compute_dtype="bfloat16", remat=remat)
    b = batch(cfg)
    runs = []
    for once in (True, False):
        net = port(cfg).train()
        if not once:
            net.__dict__["_casts"] = []
        sep, _ = net(b["mixed_spec"], b["lip_frames"], gens())
        loss = separation_loss(sep, b["clean_specs"])
        loss.backward()
        runs.append((sep.detach(), loss.detach(),
                     {k: p.grad for k, p in net.named_parameters()}))
    (sep1, loss1, g1), (sep2, loss2, g2) = runs
    assert torch.equal(sep1, sep2) and torch.equal(loss1, loss2)
    assert all(torch.equal(g1[k], g2[k]) for k in g2)


def test_the_cast_parameters_are_those_cast_at_use():
    net = port(config(compute_dtype="bfloat16"))
    cast = cast_parameters(net)
    assert len({id(p) for p in cast}) == len(cast)
    held = {id(p) for m in net.modules()
            if isinstance(m, (LayerNorm, TorchBatchNorm))
            for p in m.parameters()}
    assert not held & {id(p) for p in cast}
    decoder = {id(p) for p in net.decoder.parameters()}
    assert not decoder & {id(p) for p in cast}
    names = {id(p): k for k, p in net.named_parameters()}
    assert {names[id(p)] for p in cast} >= {
        "audio_encoder.transformer.layers.0.conv.depthwise.weight",
        "audio_encoder.transformer.layers.0.self_attn.in_proj_weight",
        "visual_encoder.frame_proj.weight"}
    assert cast_parameters(port(config())) == []


def test_the_transformer_configs_build_the_same_modules():
    """The default block builds the modules and names it built before."""
    net = build_model(tc.ModelConfig(num_encoder_layers=1,
                                      num_fusion_layers=1), device="cpu")
    names = [n for n, _ in net.named_parameters()]
    assert "audio_encoder.transformer.layers.0.linear1.weight" in names
    assert not any(".ffn1." in n or ".layers.0.conv." in n for n in names)
    assert not any("batch_norm" in n for n, _ in net.named_buffers())


def _tiny_named_config():
    full = tc.conformer_l_config()
    return dataclasses.replace(
        full, model=tc.ModelConfig(**config()["model"]),
        data=tc.DataConfig(sample_rate=2560, duration=0.5, n_fft=64,
                           hop_length=32, num_frames=10, frame_h=16,
                           frame_w=16))


def test_cli_train_and_the_separator_take_it(monkeypatch, capsys):
    from av_separation_torch import cli
    monkeypatch.setitem(tc.NAMED_CONFIGS, "conformer_l", _tiny_named_config)
    assert cli.main(["train", "--config", "conformer_l", "--cpu", "--steps",
                     "2", "--batch", "2", "--data", "device"]) == 0
    assert '"loss"' in capsys.readouterr().out
    cfg = _tiny_named_config()
    state = create_train_state(cfg, device="cpu")
    make_train_step(cfg)(state, batch(CFG, 2))
    sd = state.model.state_dict()
    moved = sd["audio_encoder.transformer.layers.0.conv.batch_norm."
               "running_mean"]
    assert moved.abs().max() > 0
    sep = Separator(cfg.model, sd, cfg.data, device="cpu")
    b = batch(CFG, 2)
    out, masks = sep.separate(b["mixed_spec"].numpy(),
                              b["lip_frames"].numpy())
    with torch.no_grad():
        _, want = state.model.eval()(b["mixed_spec"], b["lip_frames"])
    assert torch.allclose(torch.as_tensor(masks), want, atol=1e-6)


def test_flops_of_the_benchmark_match_the_port():
    import json
    import sys
    if str(BENCH) not in sys.path:  # the harness's own package
        sys.path.insert(0, str(BENCH))
    from avbench import conformer_work as work
    cfg = json.loads((BENCH / "configs" / "conformer_l_bf16.json")
                     .read_text())
    assert work.model_forward_flops(cfg) \
        == roofline.model_forward_flops(tc.get_config("conformer_l"))
    assert roofline.model_forward_flops(tc.get_config("conformer_l")) \
        == pytest.approx(172.1e9, rel=1e-3)
