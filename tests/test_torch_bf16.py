"""The port's bfloat16 compute against the JAX package's, on the CPU.

The flash and projection kernels' plain versions at bf16 against the Pallas
kernels in interpret mode (as tests/test_kernels.py runs them), then the
whole model at bf16 (eval forward and train steps) against the JAX model
with every kernel selector at "pallas", on weights carried over with
`from_jax_variables`.  Inputs are made with numpy from a seed, rounded to
bf16 the same way on both sides (nearest even).

Tolerances, stated per test: a bf16 value keeps 8 significant bits, so one
ulp of an O(1) output is 2^-7 = 7.8e-3.  The two sides round at the same
points but sum in another order in float32, so a value that lands next to
a rounding boundary may round the other way: one ulp.  Through a model,
such flips compound over layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_tpu import config as jc
from av_separation_tpu.data.loader import batch_iterator as jax_batches
from av_separation_tpu.data.synthetic import SyntheticAVDataset as JaxDataset
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_tpu.train import create_train_state as jax_create
from av_separation_tpu.train import make_train_step as jax_make_step
from av_separation_torch import config as tc
from av_separation_torch.models.layers import Generators
from av_separation_torch.models.model import AVSeparationTransformer
from av_separation_torch.ops.attention import merge_heads, split_heads
from av_separation_torch.ops.kernels.attention import (flash_attention,
                                                       flash_attn_bwd_torch,
                                                       flash_attn_fwd_torch)
from av_separation_torch.ops.kernels.audio_proj import (audio_proj_fwd,
                                                        audio_projection)
from av_separation_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from av_separation_torch.utils.transplant import from_jax_variables

SEED = -1234567
BF16_ULP = 2.0 ** -7  # one ulp of a bf16 value in [1, 2)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def to_bf16(*arrays):
    """The same bf16 values on both sides: (torch tensors, jax arrays)."""
    ts = [torch.from_numpy(a).bfloat16() for a in arrays]
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    return ts, js


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# (layout, q shape, k/v shape, heads): the packed (B, T, H*dh) kernel at dh
# 128, the split (B, H, T, dh) kernel at dh 32 and 64, and the multi-block
# grid (T > 512) at dh 32.
LAYOUTS = {
    "packed dh128": ((2, 37, 256), (2, 45, 256), 2),
    "split dh32": ((2, 2, 37, 32), (2, 2, 50, 32), 2),
    "split dh64": ((1, 2, 37, 64), (1, 2, 50, 64), 2),
    "multiblock dh32": ((1, 1, 530, 32), (1, 1, 520, 32), 1),
}


def _jax_attention(layout, nh, rate):
    from av_separation_tpu.ops.pallas.attention import (
        flash_attention as jax_flash, flash_attention_packed_qkv)
    seed = jnp.asarray([SEED], jnp.int32) if rate > 0 else None
    if layout.startswith("packed"):
        return lambda q, k, v: flash_attention_packed_qkv(
            q, k, v, nh, dropout_rate=rate, dropout_seed=seed)
    return lambda q, k, v: jax_flash(q, k, v, dropout_rate=rate,
                                     dropout_seed=seed)


def _port_attention(layout, nh, rate):
    if layout.startswith("packed"):
        return lambda q, k, v: merge_heads(flash_attention(
            *(split_heads(x, nh) for x in (q, k, v)), rate, SEED))
    return lambda q, k, v: flash_attention(q, k, v, rate, SEED)


class TestFlashBf16:
    # Forward: o in bf16 on both sides, one ulp of the O(1) outputs (plus
    # a rounding flip of p, 2^-8 relative, inside the sum).  The
    # multi-block Pallas kernel rounds p against the running max of its
    # 512-key block, the plain version against the row's max: the same
    # bound.  Backward: dq, dk, dv in bf16, each a sum over up to 530
    # products of operands rounded to bf16 (pd, ds) whose roundings may
    # flip: 2 ulps at the gradients' O(1)-O(10) scale (rtol 2^-6).
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_forward_and_backward_match_pallas(self, interpret, layout,
                                               rate):
        qs, ks, nh = LAYOUTS[layout]
        (q, k, v, g), (jq, jk, jv, jg) = to_bf16(
            rand(qs, 1), rand(ks, 2), rand(ks, 3), rand(qs, 4))
        o_ref, vjp = jax.vjp(_jax_attention(layout, nh, rate), jq, jk, jv)
        want = vjp(jg)
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        o = _port_attention(layout, nh, rate)(*ts)
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(f32(o), f32(o_ref), atol=BF16_ULP,
                                   rtol=BF16_ULP)
        o.backward(g)
        for name, t, w in zip("qkv", ts, want):
            assert t.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(f32(t.grad), f32(w), atol=2 * BF16_ULP,
                                       rtol=2 * BF16_ULP, err_msg=name)

    def test_plain_rounds_where_the_kernels_do(self):
        """At bf16 the plain versions equal their float32 arithmetic with
        bf16 operands and the p, pd and ds roundings: o and the gradients
        differ from the unrounded float32 result by bf16 noise, not by
        more, and the float32 result itself is unchanged."""
        b, h, t, dh = 1, 2, 40, 64
        q, k, v, do = (torch.from_numpy(rand((b, h, t, dh), s))
                       for s in (5, 6, 7, 8))
        qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
        o32, lse32 = flash_attn_fwd_torch(qb.float(), kb.float(), vb.float(),
                                          0.1, SEED)
        o16, lse16 = flash_attn_fwd_torch(qb, kb, vb, 0.1, SEED)
        assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
        # lse reads only s: the same float32 numbers.
        assert torch.equal(lse16, lse32)
        assert 0 < float((o16.float() - o32).abs().max()) < 2 * BF16_ULP
        g16 = flash_attn_bwd_torch(qb, kb, vb, o16, dob, lse16, 0.1, SEED)
        g32 = flash_attn_bwd_torch(qb.float(), kb.float(), vb.float(),
                                   o16.float(), dob.float(), lse16, 0.1, SEED)
        for a, c in zip(g16, g32):
            assert a.dtype == torch.bfloat16
            scale = float(c.abs().max())
            assert float((a.float() - c).abs().max()) < 4 * BF16_ULP * scale


class TestAudioProjectionBf16:
    # y and h in bf16 on both sides from the same float32 math (sums of
    # 3 * (65 or 64) products in another order): one ulp, rtol 2^-7.  The
    # VJP's cotangents come back in the inputs' dtypes; dx is bf16 (one
    # ulp at its scale), the weight gradients float32 sums over B*T of
    # products of the same bf16-rounded operands (float32 tolerances
    # widened by the rare flip of a rounded cotangent: rtol 1e-2).
    def test_forward_and_vjp_match_pallas(self, interpret):
        from av_separation_tpu.ops.pallas.audio_proj import (
            _fwd_impl, fused_audio_projection)
        b, t, f, d = 2, 37, 65, 64
        x = np.abs(rand((b, t, f), 9))
        ws = [rand((3, f, d), 10, 0.1), rand((d,), 11, 0.1),
              rand((3, d, d), 12, 0.1), rand((d,), 13, 0.1)]
        (xt,), (xj,) = to_bf16(x)
        wj = [jnp.asarray(w) for w in ws]
        y_ref, h_ref = _fwd_impl(xj, *wj)
        y, h = audio_proj_fwd(xt, *(torch.from_numpy(w) for w in ws))
        assert y.dtype == h.dtype == torch.bfloat16
        for got, want in ((y, y_ref), (h, h_ref)):
            np.testing.assert_allclose(f32(got), f32(want), atol=1e-6,
                                       rtol=BF16_ULP)

        g = rand((b, t, d), 14)
        (gt,), (gj,) = to_bf16(g)
        _, vjp = jax.vjp(fused_audio_projection, xj, *wj)
        want = vjp(gj)
        ts = [xt.clone().requires_grad_()] + [
            torch.from_numpy(w).requires_grad_() for w in ws]
        audio_projection(*ts).backward(gt)
        assert ts[0].grad.dtype == torch.bfloat16
        assert all(t_.grad.dtype == torch.float32 for t_ in ts[1:])
        for name, t_, w in zip(("x", "w1", "b1", "w2", "b2"), ts, want):
            assert str(w.dtype) == str(t_.grad.dtype).split(".")[-1], name
            scale = float(np.abs(f32(w)).max())
            np.testing.assert_allclose(f32(t_.grad), f32(w),
                                       atol=1e-2 * scale, rtol=1e-2,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# The whole model at bf16: the tiny config of tests/test_kernels.py's bf16
# Pallas training step (d 32, 2 heads: dh 16).
# ---------------------------------------------------------------------------

MODEL = dict(freq_bins=65, d_model=32, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2)
DATA = dict(num_samples=8, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)
BATCH = 4
PALLAS = dict(attn_impl="pallas", decoder_impl="pallas", proj_impl="pallas",
              stem_impl="xla")


def configs(dropout=0.0, dtype="bfloat16"):
    jcfg = jc.ExperimentConfig(
        name="tiny", model=jc.ModelConfig(**MODEL, dropout=dropout,
                                          compute_dtype=dtype, **PALLAS),
        data=jc.DataConfig(**DATA), train=jc.TrainConfig(batch_size=BATCH))
    tcfg = tc.ExperimentConfig(
        name="tiny", model=tc.ModelConfig(**MODEL, dropout=dropout,
                                          compute_dtype=dtype),
        data=tc.DataConfig(**DATA), train=tc.TrainConfig(batch_size=BATCH))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    """JAX state, its variables as numpy, and one batch."""
    jcfg, _ = configs()
    with pltpu.force_tpu_interpret_mode():
        jmodel, jstate = jax_create(jcfg)
    variables = jtu.tree_map(np.array, {"params": jstate.params,
                                        "batch_stats": jstate.batch_stats})
    batch = next(jax_batches(JaxDataset(jcfg.data), BATCH, seed=0))
    return jmodel, jstate, variables, batch


def port_model(variables, tcfg):
    model = AVSeparationTransformer(tcfg.model)
    model.load_state_dict(from_jax_variables(variables))
    return model


class TestModelBf16:
    # Eval forward at bf16 against the JAX model with the Pallas kernels.
    # Masks are sigmoid outputs of the float32 decoder on a fused stream
    # that went through 3 bf16 encoder/fusion layers on each side: bf16
    # rounding flips compound to ~1e-2 on masks in (0, 1); the separated
    # spectra are masks times |mixed| <= ~10: 1e-2 relative to its peak.
    def test_eval_forward_matches_jax(self, setup):
        jmodel, _, variables, batch = setup
        mixed, frames = batch["mixed_spec"], batch["lip_frames"]
        with pltpu.force_tpu_interpret_mode():
            sep_j, masks_j = JaxModel(configs()[0].model).apply(
                variables, jnp.asarray(mixed), jnp.asarray(frames),
                deterministic=True)
        model = port_model(variables, configs()[1]).eval()
        with torch.inference_mode():
            sep, masks = model(torch.from_numpy(mixed),
                               torch.from_numpy(frames))
        assert sep.dtype == masks.dtype == torch.float32
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_j),
                                   atol=1e-2)
        peak = float(np.abs(np.asarray(sep_j)).max())
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_j),
                                   atol=1e-2 * peak)

    def test_bf16_within_the_jax_rule_of_float32(self, setup):
        """The JAX package's own check of bf16 against float32 on the same
        weights (tests/test_train.py:87-102): separated within 0.5."""
        _, _, variables, batch = setup
        mixed, frames = (torch.from_numpy(batch[k])
                         for k in ("mixed_spec", "lip_frames"))
        outs = {}
        for dtype in ("bfloat16", "float32"):
            model = port_model(variables, configs(dtype=dtype)[1]).eval()
            with torch.inference_mode():
                outs[dtype] = model(mixed, frames)
        assert outs["bfloat16"][0].dtype == torch.float32
        assert float((outs["bfloat16"][0] - outs["float32"][0])
                     .abs().max()) < 0.5

    # One bf16 train step (dropout 0: the two frameworks draw other
    # dropout bits) against JAX make_train_step with the Pallas kernels:
    # the loss (SI-SNR in dB plus L1, from float32 outputs of bf16
    # layers) within 2e-2 and the global gradient norm within 2e-2
    # relative; the Adam update moves every parameter by ~lr either way.
    def test_train_step_matches_jax(self, setup):
        jmodel, jstate, variables, batch = setup
        jcfg, tcfg = configs()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with pltpu.force_tpu_interpret_mode():
            _, jm = jax_make_step(jmodel, jcfg)(jstate, jb)
        model = port_model(variables, tcfg).train()
        state = TrainState(0, model, make_optimizer(tcfg, model.parameters()),
                           Generators(torch.Generator(), torch.Generator()))
        _, m = make_train_step(tcfg)(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-2)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad.dtype == torch.float32 for p in model.parameters()
                   if p.grad is not None)

    def test_loss_falls_at_bf16_with_dropout(self, setup):
        """A few bf16 steps at dropout 0.1 on one batch: the loss falls,
        as tests/test_train.py checks the JAX bf16 step."""
        _, _, variables, batch = setup
        _, tcfg = configs(dropout=0.1)
        model = port_model(variables, tcfg).train()
        state = TrainState(0, model, make_optimizer(tcfg, model.parameters()),
                           Generators(torch.Generator().manual_seed(1),
                                      torch.Generator().manual_seed(2)))
        step = make_train_step(tcfg)
        losses = []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0] - 0.5, losses


def test_config_dtype_is_checked():
    cfg = dataclasses.replace(configs()[1].model, compute_dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        AVSeparationTransformer(cfg)
