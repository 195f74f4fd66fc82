"""Head dims above 128: the flash wrappers' padded route (dh padded to 256,
run on the card in float32 by 8-warp blocks whose warp pairs each own the
two 128-column halves of 16 rows) against the JAX `flash_attention`,
which runs any dh as a native narrow block, with the Pallas kernels in
interpret mode.  Float32 on both sides; the same dropout bits.  The
kernels' schedule and order of sums are emulated in numpy in
tests/test_torch_pair_design.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.config import ModelConfig
from av_separation_torch.models.model import build_model
from av_separation_torch.ops.kernels.attention import (flash_attn_bwd_torch,
                                                       flash_attn_fwd_torch,
                                                       padded_bwd, padded_fwd,
                                                       padded_head_dim)

SEED = -1234567


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (q shape, k/v shape): one block of keys (the Pallas packed kernel) and
# T above 512 (its multi-block grid).
SHAPES = {"packed": ((1, 2, 37, None), (1, 2, 45, None)),
          "tiled": ((1, 1, 520, None), (1, 1, 515, None))}


class TestWideHeadDims:
    # Float32 sums of up to 256 products (s) and 520 products (o, dq, dk,
    # dv) in another order than the Pallas kernels': 2e-5 on o, 5e-5 on
    # the gradients (tests/test_torch_kernels.py's tolerances), 1e-4 on
    # lse.  The padded columns are zero, so the padded route equals the
    # unpadded plain version to float32 noise (2e-5).
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("layout", list(SHAPES))
    @pytest.mark.parametrize("dh", [129, 200, 256])
    def test_padded_route_matches_pallas(self, dh, layout, rate):
        from av_separation_tpu.ops.pallas.attention import flash_attention
        qs, ks = (s[:3] + (dh,) for s in SHAPES[layout])
        q, k, v, do = rand(qs, 1), rand(ks, 2), rand(ks, 3), rand(qs, 4)
        assert padded_head_dim(dh) == 256
        tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
        seen = []

        def fwd(*a, scale=None):
            seen.append((a[0].shape[-1], scale))
            return flash_attn_fwd_torch(*a, scale=scale)

        o, lse = padded_fwd(fwd, tq_, tk_, tv_, rate, SEED)
        want_scale = None if dh == 256 else 1.0 / np.sqrt(dh)
        assert seen == [(256, want_scale)] and o.shape == qs
        grads = padded_bwd(flash_attn_bwd_torch, tq_, tk_, tv_, o, tdo, lse,
                           rate, SEED)
        o_u, lse_u = flash_attn_fwd_torch(tq_, tk_, tv_, rate, SEED)
        np.testing.assert_allclose(o.numpy(), o_u.numpy(), atol=2e-5)

        seed = jnp.asarray([SEED], jnp.int32)
        with pltpu.force_tpu_interpret_mode():
            o_j, vjp = jax.vjp(lambda *a: flash_attention(
                *a, dropout_rate=rate, dropout_seed=seed),
                *(jnp.asarray(x) for x in (q, k, v)))
            want = vjp(jnp.asarray(do))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5,
                                   rtol=1e-4)
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) \
            / np.sqrt(dh)
        m = s.max(-1)
        lse_f64 = m + np.log(np.exp(s - m[..., None]).sum(-1))
        np.testing.assert_allclose(lse.numpy(), lse_f64, atol=1e-4)
        for name, g, w in zip("qkv", grads, want):
            assert g.shape == (qs if name == "q" else ks)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                       rtol=1e-4, err_msg=name)

    def test_wide_head_model_runs_on_the_cpu(self):
        """ModelConfig(d_model=512, nhead=2) (dh 256), the config that
        raised on the card before: a forward and a backward at small
        depth, finite, with every attention at dh 256."""
        cfg = dataclasses.replace(ModelConfig(d_model=512, nhead=2),
                                  freq_bins=33, num_encoder_layers=1,
                                  num_fusion_layers=1, dropout=0.0)
        model = build_model(cfg, device="cpu").train()
        rng = np.random.default_rng(5)
        mixed = torch.from_numpy(np.abs(rng.normal(size=(1, 33, 12)))
                                 .astype(np.float32))
        frames = torch.from_numpy(rng.uniform(size=(1, 6, 16, 16))
                                  .astype(np.float32))
        sep, masks = model(mixed, frames)
        sep.square().mean().backward()
        assert sep.shape == (1, 2, 33, 12) and bool(torch.isfinite(sep).all())
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters() if p.grad is not None)


# Head dims above 256: padded to the next multiple of 128 and run on the
# card by a cluster of dh / 128 blocks (csrc/flash_attn_fwd.cu,
# csrc/flash_fwd_wgmma.cu, csrc/flash_attn_bwd.cu `*_cluster`); their
# schedule is emulated in tests/test_torch_wide_cluster_design.py.
WIDE = {320: 384, 512: 512, 1024: 1024}


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


class TestHeadDimsAbove256:
    @pytest.mark.parametrize("dh,width", sorted(WIDE.items()))
    def test_pad_to_a_multiple_of_128(self, dh, width):
        assert padded_head_dim(dh) == width

    # Against the Pallas `flash_attention` in interpret mode.  Float32:
    # sums of up to 1024 products (s) in another order: 5e-5 on o and the
    # gradients (atol) with 1e-4 relative.  bf16 (operands rounded the same
    # way on both sides; p, pd, ds rounded at the same points): 2 bf16
    # ulps of the O(1) outputs, relative and absolute, as
    # tests/test_torch_bf16.py.
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("layout", list(SHAPES))
    @pytest.mark.parametrize("dh", sorted(WIDE))
    def test_padded_route_matches_pallas(self, dh, layout, rate, dtype):
        from av_separation_tpu.ops.pallas.attention import flash_attention
        qs, ks = (s[:3] + (dh,) for s in SHAPES[layout])
        if layout == "tiled":  # T above 512 at one head, fewer rows
            qs, ks = (1, 1, 520, dh), (1, 1, 514, dh)
        arrays = [rand(qs, 1), rand(ks, 2), rand(ks, 3), rand(qs, 4)]
        bf16 = dtype == "bfloat16"
        if bf16:
            arrays = [_bf16(a) for a in arrays]
        tdt = torch.bfloat16 if bf16 else torch.float32
        jdt = jnp.bfloat16 if bf16 else jnp.float32
        tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(tdt) for x in arrays)
        seen = []

        def fwd(*a, scale=None):
            seen.append(a[0].shape[-1])
            return flash_attn_fwd_torch(*a, scale=scale)

        o, lse = padded_fwd(fwd, tq_, tk_, tv_, rate, SEED)
        assert seen == [WIDE[dh]] and o.shape == qs and o.dtype == tdt
        grads = padded_bwd(flash_attn_bwd_torch, tq_, tk_, tv_, o, tdo, lse,
                           rate, SEED)
        seed = jnp.asarray([SEED], jnp.int32)
        with pltpu.force_tpu_interpret_mode():
            o_j, vjp = jax.vjp(lambda *a: flash_attention(
                *a, dropout_rate=rate, dropout_seed=seed),
                *(jnp.asarray(x).astype(jdt) for x in arrays[:3]))
            want = vjp(jnp.asarray(arrays[3]).astype(jdt))
        tol = dict(atol=2 * 2.0 ** -7, rtol=2 * 2.0 ** -7) if bf16 \
            else dict(atol=5e-5, rtol=1e-4)
        f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), f(o_j), **tol)
        for name, g, w in zip("qkv", grads, want):
            assert g.shape == (qs if name == "q" else ks) and g.dtype == tdt
            np.testing.assert_allclose(g.float().numpy(), f(w), **tol,
                                       err_msg=name)


def test_d1024_two_heads_matches_jax_model():
    """ModelConfig(d_model=1024, nhead=2) (dh 512, which raised on the card
    before) at one encoder and one fusion layer: the port's eval forward
    against the JAX model with the Pallas attention in interpret mode, on
    the same weights.  float32 sums over 1024-wide rows in another order:
    masks (sigmoid outputs) 1e-4, separated spectra 1e-4 of their peak."""
    import jax.tree_util as jtu

    from av_separation_tpu.config import ModelConfig as JaxModelConfig
    from av_separation_tpu.models.model import (
        AVSeparationTransformer as JaxModel)
    from av_separation_torch.models.model import AVSeparationTransformer
    from av_separation_torch.utils.transplant import from_jax_variables

    small = dict(freq_bins=33, d_model=1024, nhead=2, num_encoder_layers=1,
                 num_fusion_layers=1, num_speakers=2, dropout=0.1)
    jmodel = JaxModel(JaxModelConfig(**small, attn_impl="pallas",
                                     decoder_impl="xla", proj_impl="xla",
                                     stem_impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        variables = jtu.tree_map(np.asarray, jmodel.init(
            jax.random.PRNGKey(3), jnp.zeros((1, 33, 12)),
            jnp.zeros((1, 6, 16, 16))))
    model = AVSeparationTransformer(ModelConfig(**small))
    model.load_state_dict(from_jax_variables(variables))
    model.eval()
    rng = np.random.default_rng(9)
    mixed = np.abs(rng.normal(size=(2, 33, 12))).astype(np.float32)
    frames = rng.uniform(size=(2, 6, 16, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        sep_j, masks_j = jmodel.apply(variables, jnp.asarray(mixed),
                                      jnp.asarray(frames),
                                      deterministic=True)
    with torch.inference_mode():
        sep, masks = model(torch.from_numpy(mixed), torch.from_numpy(frames))
    np.testing.assert_allclose(masks.numpy(), np.asarray(masks_j), atol=1e-4)
    peak = float(np.abs(np.asarray(sep_j)).max())
    np.testing.assert_allclose(sep.numpy(), np.asarray(sep_j),
                               atol=1e-4 * peak)
