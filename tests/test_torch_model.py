"""The port's model against the JAX model and the reference goldens.

The JAX model runs its plain XLA paths (every `*_impl='xla'`); its weights
move into the port through `utils.transplant.from_jax_variables`.  Inputs
are made with numpy from a seed.  Tolerances: float32 on both sides, with
sums taken in another order; the golden gates use tests/test_parity.py's.
"""

import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from av_separation_tpu.config import ModelConfig as JaxModelConfig
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_tpu.utils.transplant import from_reference_state_dict
from av_separation_torch.config import ModelConfig, get_config
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              build_model)
from av_separation_torch.utils.transplant import (from_jax_variables,
                                                  load_reference_state_dict)

SMALL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=2,
             num_fusion_layers=2, num_speakers=2, dropout=0.1)
B, T, N, HW = 2, 24, 10, 16
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_model.npz")


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) on the same weights."""
    jcfg = JaxModelConfig(**SMALL, attn_impl="xla", decoder_impl="xla",
                          proj_impl="xla", stem_impl="xla")
    jmodel = JaxModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, T)),
                            jnp.zeros((1, N, HW, HW)))
    # Non-trivial BatchNorm running stats, so the transplant is exercised.
    rng = np.random.default_rng(0)
    variables = jtu.tree_map(np.asarray, variables)
    for bn in variables["batch_stats"]["visual_encoder"].values():
        bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    model = AVSeparationTransformer(ModelConfig(**SMALL))
    model.load_state_dict(from_jax_variables(variables))
    return jmodel, variables, model.eval()


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    mixed = np.abs(rng.normal(size=(B, 65, T))).astype(np.float32)
    frames = rng.uniform(size=(B, N, HW, HW)).astype(np.float32)
    return mixed, frames


def jax_method(jmodel, variables, fn, *args):
    return np.asarray(jmodel.apply(variables, *args, method=fn))


class TestAgainstJaxModel:
    def test_audio_encoder(self, pair):
        jmodel, variables, model = pair
        mixed, _ = inputs()
        ref = jax_method(jmodel, variables,
                         lambda m, x: m.audio_encoder(x, deterministic=True),
                         jnp.asarray(mixed))
        with torch.inference_mode():
            ours = model.audio_encoder(torch.from_numpy(mixed))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_visual_encoder(self, pair):
        jmodel, variables, model = pair
        _, frames = inputs()
        ref = jax_method(
            jmodel, variables,
            lambda m, x: m.visual_encoder(x, T, deterministic=True),
            jnp.asarray(frames))
        with torch.inference_mode():
            ours = model.visual_encoder(torch.from_numpy(frames), T)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_fusion(self, pair):
        jmodel, variables, model = pair
        audio = np.random.default_rng(1).normal(size=(B, T, 64)) \
            .astype(np.float32)
        visual = np.random.default_rng(2).normal(size=(B, T, 64)) \
            .astype(np.float32)
        ref = jax_method(
            jmodel, variables,
            lambda m, a, v: m.fusion(a, v, deterministic=True),
            jnp.asarray(audio), jnp.asarray(visual))
        with torch.inference_mode():
            ours = model.fusion(torch.from_numpy(audio),
                                torch.from_numpy(visual))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)

    def test_decoder(self, pair):
        jmodel, variables, model = pair
        fused = np.random.default_rng(3).normal(size=(B, T, 64)) \
            .astype(np.float32)
        mixed, _ = inputs()
        sep_ref, masks_ref = jmodel.apply(
            variables, jnp.asarray(fused), jnp.asarray(mixed),
            method=lambda m, f, x: m.decoder(f, deterministic=True,
                                             mixed_spec=x))
        with torch.inference_mode():
            sep, masks = model.decoder(torch.from_numpy(fused),
                                       torch.from_numpy(mixed))
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_ref),
                                   atol=2e-6, rtol=1e-5)
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_ref),
                                   atol=2e-5, rtol=1e-5)

    def test_whole_model(self, pair):
        jmodel, variables, model = pair
        mixed, frames = inputs(4)
        sep_ref, masks_ref = jmodel.apply(variables, jnp.asarray(mixed),
                                          jnp.asarray(frames),
                                          deterministic=True)
        with torch.inference_mode():
            sep, masks = model(torch.from_numpy(mixed),
                               torch.from_numpy(frames))
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_ref),
                                   atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_ref),
                                   atol=1e-4, rtol=1e-4)


class TestTransplant:
    def test_round_trip_every_parameter(self, pair):
        """JAX variables -> port state dict -> back through the JAX
        package's own reference-state-dict transplant: every array equal."""
        _, variables, model = pair
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, stats = from_reference_state_dict(sd)
        for tree, back in ((variables["params"], params),
                           (variables["batch_stats"], stats)):
            flat = jtu.tree_leaves_with_path(tree)
            back_flat = dict(jtu.tree_leaves_with_path(back))
            assert len(flat) == len(back_flat)
            for path, leaf in flat:
                np.testing.assert_array_equal(back_flat[path], leaf,
                                              err_msg=jtu.keystr(path))

    def test_state_dict_keys_match_reference(self):
        sd = load_reference_state_dict(GOLDEN)
        model = AVSeparationTransformer(get_config("demo").model)
        assert set(sd) == set(model.state_dict())
        assert sum(p.numel() for p in model.parameters()) == 1_612_738


class TestGoldenParity:
    """Reference weights through load_state_dict reproduce the reference
    outputs at the tolerances of tests/test_parity.py."""

    @pytest.fixture(scope="class")
    def outputs(self, golden_model):
        model = AVSeparationTransformer(get_config("demo").model)
        model.load_state_dict(load_reference_state_dict(GOLDEN))
        model.eval()
        g = golden_model
        mixed = torch.from_numpy(g["mixed"])
        frames = torch.from_numpy(g["frames"])
        with torch.inference_mode():
            separated, masks = model(mixed, frames)
            return {
                "masks": masks, "separated": separated,
                "audio_emb": model.audio_encoder(mixed),
                "visual_emb": model.visual_encoder(frames,
                                                   mixed.shape[-1]),
                "fused": model.fusion(torch.from_numpy(g["audio_emb"]),
                                      torch.from_numpy(g["visual_emb"])),
            }

    @pytest.mark.parametrize("name,atol", [
        ("masks", 2e-5), ("separated", 2e-3), ("audio_emb", 2e-4),
        ("visual_emb", 2e-4), ("fused", 2e-4)])
    def test_matches_golden(self, outputs, golden_model, name, atol):
        np.testing.assert_allclose(outputs[name].numpy(), golden_model[name],
                                   atol=atol, rtol=1e-4)


class TestModelContract:
    def test_build_model_seeded(self):
        cfg = ModelConfig(**SMALL)
        a = build_model(cfg, device="cpu", seed=3).state_dict()
        b = build_model(cfg, device="cpu", seed=3).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        c = build_model(cfg, device="cpu", seed=4).state_dict()
        assert not torch.equal(a["decoder.decoder.3.weight"],
                               c["decoder.decoder.3.weight"])

    def test_training_mode_raises(self):
        """Training with dropout draws from explicit generators: a
        training-mode forward without them raises."""
        model = build_model(ModelConfig(**SMALL), device="cpu").train()
        mixed, frames = inputs()
        with pytest.raises(ValueError, match="(?i)generator"):
            model(torch.from_numpy(mixed), torch.from_numpy(frames))
