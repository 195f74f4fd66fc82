"""The port's training path against the JAX package's, on the CPU.

The whole slice: the same weights (carried over with `from_jax_variables`),
the same batch from the same `batch_iterator`, dropout 0, through JAX
`make_train_step` (XLA lowerings; the kernel tests hold the plain versions
against the Pallas kernels) and the port's `make_train_step`.  Gradients and
parameters are compared leaf by leaf through `to_jax_variables`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from av_separation_tpu import config as jc
from av_separation_tpu.data.loader import batch_iterator as jax_batches
from av_separation_tpu.data.loader import eval_batch as jax_eval_batch
from av_separation_tpu.data.synthetic import SyntheticAVDataset as JaxDataset
from av_separation_tpu.losses import separation_loss as jax_loss
from av_separation_tpu.train import create_train_state as jax_create
from av_separation_tpu.train import make_train_step as jax_make_step
from av_separation_torch import config as tc
from av_separation_torch.data.loader import batch_iterator, eval_batch
from av_separation_torch.data.synthetic import SyntheticAVDataset
from av_separation_torch.losses import separation_loss
from av_separation_torch.models.layers import Generators
from av_separation_torch.models.model import (AVSeparationTransformer,
                                              build_model)
from av_separation_torch.train import (ClippedAdam, TrainState,
                                       create_train_state, make_eval_step,
                                       make_optimizer, make_train_step)
from av_separation_torch.utils.transplant import (from_jax_variables,
                                                  to_jax_variables)

# d_model 256 with 2 heads: dh 128, the packed attention layout.
MODEL = dict(freq_bins=65, d_model=256, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.0)
DATA = dict(num_samples=8, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)
BATCH = 4
LR = 3e-4
JAX_CFG = jc.ExperimentConfig(
    name="slice", model=jc.ModelConfig(**MODEL, attn_impl="xla",
                                       decoder_impl="xla", proj_impl="xla",
                                       stem_impl="xla"),
    data=jc.DataConfig(**DATA), train=jc.TrainConfig(batch_size=BATCH))
CFG = tc.ExperimentConfig(name="slice", model=tc.ModelConfig(**MODEL),
                          data=tc.DataConfig(**DATA),
                          train=tc.TrainConfig(batch_size=BATCH))


def get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def snapshot(tree):
    """NumPy copies: the JAX step donates its state, and np.asarray of a
    CPU array may share the donated buffer."""
    return jtu.tree_map(np.array, tree)


def port_from(variables, cfg=CFG):
    model = AVSeparationTransformer(cfg.model)
    model.load_state_dict(from_jax_variables(variables))
    return model.train()


@pytest.fixture(scope="module")
def run():
    """Gradients of one batch and 1 and 3 update steps, on both sides."""
    jmodel, jstate = jax_create(JAX_CFG)
    variables = snapshot({"params": jstate.params,
                          "batch_stats": jstate.batch_stats})
    batch = next(jax_batches(JaxDataset(JAX_CFG.data), BATCH, seed=0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        (sep, _), _ = jmodel.apply(
            {"params": params, "batch_stats": jstate.batch_stats},
            jb["mixed_spec"], jb["lip_frames"], deterministic=False,
            mutable=["batch_stats"])
        return jax_loss(sep, jb["clean_specs"])

    jax_grads = snapshot(jax.grad(loss_fn)(jstate.params))
    model = port_from(variables)
    probe = copy.deepcopy(model)
    sep, _ = probe(*(torch.from_numpy(batch[k])
                     for k in ("mixed_spec", "lip_frames")))
    separation_loss(sep, torch.from_numpy(batch["clean_specs"])).backward()
    grads = to_jax_variables({n: p.grad for n, p in
                              probe.named_parameters()})["params"]

    state = TrainState(0, model, make_optimizer(CFG, model.parameters()),
                       Generators(torch.Generator(), torch.Generator()))
    jstep, step = jax_make_step(jmodel, JAX_CFG), make_train_step(CFG)
    out = {"variables": variables, "jax_grads": jax_grads, "grads": grads,
           "steps": {}}
    for n in (1, 2, 3):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, batch)
        if n in (1, 3):
            out["steps"][n] = {
                "jax": (float(jm["loss"]), float(jm["grad_norm"]),
                        snapshot({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats})),
                "port": (float(m["loss"]), float(m["grad_norm"]),
                         to_jax_variables(model.state_dict()))}
    return out


class TestWholeSlice:
    def test_gradients_leaf_by_leaf(self, run):
        # Float32 on both sides, sums in another order: the largest
        # gradient is ~1.7, its float32 noise ~1e-5.  Leaves whose gradient
        # is 0 analytically (the K bias under softmax, the conv biases
        # before BatchNorm) hold noise of that size on both sides.
        leaves = jtu.tree_leaves_with_path(run["jax_grads"])
        assert len(leaves) == len(jtu.tree_leaves(run["grads"]))
        for path, want in leaves:
            np.testing.assert_allclose(get(run["grads"], path), want,
                                       atol=5e-5, rtol=1e-4,
                                       err_msg=jtu.keystr(path))

    @pytest.mark.parametrize("n", [1, 3])
    def test_train_steps(self, run, n):
        (jloss, jnorm, jvars), (loss, norm, pvars) = (
            run["steps"][n]["jax"], run["steps"][n]["port"])
        # The loss is SI-SNR in dB, whose float32 dot products move by
        # O(1e-4) dB with the summation order (tests/test_parity.py).
        np.testing.assert_allclose(loss, jloss, atol=1e-3)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
        p0 = run["variables"]["params"]
        gmax = max(np.abs(g).max() for g in jtu.tree_leaves(run["jax_grads"]))
        num = den = 0.0
        for path, want in jtu.tree_leaves_with_path(jvars["params"]):
            got = get(pvars["params"], path)
            err = np.abs(got - want)
            # Adam divides by |g|: where the gradient is float32 noise
            # (|g| ~ 1e-5) the two sides may step in opposite directions,
            # by at most lr each step.
            assert err.max() <= 2 * LR * n, jtu.keystr(path)
            # Where the gradient is well above the noise, the steps agree.
            big = np.abs(get(run["jax_grads"], path)) > 1e-3 * gmax
            assert err[big].max(initial=0.0) <= 1e-5, jtu.keystr(path)
            num += float(((got - want).astype(np.float64) ** 2).sum())
            den += float(((want - get(p0, path)).astype(np.float64)
                          ** 2).sum())
        # The whole update, as one vector: measured 1.1e-3 relative.
        assert np.sqrt(num / den) < 1e-2

    @pytest.mark.parametrize("n", [1, 3])
    def test_batch_stats_after_steps(self, run, n):
        jvars, pvars = (run["steps"][n]["jax"][2],
                        run["steps"][n]["port"][2])
        for path, want in jtu.tree_leaves_with_path(jvars["batch_stats"]):
            np.testing.assert_allclose(get(pvars["batch_stats"], path), want,
                                       atol=1e-4, err_msg=jtu.keystr(path))

    def test_training_forward_and_batchnorm_stats(self, run):
        """One training-mode forward at dropout 0: outputs and the updated
        BatchNorm running stats against JAX `deterministic=False`."""
        variables = run["variables"]
        jmodel = jax_create(JAX_CFG)[0]
        rng = np.random.default_rng(3)
        mixed = np.abs(rng.normal(size=(3, 65, 33))).astype(np.float32)
        frames = rng.uniform(size=(3, 10, 16, 16)).astype(np.float32)
        (sep_ref, masks_ref), upd = jmodel.apply(
            variables, jnp.asarray(mixed), jnp.asarray(frames),
            deterministic=False, mutable=["batch_stats"])
        model = port_from(variables)
        with torch.no_grad():
            sep, masks = model(torch.from_numpy(mixed),
                               torch.from_numpy(frames))
        np.testing.assert_allclose(masks.numpy(), np.asarray(masks_ref),
                                   atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(sep.numpy(), np.asarray(sep_ref),
                                   atol=1e-4, rtol=1e-4)
        stats = to_jax_variables(model.state_dict())["batch_stats"]
        for path, want in jtu.tree_leaves_with_path(
                jtu.tree_map(np.asarray, upd["batch_stats"])):
            np.testing.assert_allclose(get(stats, path), want, atol=1e-6,
                                       err_msg=jtu.keystr(path))


class TestTransplant:
    def test_jax_to_port_to_jax_is_identity(self, run):
        variables = run["variables"]
        back = to_jax_variables(from_jax_variables(variables))
        flat = jtu.tree_leaves_with_path(variables)
        assert len(flat) == len(jtu.tree_leaves(back))
        for path, leaf in flat:
            np.testing.assert_array_equal(get(back, path), leaf,
                                          err_msg=jtu.keystr(path))

    def test_gradient_names_cover_every_parameter(self):
        model = build_model(CFG.model, device="cpu")
        grads = to_jax_variables({n: torch.zeros_like(p)
                                  for n, p in model.named_parameters()})
        assert set(grads) == {"params"}
        n_port = sum(p.numel() for p in model.parameters())
        assert sum(a.size for a in jtu.tree_leaves(grads)) == n_port


class TestData:
    def test_batches_match_jax_loader(self):
        cfg = dataclasses.replace(CFG.data, num_samples=10)
        jcfg = dataclasses.replace(JAX_CFG.data, num_samples=10)
        ours = batch_iterator(SyntheticAVDataset(cfg), 4, seed=5)
        ref = jax_batches(JaxDataset(jcfg), 4, seed=5)
        for _ in range(5):  # two per epoch: crosses two reshuffles
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])

    def test_eval_batch_and_materialize(self):
        ours, ref = SyntheticAVDataset(CFG.data), JaxDataset(JAX_CFG.data)
        a, b = eval_batch(ours, 5), jax_eval_batch(ref, 5)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
        assert ours.materialize() is ours.materialize()

    @pytest.mark.parametrize("name", ["demo", "scaled", "three_speaker",
                                      "lrs2", "multihost"])
    def test_loss_and_train_configs_match_jax(self, name):
        ours, ref = tc.get_config(name), jc.get_config(name)
        for f in dataclasses.fields(tc.LossConfig):
            assert getattr(ours.loss, f.name) == getattr(ref.loss, f.name)
        for f in dataclasses.fields(tc.TrainConfig):
            assert getattr(ours.train, f.name) == getattr(ref.train, f.name)


class TestOptimizer:
    @pytest.mark.parametrize("shapes", [((5, 3), (7,)),
                                        ((4,), (2, 3, 2), (1,))])
    @pytest.mark.parametrize("scale", [0.01, 10.0])
    def test_clipped_adam_matches_optax(self, scale, shapes):
        """Two updates, with the global norm below (no clip) and above 1,
        in multi-tensor ops (fused Adam, `_foreach_norm`, `_foreach_mul_`)
        over two lists of tensors."""
        rng = np.random.default_rng(4)
        params = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[(rng.normal(size=p.shape) * scale).astype(np.float32)
                  for p in params] for _ in range(2)]
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
        jp = [jnp.asarray(p) for p in params]
        opt_state = tx.init(jp)
        ts = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
        opt = ClippedAdam(ts, 1.0, LR)
        for g in grads:
            updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                           opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            for t, x in zip(ts, g):
                t.grad = torch.from_numpy(x.copy())
            norm = opt.step()
            np.testing.assert_allclose(
                float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for t, want in zip(ts, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                       atol=1e-7, rtol=1e-6)


class TestTrainingMode:
    CFG = dataclasses.replace(
        CFG, model=dataclasses.replace(CFG.model, d_model=64, dropout=0.1))

    def batch(self):
        return next(batch_iterator(SyntheticAVDataset(self.CFG.data), BATCH))

    def test_dropout_step_is_seeded_and_finite(self):
        runs = []
        for _ in range(2):
            state = create_train_state(self.CFG, device="cpu")
            step = make_train_step(self.CFG)
            losses = [float(step(state, self.batch())[1]["loss"])
                      for _ in range(3)]
            assert state.step == 3 and np.isfinite(losses).all()
            runs.append((losses, state.model.state_dict()))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(v, runs[1][1][k])
                   for k, v in runs[0][1].items())

    def test_dropout_changes_the_training_forward(self):
        state = create_train_state(self.CFG, device="cpu")
        mixed, frames = (torch.from_numpy(self.batch()[k])
                         for k in ("mixed_spec", "lip_frames"))
        with torch.no_grad():
            train_out, _ = state.model(mixed, frames, state.generators)
            eval_out, masks = state.model.eval()(mixed, frames)
        assert not torch.allclose(train_out, eval_out)
        assert 0.0 <= float(masks.min()) <= float(masks.max()) <= 1.0
        with pytest.raises(ValueError, match="(?i)generator"):
            state.model.train()(mixed, frames)

    def test_eval_step_restores_mode(self):
        state = create_train_state(self.CFG, device="cpu")
        metrics = make_eval_step()(state.model, self.batch())
        assert state.model.training
        assert set(metrics) == {"input_snr", "output_snr", "mask_min",
                                "mask_max"}

    def test_needs_a_card_unless_asked_for_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device works")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_train_state(self.CFG)


@pytest.mark.slow
def test_demo_reaches_35db_on_the_cpu():
    from av_separation_torch.demo import run as demo_run
    out = demo_run(device="cpu", log=lambda *_: None)
    assert out["passed"], out
