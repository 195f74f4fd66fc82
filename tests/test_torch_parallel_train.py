"""Train steps of the port over a mesh (`train.make_train_step(cfg, mesh)`)
on 2 and 4 gloo ranks on the CPU (tests/torch_parallel_worker.py), against
the one-process port step and the JAX single-device step.

One small model (d 32, 2 heads, 1 + 1 layers), dropout 0, batch 4 at T 16
(so 'seq' 2 divides the audio frames and the 10 lip frames), the same
seeded weights on every side.  Per mesh: the loss within atol 1e-4 +
rtol 1e-5 of the one-process port's and of JAX `make_train_step`'s on the
transplanted weights, the same on every rank; the parameters after the
step within 1e-5 of the one-process step's where the gradient stands
above float32 noise (|g| > 1e-3 max |g|), and elsewhere within 2 lr (Adam
divides by |g|: a noise-level gradient may step either way; the rule of
tests/test_torch_train.py); the BatchNorm running stats those of the
one-process step (1e-6).  Also: 'fsdp' holds 1/F of each parameter it
splits and of both Adam moments per rank; a mesh of one rank at dropout
0.1 with remat is the one-process step bit for bit; a full checkpoint
written under a mesh restores into a one-device Separator whose outputs
are the mesh Separator's.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from av_separation_tpu import config as jc
from av_separation_tpu.train import create_train_state as jax_create
from av_separation_tpu.train import make_optimizer as jax_optimizer
from av_separation_tpu.train import make_train_step as jax_make_step
from av_separation_torch import config as tc
from av_separation_torch.inference import Separator
from av_separation_torch.train import create_train_state, make_train_step
from av_separation_torch.utils.transplant import to_jax_variables

MODEL = dict(freq_bins=65, d_model=32, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.0)
DATA = dict(num_samples=8, sample_rate=1920, duration=1.0, n_fft=128,
            hop_length=128, num_frames=5, frame_h=16, frame_w=16)
BATCH, LR = 4, 3e-4
CFG = tc.ExperimentConfig(name="mp", model=tc.ModelConfig(**MODEL),
                          data=tc.DataConfig(**DATA),
                          train=tc.TrainConfig(batch_size=BATCH))
MESHES = {"data2": dict(data=2), "fsdp2": dict(fsdp=2),
          "model2": dict(model=2), "data2xmodel2": dict(data=2, model=2),
          "seq2": dict(seq=2), "data2xseq2": dict(data=2, seq=2)}


def _batch():
    rng = np.random.default_rng(1234)
    d = CFG.data
    return {"mixed_spec": np.abs(rng.normal(
        size=(BATCH, d.freq_bins, d.num_stft_frames))).astype(np.float32),
        "lip_frames": rng.uniform(
            size=(BATCH, d.total_lip_frames, d.frame_h, d.frame_w))
        .astype(np.float32),
        "clean_specs": np.abs(rng.normal(
            size=(BATCH, 2, d.freq_bins, d.num_stft_frames)))
        .astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (3 jobs at a time), the one-process port step
    and the JAX step."""
    batch = _batch()
    # The directories first: mktemp is not safe from several threads.
    dirs = {name: tmp_path_factory.mktemp(name) for name in MESHES}

    def launch(name):
        d = dirs[name]
        np.savez(os.path.join(d, "batch.npz"), **batch)
        args = dict(model=MODEL, data=DATA, mesh=MESHES[name],
                    train=dict(batch_size=BATCH))
        if name == "data2xmodel2":
            args.update(checkpoint=str(d / "ckpt"), separate=2)
        n = int(np.prod(list(MESHES[name].values())))
        return name, (worker.run("train", n, args, str(d)), d)

    with ThreadPoolExecutor(3) as pool:
        meshes = dict(pool.map(launch, MESHES))

    state = create_train_state(CFG, device="cpu")
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, m = make_train_step(CFG)(state, batch)
    port = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state": state.model.state_dict(),
            "grads": {n: p.grad.clone()
                      for n, p in state.model.named_parameters()}}

    jcfg = jc.ExperimentConfig(
        name="mp", model=jc.ModelConfig(**MODEL, attn_impl="xla",
                                        decoder_impl="xla", proj_impl="xla",
                                        stem_impl="xla"),
        data=jc.DataConfig(**DATA), train=jc.TrainConfig(batch_size=BATCH))
    jmodel, jstate = jax_create(jcfg)
    variables = to_jax_variables(init)
    params = variables["params"]
    jstate = jstate.replace(params=params,
                            batch_stats=variables["batch_stats"],
                            opt_state=jax_optimizer(jcfg).init(params))
    _, jm = jax_make_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"meshes": meshes, "port": port, "jax_loss": float(jm["loss"]),
            "batch": batch}


@pytest.mark.parametrize("name", list(MESHES))
def test_loss_matches_one_process_and_jax(runs, name):
    ranks, _ = runs["meshes"][name]
    losses = [r["loss"][0] for r in ranks]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], runs["port"]["loss"], atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(losses[0], runs["jax_loss"], atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"][0],
                               runs["port"]["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("name", list(MESHES))
def test_parameters_after_the_step(runs, name):
    ranks, _ = runs["meshes"][name]
    got, want = ranks[0]["state"], runs["port"]["state"]
    grads = runs["port"]["grads"]
    gmax = max(float(g.abs().max()) for g in grads.values())
    for key, g in grads.items():
        err = (got[key] - want[key]).abs()
        assert float(err.max()) <= 2 * LR, key
        big = g.abs() > 1e-3 * gmax
        assert float(err[big].max()) <= 1e-5 if big.any() else True, key


@pytest.mark.parametrize("name", list(MESHES))
def test_batchnorm_running_stats(runs, name):
    ranks, _ = runs["meshes"][name]
    got, want = ranks[0]["state"], runs["port"]["state"]
    keys = [k for k in want if "running_" in k]
    assert len(keys) == 6
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name,axis", [("fsdp2", "fsdp"),
                                       ("model2", "model")])
def test_a_rank_holds_its_share_of_parameters_and_adam(runs, name, axis):
    ranks, _ = runs["meshes"][name]
    for r in ranks:
        split = 0
        for key, (local, full, mu, nu, on_fsdp, on_model) in \
                r["sizes"].items():
            cut = on_fsdp if axis == "fsdp" else on_model
            assert (local, mu, nu) == ((full // 2,) * 3 if cut
                                       else (full,) * 3), key
            split += cut
        assert split >= 8


def test_mesh_of_one_is_the_one_process_step_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, dropout=0.1, remat=True))
    batch = _batch()
    np.savez(tmp_path / "batch.npz", **batch)
    model = dict(MODEL, dropout=0.1, remat=True)
    (rank,) = worker.run("train", 1, dict(model=model, data=DATA,
                                           train=dict(batch_size=BATCH),
                                           steps=2), str(tmp_path))
    # One thread, as the rank runs: the CPU kernels' sums split by thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg)
        losses, norms = [], []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        torch.set_num_threads(threads)
    assert rank["loss"] == losses and rank["grad_norm"] == norms
    sd = state.model.state_dict()
    assert all(torch.equal(rank["state"][k], sd[k]) for k in sd)


def test_checkpoint_under_a_mesh_restores_into_one_device(runs):
    ranks, d = runs["meshes"]["data2xmodel2"]
    sep = Separator.from_checkpoint(str(d / "ckpt"), CFG.model, CFG.data,
                                    device="cpu")
    full = ranks[0]["state"]
    assert all(torch.equal(v, full[k])
               for k, v in sep.model.state_dict().items())
    batch = runs["batch"]
    separated, masks = sep.separate(batch["mixed_spec"][:2],
                                    batch["lip_frames"][:2])
    for r in ranks:  # every rank of the mesh Separator returns the whole
        np.testing.assert_allclose(r["separated"][0], separated, atol=1e-5)
        np.testing.assert_allclose(r["separated"][1], masks, atol=1e-5)
