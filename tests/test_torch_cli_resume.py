"""The port's resumes, checkpoints and waveform helpers, on the CPU.

A `cli train` run resumed from a checkpoint reproduces an uninterrupted run
bit for bit (host and fused device pipelines); `utils/checkpoint.py` saves,
restores, keeps the newest and reports what is missing; a Separator
restored from the checkpoint reproduces the saved model's masks;
`permutation_si_snr_waveform` against the JAX package's; the profiling
helpers.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from av_separation_torch import cli
from av_separation_torch.config import get_config
from av_separation_torch.data.device_synthetic import generate_batch
from av_separation_torch.inference import Separator
from av_separation_torch.ops.istft import permutation_si_snr_waveform
from av_separation_torch.train import create_train_state, make_train_step
from av_separation_torch.utils import checkpoint as ckpt
from av_separation_torch.utils.profiling import (Timer, step_metrics_line,
                                                 trace)

DEMO = ["--config", "demo", "--cpu", "--batch", "2"]


def run(capsys, *args):
    """cli.main in process -> its JSON stdout lines."""
    assert cli.main(list(args)) == 0
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def final(lines):
    assert "final_step" in lines[-1], lines
    return lines[-1]


@pytest.mark.parametrize("pipeline", [["--data", "host"],
                                      ["--data", "device", "--fused"]])
def test_resume_is_bit_equal(capsys, tmp_path, pipeline):
    every = [*DEMO, *pipeline, "--checkpoint-every", "2"]
    straight = final(run(capsys, "train", *every, "--steps", "4",
                         "--checkpoint-dir", str(tmp_path / "a")))
    run(capsys, "train", *every, "--steps", "2", "--checkpoint-dir",
        str(tmp_path / "b"))
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = final(run(capsys, "train", *every, "--steps", "4",
                        "--checkpoint-dir", str(tmp_path / "b")))
    assert resumed["loss"] == straight["loss"]
    assert sorted(os.listdir(tmp_path / "b")) == ["2.pt", "4.pt"]
    a = ckpt.restore_variables(str(tmp_path / "a"))
    b = ckpt.restore_variables(str(tmp_path / "b"))
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# utils/checkpoint.py
# ---------------------------------------------------------------------------

def _tiny():
    cfg = get_config("demo")
    model = dataclasses.replace(cfg.model, d_model=64, nhead=2,
                                num_encoder_layers=1, num_fusion_layers=1)
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, batch_size=2))


def _trained(cfg, steps):
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    for i in range(steps):
        state, _ = step(state, generate_batch(
            torch.Generator().manual_seed(i), cfg.data, 2))
    return state


def test_checkpoint_round_trip_restores_everything(tmp_path):
    cfg = _tiny()
    state = _trained(cfg, 2)
    ckpt.save_checkpoint(str(tmp_path), state.step, state, wait=True)
    fresh = ckpt.restore_checkpoint(str(tmp_path),
                                    create_train_state(cfg, device="cpu"))
    assert fresh.step == 2
    want = state.model.state_dict()
    assert any("running_mean" in k for k in want)  # BatchNorm statistics
    assert all(torch.equal(v, want[k])
               for k, v in fresh.model.state_dict().items())
    a, b = state.optimizer.adam.state_dict(), \
        fresh.optimizer.adam.state_dict()
    for i, s in a["state"].items():
        assert all(torch.equal(s[k], b["state"][i][k]) for k in s)
    assert torch.equal(fresh.generators.seeds.get_state(),
                       state.generators.seeds.get_state())
    assert torch.equal(fresh.generators.bits.get_state(),
                       state.generators.bits.get_state())


def test_save_snapshots_before_returning(tmp_path):
    cfg = _tiny()
    state = _trained(cfg, 1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)  # training goes on while the file is written
    ckpt.wait_until_finished(str(tmp_path))
    got = ckpt.restore_variables(str(tmp_path))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_keeps_the_newest_and_restores_a_named_step(tmp_path):
    cfg = _tiny()
    state = create_train_state(cfg, device="cpu")
    for step in (1, 2, 3, 4):
        state.step = step
        ckpt.save_checkpoint(str(tmp_path), step, state, max_to_keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["3.pt", "4.pt"]
    again = create_train_state(cfg, device="cpu")
    assert ckpt.restore_checkpoint(str(tmp_path), again, step=3).step == 3


def test_missing_checkpoints(tmp_path):
    cfg = _tiny()
    state = create_train_state(cfg, device="cpu")
    assert ckpt.restore_checkpoint(str(tmp_path / "none"), state) is state
    assert ckpt.restore_checkpoint(str(tmp_path), state).step == 0
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_variables(str(tmp_path))


def test_from_checkpoint_reproduces_the_saved_models_masks(tmp_path):
    cfg = _tiny()
    state = _trained(cfg, 2)
    ckpt.save_checkpoint(str(tmp_path), state.step, state, wait=True)
    batch = generate_batch(torch.Generator().manual_seed(9), cfg.data, 2)
    mixed, lips = batch["mixed_spec"].numpy(), batch["lip_frames"].numpy()
    want = Separator(cfg.model, state.model.state_dict(), cfg.data,
                     device="cpu").separate(mixed, lips)
    got = Separator.from_checkpoint(str(tmp_path), cfg.model, cfg.data,
                                    device="cpu").separate(mixed, lips)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0],
                                                              want[0])


# ---------------------------------------------------------------------------
# ops/istft.py permutation_si_snr_waveform, utils/profiling.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 3])
def test_permutation_si_snr_waveform_matches_jax(s):
    import jax.numpy as jnp

    from av_separation_tpu.ops.istft import (
        permutation_si_snr_waveform as jax_fn)
    rng = np.random.default_rng(s)
    targets = rng.normal(size=(3, s, 400)).astype(np.float32)
    estimates = (targets[:, ::-1] + 0.3 * rng.normal(size=targets.shape)
                 ).astype(np.float32)
    ref = jax_fn(jnp.asarray(estimates), jnp.asarray(targets))
    ours = permutation_si_snr_waveform(torch.from_numpy(estimates),
                                       torch.from_numpy(targets))
    assert ours.shape == (3,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


def test_profiling_helpers(tmp_path):
    timer = Timer()
    with trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert timer.elapsed() > 0.0
    line = json.loads(step_metrics_line(3, {"loss": torch.tensor(1.5),
                                            "tag": "x"}, {"rate": 2}))
    assert line == {"step": 3, "loss": 1.5, "tag": "x", "rate": 2}
