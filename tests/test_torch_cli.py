"""The port's command line, checkpoints and profiling helpers, on the CPU.

`python -m av_separation_torch.cli` runs in process on the demo config with
`--cpu --batch 2` for a few steps: train over the host and the device
pipelines, fused and per step; eval; separate; `--debug-nans`.  A run
resumed from a checkpoint reproduces an uninterrupted run bit for bit, and
a Separator restored from the checkpoint reproduces the saved model's
masks.  The files and native pipelines' runs are in
tests/test_torch_cli_data.py.
"""

import contextlib
import dataclasses
import io
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


@pytest.mark.parametrize("pipeline", [
    ["--data", "host"], ["--data", "device"], ["--data", "device", "--fused"]])
def test_train_prints_the_final_line(capsys, pipeline):
    lines = run(capsys, "train", *DEMO, "--steps", "2", *pipeline)
    last = final(lines)
    assert last["final_step"] == 2
    assert np.isfinite(last["loss"]) and last["audio_s_per_s"] > 0


def test_fused_segments_land_on_log_and_eval_steps(capsys):
    # log_every 20, eval every 2 -> segments of 2; eval lines at steps 2, 4.
    lines = run(capsys, "train", *DEMO, "--steps", "4", "--data", "device",
                "--fused", "--eval-every", "2")
    evals = [ln for ln in lines if "snr_improvement_db" in ln]
    assert [ln["step"] for ln in evals] == [2, 4]
    assert final(lines)["final_step"] == 4


def test_per_step_logs_at_log_every(capsys, monkeypatch):
    from av_separation_torch import config as tc
    demo = tc.demo_config()
    every_step = dataclasses.replace(
        demo, train=dataclasses.replace(demo.train, log_every=1))
    monkeypatch.setitem(tc.NAMED_CONFIGS, "demo", lambda: every_step)
    lines = run(capsys, "train", *DEMO, "--steps", "2", "--data", "device")
    steps = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])
               for ln in steps)


def test_eval_prints_the_snr_line(capsys):
    (line,) = run(capsys, "eval", *DEMO)
    assert set(line) == {"input_snr", "output_snr", "mask_min", "mask_max",
                         "snr_improvement_db"}
    assert 0.0 <= line["mask_min"] <= line["mask_max"] <= 1.0


def test_separate_prints_the_waveform_line(capsys):
    (line,) = run(capsys, "separate", *DEMO)
    assert line["batch"] == 2 and line["waveform_shape"] == [2, 2, 8000]
    assert np.isfinite(line["si_snr_waveform_db"])


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


def test_eval_and_separate_read_the_checkpoint(capsys, tmp_path):
    d = str(tmp_path / "c")
    run(capsys, "train", *DEMO, "--steps", "2", "--data", "device",
        "--checkpoint-dir", d)
    fresh = run(capsys, "eval", *DEMO)[0]
    trained = run(capsys, "eval", *DEMO, "--checkpoint-dir", d)[0]
    assert trained != fresh
    assert run(capsys, "separate", *DEMO, "--checkpoint-dir", d)[0][
        "waveform_shape"] == [2, 2, 8000]


@pytest.mark.parametrize("argv", [["train", "--impl", "pallas"]])
def test_flags_and_commands_still_to_port_are_refused(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--cpu"])
    assert e.value.code == 2


@pytest.fixture(scope="module")
def one_step_loss():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", *DEMO, "--steps", "1"]) == 0
    return final([json.loads(ln) for ln in out.getvalue().splitlines()
                  if ln.startswith("{")])["loss"]


@pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-fsdp",
                                  "--mesh-seq", "--mesh-model"])
def test_each_mesh_flag_at_one_runs_in_one_process(capsys, one_step_loss,
                                                   flag):
    """A mesh of one device in a one-process job is no mesh, as in the JAX
    CLI: the same loss as the run without the flag."""
    meshed = final(run(capsys, "train", *DEMO, "--steps", "1", flag, "1"))
    assert meshed["loss"] == one_step_loss


NEEDS_ALL_THREE = ("avsep: a multi-process job needs the coordinator "
                   "address, the process count and the process id")


@pytest.mark.parametrize("argv,message", [
    (["--coordinator", "127.0.0.1:1234"], NEEDS_ALL_THREE),
    (["--num-processes", "2"], NEEDS_ALL_THREE),
    (["--process-id", "0"], NEEDS_ALL_THREE),
    (["--coordinator", "127.0.0.1", "--num-processes", "2",
      "--process-id", "0"],
     "avsep: coordinator '127.0.0.1' is not host:port"),
    (["--coordinator", "127.0.0.1:1234", "--num-processes", "2",
      "--process-id", "2"],
     "avsep: process id 2 outside a job of 2 processes"),
    (["--mesh-data", "2", "--mesh-model", "4"],
     "avsep: mesh MeshConfig(data=2, fsdp=1, seq=1, model=4) needs 8 "
     "devices but the job has 1"),
    (["--config", "multihost"],
     "avsep: mesh MeshConfig(data=2, fsdp=1, seq=1, model=4) needs 8 "
     "devices but the job has 1"),
], ids=["coordinator-alone", "num-processes-alone", "process-id-alone",
        "coordinator-not-host-port", "process-id-outside", "mesh-too-big",
        "multihost-mesh-in-one-process"])
def test_multi_process_flags_are_validated(argv, message):
    with pytest.raises(SystemExit) as e:
        cli.main(["train", *DEMO, "--steps", "1", *argv])
    assert e.value.code == message


def test_files_without_a_data_root_exits_with_the_jax_message(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["train", *DEMO, "--steps", "1", "--data", "files"])
    assert e.value.code == "avsep: --data files requires --data-root"


@pytest.mark.parametrize("cmd", ["train", "eval", "separate"])
def test_debug_nans_keeps_a_clean_runs_numbers(capsys, cmd):
    """--debug-nans on clean data: the same JSON lines as without it (bit
    for bit on the CPU), and nothing left registered after the run."""
    extra = ["--steps", "2", "--data", "device"] if cmd == "train" else []
    plain = run(capsys, cmd, *DEMO, *extra)
    checked = run(capsys, cmd, *DEMO, *extra, "--debug-nans")
    if cmd == "train":
        plain, checked = [{k: v for k, v in ln.items()
                           if k != "audio_s_per_s"}
                          for ln in (plain[-1], checked[-1])]
    assert checked == plain
    assert not torch.is_anomaly_enabled()


def test_debug_nans_names_the_module_in_a_cli_run(capsys, monkeypatch):
    """A NaN batch through `cli train --debug-nans` stops the run with
    FloatingPointError at the projection; without the flag it trains on."""
    from av_separation_torch.data import loader

    real = loader.batch_iterator

    def poisoned(*a, **kw):
        for batch in real(*a, **kw):
            batch = {k: v.copy() for k, v in batch.items()}
            batch["mixed_spec"][0, 0, 0] = np.nan
            yield batch

    monkeypatch.setattr(loader, "batch_iterator", poisoned)
    with pytest.raises(FloatingPointError, match="audio_encoder.projection"):
        cli.main(["train", *DEMO, "--steps", "1", "--data", "host",
                  "--debug-nans"])
    assert not np.isfinite(final(run(capsys, "train", *DEMO, "--steps", "1",
                                     "--data", "host"))["loss"])


def test_commands_need_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cmd in ("train", "eval", "separate", "serve"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([cmd, "--config", "demo", "--steps", "1"])


def test_serve_answers_over_http_and_stops_on_sigint():
    """`cli serve --cpu` as a process: /healthz, one /separate_waveform of
    the demo config's shape, then SIGINT stops it cleanly."""
    import io
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.error
    import urllib.request
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "av_separation_torch.cli", "serve", "--config",
         "demo", "--cpu", "--serve-host", "127.0.0.1", "--serve-port",
         str(port)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()
            try:
                with urllib.request.urlopen(f"{base}/healthz",
                                            timeout=5) as resp:
                    assert resp.status == 200
                    break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "no /healthz"
                time.sleep(0.2)
        d = get_config("demo").data
        rng = np.random.default_rng(0)
        buf = io.BytesIO()
        np.savez(buf, mixed_audio=rng.normal(
            size=d.num_samples_audio).astype(np.float32),
            lip_frames=rng.uniform(size=(d.total_lip_frames, d.frame_h,
                                         d.frame_w)).astype(np.float32))
        req = urllib.request.Request(f"{base}/separate_waveform",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
            with np.load(io.BytesIO(resp.read())) as z:
                assert z["waveforms"].shape == (2, d.num_samples_audio)
                assert np.isfinite(z["waveforms"]).all()
                assert z["masks"].shape == (2, d.freq_bins,
                                            d.num_stft_frames)
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert f"avsep serving on http://127.0.0.1:{port}" in out
    assert json.loads(out.splitlines()[-1]) == {"kernel_launches": {
        name: 0 for name in ("flash_attn_fwd", "flash_attn_bwd",
                             "audio_proj_fwd", "mask_decoder_fwd",
                             "stft_mag_fwd", "stft_mag_4step_fwd",
                             "flash_attn_fwd[bf16]", "flash_attn_bwd[bf16]",
                             "audio_proj_fwd[bf16]", "audio_proj_split",
                             "audio_proj_split[bf16]")}}
    assert "untrained init" in err


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
