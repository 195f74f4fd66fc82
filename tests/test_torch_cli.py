"""The port's command line on the CPU: training, eval and separate.

`python -m av_separation_torch.cli` runs in process on the demo config with
`--cpu --batch 2` for a few steps: train over the host and the device
pipelines, fused and per step; eval; separate; eval and separate reading a
checkpoint; `cli serve` as a process over HTTP.  The resumes and the
checkpoints are in tests/test_torch_cli_resume.py, the flags and
`--debug-nans` in tests/test_torch_cli_flags.py, the files and native
pipelines' runs in tests/test_torch_cli_data.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from av_separation_torch import cli
from av_separation_torch.config import get_config

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


def test_eval_and_separate_read_the_checkpoint(capsys, tmp_path):
    d = str(tmp_path / "c")
    run(capsys, "train", *DEMO, "--steps", "2", "--data", "device",
        "--checkpoint-dir", d)
    fresh = run(capsys, "eval", *DEMO)[0]
    trained = run(capsys, "eval", *DEMO, "--checkpoint-dir", d)[0]
    assert trained != fresh
    assert run(capsys, "separate", *DEMO, "--checkpoint-dir", d)[0][
        "waveform_shape"] == [2, 2, 8000]


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
                             "audio_proj_split[bf16]", "dropout_fwd",
                             "dropout_bwd", "dropout_fwd[bf16]",
                             "dropout_bwd[bf16]")}}
    assert "untrained init" in err
