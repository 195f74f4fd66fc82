"""The port's command-line flags on the CPU.

Flags still to port are refused; each mesh flag at one runs in one process
with the loss of the run without it; the multi-process flags are checked
with the JAX CLI's messages; `--data files` needs a root; `--debug-nans`
keeps a clean run's numbers and names the module of a NaN; without `--cpu`
and without a card every command raises.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from av_separation_torch import cli

DEMO = ["--config", "demo", "--cpu", "--batch", "2"]


def run(capsys, *args):
    """cli.main in process -> its JSON stdout lines."""
    assert cli.main(list(args)) == 0
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def final(lines):
    assert "final_step" in lines[-1], lines
    return lines[-1]


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
