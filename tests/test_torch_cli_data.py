"""`python -m av_separation_torch.cli train` over the files and native
pipelines, on the CPU (demo config, `--cpu --batch 2`): the final line,
and a run resumed from a checkpoint equal to an uninterrupted one bit for
bit (tests/test_torch_cli.py holds the host and device pipelines')."""

import json

import numpy as np
import pytest

from av_separation_torch import cli
from av_separation_torch.config import get_config
from av_separation_torch.utils import checkpoint as ckpt

DEMO = ["--config", "demo", "--cpu", "--batch", "2"]
PIPELINES = {"files": ["--data", "files"],
             "files_dynamic": ["--data", "files", "--dynamic-mix"],
             "native": ["--data", "native"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 demo samples as a corpus on disk: 3 batches of 2 an epoch, so a
    run resumed at step 2 crosses an epoch boundary."""
    from av_separation_torch.data.files import write_synthetic_corpus
    root = str(tmp_path_factory.mktemp("corpus"))
    write_synthetic_corpus(root, get_config("demo").data, 6)
    return root


def train(capsys, corpus, pipeline, *args):
    """cli train in process -> its final JSON line."""
    argv = ["train", *DEMO, *PIPELINES[pipeline], *args]
    if pipeline.startswith("files"):
        argv += ["--data-root", corpus]
    assert cli.main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert "final_step" in lines[-1], lines
    return lines[-1]


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_train_prints_the_final_line(capsys, corpus, pipeline):
    last = train(capsys, corpus, pipeline, "--steps", "2")
    assert last["final_step"] == 2
    assert np.isfinite(last["loss"]) and last["audio_s_per_s"] > 0


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_resume_is_bit_equal(capsys, tmp_path, corpus, pipeline):
    every = ["--checkpoint-every", "2"]
    straight = train(capsys, corpus, pipeline, *every, "--steps", "4",
                     "--checkpoint-dir", str(tmp_path / "a"))
    train(capsys, corpus, pipeline, *every, "--steps", "2",
          "--checkpoint-dir", str(tmp_path / "b"))
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = train(capsys, corpus, pipeline, *every, "--steps", "4",
                    "--checkpoint-dir", str(tmp_path / "b"))
    assert resumed["loss"] == straight["loss"]
    a = ckpt.restore_variables(str(tmp_path / "a"))
    b = ckpt.restore_variables(str(tmp_path / "b"))
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
