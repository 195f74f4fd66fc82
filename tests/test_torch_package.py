"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless the caller asks for the
CPU, chip_smoke.py refuses to run without a card, and its configs keep the
JAX configs' shared fields."""

import dataclasses
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import av_separation_torch
from av_separation_torch.config import DataConfig, ModelConfig, get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        av_separation_torch.__path__, prefix="av_separation_torch."))


def test_no_jax_in_a_fresh_interpreter():
    names = _modules()
    assert {"av_separation_torch.ops.kernels.attention",
            "av_separation_torch.ops.kernels.stft",
            "av_separation_torch.data.device_synthetic",
            "av_separation_torch.utils.checkpoint",
            "av_separation_torch.utils.profiling",
            "av_separation_torch.cli"} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'av_separation_tpu'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model
    cfg = ModelConfig(freq_bins=65, d_model=64, nhead=2,
                      num_encoder_layers=1, num_fusion_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    state = build_model(cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(cfg, state)
    assert Separator(cfg, state, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:  # a directory holding chip_smoke.py and nothing else
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("name", ["demo", "scaled", "three_speaker", "lrs2",
                                  "multihost"])
def test_configs_match_the_jax_package(name):
    from av_separation_tpu.config import get_config as jax_get_config
    ours, ref = get_config(name), jax_get_config(name)
    for mine, theirs, cls in ((ours.model, ref.model, ModelConfig),
                              (ours.data, ref.data, DataConfig)):
        for f in dataclasses.fields(cls):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
