"""The port's bench (`av_separation_torch.bench`, `cli bench`) on the CPU,
and its roofline table (`utils/roofline.py`)."""

import dataclasses
import json

import pytest

from av_separation_torch import bench, cli
from av_separation_torch.config import get_config
from av_separation_torch.utils import roofline

KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("mode", ["fused", "per_step"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cli_bench_prints_the_jax_line(capsys, mode, dtype):
    assert cli.main(["bench", "--cpu", "--steps", "2", "--batch", "2",
                     "--mode", mode, "--dtype", dtype]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    # On the CPU there is no card to price: the JAX bench's four keys.
    assert set(out) == KEYS
    assert out["unit"] == "audio-s/s/chip" and out["value"] > 0
    assert out["metric"] == ("audio-seconds/s/chip (fwd+bwd train step, "
                             f"demo config, batch=2, {dtype})")
    # Both numbers are rounded to 2 decimals from the unrounded rate.
    assert abs(out["vs_baseline"]
               - out["value"] / bench.REFERENCE_AUDIO_S_PER_S) <= 0.0051


def test_bench_defaults_are_the_jax_bench_defaults():
    import argparse
    p = argparse.ArgumentParser()
    bench.add_flags(p)
    args = p.parse_args([])
    assert (args.config, args.steps, args.batch, args.dtype, args.mode,
            args.cpu) == ("demo", 250, 128, "bfloat16", "fused", False)


@pytest.mark.parametrize("argv", [["bench", "--impl", "pallas"],
                                  ["bench", "--mesh-data", "2"]])
def test_bench_refuses_the_flags_still_to_port(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--cpu"])
    assert e.value.code == 2


class TestRoofline:
    def test_h100_fields(self):
        cfg = get_config("demo")
        flops = roofline.train_step_flops(cfg, 128)
        nbytes = roofline.train_step_bytes(cfg, 128)
        out = roofline.roofline(flops, nbytes, 0.05, "bfloat16",
                                "NVIDIA H100 80GB HBM3")
        assert out["device"] == "h100_sxm"
        assert set(out) == {"device", "pct_peak_flops", "bound",
                            "pct_roofline", "hbm_gb_per_s"}
        assert out["pct_peak_flops"] == round(100 * flops / 0.05 / 989e12, 2)
        t_lb = max(flops / 989e12, nbytes / 3.35e12)
        assert out["pct_roofline"] == round(100 * t_lb / 0.05, 2)
        f32 = roofline.roofline(flops, nbytes, 0.05, "float32",
                                "NVIDIA H100 80GB HBM3")
        assert f32["pct_peak_flops"] == round(100 * flops / 0.05 / 67e12, 2)

    @pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA A100",
                                      "cpu", ""])
    def test_unknown_card_gives_nothing(self, name):
        assert roofline.roofline(1e12, 1e9, 1.0, "bfloat16", name) == {}

    def test_accounting_matches_the_jax_package(self):
        from av_separation_tpu.config import get_config as jax_config
        from av_separation_tpu.utils import roofline as jr
        for name in ("demo", "scaled", "multihost"):
            for dtype in ("float32", "bfloat16"):
                tcfg, jcfg = get_config(name), jax_config(name)
                tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
                    tcfg.model, compute_dtype=dtype))
                jcfg = dataclasses.replace(jcfg, model=jcfg.model.replace(
                    compute_dtype=dtype))
                assert roofline.model_forward_flops(tcfg) \
                    == jr.model_forward_flops(jcfg)
                assert roofline.train_step_flops(tcfg, 8) \
                    == jr.train_step_flops(jcfg, 8)
                assert roofline.param_count(tcfg) == jr.param_count(jcfg)
                assert roofline.train_step_bytes(tcfg, 8) \
                    == jr.train_step_bytes(jcfg, 8, attn_impl="pallas")


@pytest.mark.parametrize("main", [lambda a: cli.main(["bench", *a]),
                                  bench.main])
def test_bench_refuses_an_unknown_config(main, capsys):
    with pytest.raises(SystemExit, match="unknown config 'nope'"):
        main(["--config", "nope", "--cpu"])
