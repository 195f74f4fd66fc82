#!/usr/bin/env python3
"""Device times of the PyTorch port's STFT kernels on one NVIDIA GPU.

Three modes, each printing one JSON line:

  python3 tools/torch_stft_sweep.py tiles
      the one-block kernel's device time at every tile (frames a block)
      whose block fits shared memory, beside the tile `fft_tile_frames`
      picks, at the shapes its rule was measured on.
  python3 tools/torch_stft_sweep.py rows --root DIR
      the device time of `stft_magnitude_fwd` of the checkout at DIR (this
      one by default) at the rows every version of the kernel runs, on the
      scaled and demo device batches, and above n_fft 4096 (one frame a
      block, 66,000 one-frame signals under Bluestein, and the four-step
      FFT; a checkout that predates them runs what it has there), with
      torch.stft's beside each row above 4096.  Run it over two checkouts
      in turns (A, B, B, A) to compare them on one card.
  python3 tools/torch_stft_sweep.py variants --source FILE [--source
          FILE ...] [--module PY ...] [--rows small|bluestein|large]
      builds other versions of `stft_fft.cu` (an earlier one, for example
      `git show HEAD~1:av_separation_torch/csrc/stft_fft.cu > FILE`, or a
      variant) with the same flags, and times the n_fft <= 4096 rows
      (`small`: the 7-smooth rows and 514, 401 and 1102, which once ran
      Bluestein at a power of two), 18 rows over the prime-radix, Rader
      and Bluestein plans (`bluestein`), or the rows above 4096 (`large`,
      each 'fft' row at
      tiles 1 and 2 where they fit) through each and through this
      checkout's build in turns (this, 1, ..., n, n, ..., 1, this), in one
      process, torch.stft beside each row.  The i-th `--module` (the
      `ops/kernels/stft.py` of the i-th source's version, e.g. from `git
      show`) plans and calls that source, so a version whose plans or C
      entry point differ runs as it did; a source without one runs
      through this checkout's module.
      Every output is compared with this checkout's (bit for bit, and the
      largest difference); each build's registers and spills per kernel
      instance are printed.

Device times come from `chip_smoke.device_ms` (torch.profiler kernel
durations; a trace short of events is retaken).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _tones(cfg):
    """The device generator's batch of 8 at DataConfig `cfg`: 24 signals
    (the mixture and two clean sources each)."""
    import torch

    from av_separation_torch.data.device_synthetic import (clean_waveforms,
                                                           draw_variates,
                                                           step_generator)
    v = draw_variates(step_generator(0, 0, "cuda"), cfg, 8)
    clean = clean_waveforms(v, cfg)
    audio = torch.cat([clean.sum(dim=1, keepdim=True), clean], dim=1)
    return audio.reshape(-1, cfg.num_samples_audio).contiguous()


def _batches(smoke):
    """The scaled, 44.1 kHz and demo device batches."""
    from av_separation_torch.config import get_config
    return (_tones(smoke._data_config("scaled")),
            _tones(smoke._data_config("44.1 kHz")),
            _tones(get_config("demo").data))


def _small_rows(smoke):
    """The n_fft <= 4096 rows: (label, audio, n_fft, hop)."""
    import torch
    scaled, k44, demo = _batches(smoke)
    odd = torch.randn(3, 2001,
                      generator=torch.Generator().manual_seed(0)).cuda()
    many = torch.randn(70000, 1024,
                       generator=torch.Generator().manual_seed(4)).cuda()
    return [("scaled 512", scaled, 512, 128), ("demo 512", demo, 512, 128),
            ("odd 128", odd, 128, 64), ("scaled 400", scaled, 400, 160),
            ("scaled 448", scaled, 448, 112),
            ("44.1 kHz 882", k44, 882, 441),
            ("70,000 x 1,024 128", many, 128, 64),
            ("scaled 514 Rader", scaled, 514, 128),
            ("scaled 401 odd Rader", scaled, 401, 160),
            ("44.1 kHz 1102 prime radices", k44, 1102, 441)]


def _bluestein_rows(smoke):
    """n_fft <= 4096 whose L has a prime factor above 7, over the three
    plans that serve them: the prime radices, Rader and Bluestein over a
    7-smooth P (an earlier version ran them all under Bluestein at a
    power of two)."""
    scaled, k44, demo = _batches(smoke)
    return [("scaled 46 radix 23", scaled, 46, 23),
            ("scaled 22 Rader over 10", scaled, 22, 11),
            ("demo 62 Rader over 30", demo, 62, 30),
            ("scaled 286 radices 11, 13", scaled, 286, 143),
            ("44.1 kHz 1102 radices 19, 29", k44, 1102, 441),
            ("scaled 1922 radices 31, 31", scaled, 1922, 480),
            ("scaled 1001 odd radices 7, 11, 13", scaled, 1001, 250),
            ("scaled 514 Rader over 256", scaled, 514, 128),
            ("scaled 401 odd Rader over 400", scaled, 401, 160),
            ("scaled 1154 Rader over 576", scaled, 1154, 577),
            ("scaled 1153 odd Rader over 1152", scaled, 1153, 288),
            ("scaled 402 Bluestein P 405", scaled, 402, 100),
            ("scaled 886 Bluestein P 896", scaled, 886, 221),
            ("scaled 948 Bluestein P 960", scaled, 948, 237),
            ("scaled 1006 Bluestein P 1008", scaled, 1006, 250),
            ("scaled 1005 odd Bluestein P 2016", scaled, 1005, 250),
            ("scaled 4094 Bluestein P 4096", scaled, 4094, 1024),
            ("scaled 4093 odd Bluestein P 8192", scaled, 4093, 1000)]


def _large_rows(smoke):
    """Rows above n_fft 4096 on the scaled batch, 24 noise signals of
    176,400 samples (4 s at 44.1 kHz) and 66,000 noise signals of one
    4,098-sample frame (chip_smoke.py's row: T 1, the fifth field)."""
    import torch
    scaled = _batches(smoke)[0]
    k44 = torch.randn(24, 176400,
                      generator=torch.Generator().manual_seed(1)).cuda()
    frames1 = torch.randn(66000, 4098, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
    return [("scaled 8192", scaled, 8192, 1024),
            ("scaled 16384", scaled, 16384, 4096),
            ("44.1 kHz 4410", k44, 4410, 441),
            ("66,000 x 4098 Bluestein", frames1, 4098, 4098, 1),
            ("44.1 kHz 8194 four-step Bluestein", k44, 8194, 2048),
            ("44.1 kHz 32768 four-step", k44, 32768, 8192)]


def rows(smoke) -> dict:
    from av_separation_torch.ops.kernels import stft
    out = {}
    for label, audio, n_fft, hop, *t in (_small_rows(smoke)
                                         + _large_rows(smoke)):
        t = t[0] if t else None
        fn = lambda: stft.stft_magnitude_fwd(  # noqa: E731
            audio, n_fft, hop, t)
        out[label] = {"device_ms_runs": [smoke.device_ms(fn, 20, None)
                                         for _ in range(3)]}
        if n_fft > 4096:
            out[label]["torch.stft_device_ms_runs"] = [
                smoke.device_ms(lambda: _torch_stft(audio, n_fft, hop, t),
                                20, None) for _ in range(3)]
    return out


def tiles(smoke) -> dict:
    import torch

    from av_separation_torch.ops.kernels import stft
    chosen = stft.fft_tile_frames
    gen = torch.Generator().manual_seed(0)
    out = {}
    try:
        for b, n, n_fft, hop in [(24, 64000, 512, 128), (24, 64000, 514, 128),
                                 (24, 176400, 1102, 441),
                                 (24, 64000, 401, 160),
                                 (24, 176400, 882, 441),
                                 (24, 64000, 4096, 1024),
                                 (24, 64000, 4093, 1000),
                                 (24, 64000, 8192, 1024)]:
            audio = torch.randn(b, n, generator=gen).cuda()
            row = {"chosen": chosen(n_fft, hop, b, 1 + n // hop, 132)}
            for tile in (1, 2, 4, 8, 16):
                smem = stft.fft_smem_bytes(n_fft, hop, tile)
                if smem > stft.MAX_SMEM_BYTES:
                    continue
                stft.fft_tile_frames = lambda *a, tile=tile: tile
                fn = lambda: stft.stft_magnitude_fwd(  # noqa: E731
                    audio, n_fft, hop)
                row[str(tile)] = {"smem": smem, "device_ms": [
                    smoke.device_ms(fn, 30, None) for _ in range(2)]}
            out[f"{n_fft}/{hop}"] = row
    finally:
        stft.fft_tile_frames = chosen
    return out


def _large_noise_rows():
    """The 'large' rows of the variants mode: noise at the shapes of
    chip_smoke.py's rows above n_fft 4096 (66,000 and 6,600 one-frame
    signals)."""
    import torch
    gen = torch.Generator().manual_seed(3)
    scaled = torch.randn(24, 64000, generator=gen).cuda()
    k44 = torch.randn(24, 176400, generator=gen).cuda()
    frames1 = torch.randn(6600, 4098, generator=gen).cuda()
    frames66 = torch.randn(66000, 4098, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    long8 = torch.randn(8, 441000, generator=gen).cuda()
    return [("scaled 8192", scaled, 8192, 1024),
            ("scaled 16384", scaled, 16384, 4096),
            ("44.1 kHz 4410", k44, 4410, 441),
            ("6,600 x 4098 Bluestein", frames1, 4098, 4098),
            ("66,000 x 4098 Bluestein", frames66, 4098, 4098),
            ("44.1 kHz 8194 four-step Bluestein", k44, 8194, 2048),
            ("44.1 kHz 10125 four-step odd", k44, 10125, 2205),
            ("8 x 441,000 32768 four-step", long8, 32768, 8192)]


def _torch_stft(audio, n_fft: int, hop: int, t: int | None = None):
    """torch.stft with the symmetric Hann window, no centering, on the
    zero-padded signal, then abs, T frames (1 + N // hop by default):
    chip_smoke.py's yardstick."""
    import torch
    import torch.nn.functional as F
    n = audio.shape[-1]
    t = t or 1 + n // hop
    window = torch.hann_window(n_fft, periodic=False, device=audio.device)
    pad = max(0, (t - 1) * hop + n_fft - n)
    return torch.stft(F.pad(audio, (0, pad)), n_fft, hop, window=window,
                      center=False, return_complex=True)[..., :t].abs()


def _load_module(path: Path, lib, tag: str):
    """Another version's `ops/kernels/stft.py`, its library `lib`."""
    import importlib.util
    import types

    from av_separation_torch.ops.kernels import _build
    spec = importlib.util.spec_from_file_location(f"stft_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(load=lambda name: lib,
                                       check=_build.check)
    return mod


def variants(smoke, sources, modules, which: str, log: str) -> dict:
    """Each row through this checkout's `stft_fft` library (its build log
    `log`) and through each of `sources` (built alike), in turns; a source
    with a module runs through it, one without through this checkout's
    module (the C entry points then keep their signatures)."""
    import ctypes

    import torch

    from av_separation_torch.ops.kernels import _build, stft

    def build(src, target):
        """nvcc as `_build` runs it, with ptxas's report; the report."""
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                               "-v", "-I", str(_build.CSRC_DIR), "-o",
                               str(target), str(src)],
                              check=True, capture_output=True, text=True)
        return smoke._ptxas_usage(done.stdout + done.stderr)

    mods = {"this": stft}
    # This checkout's library may have been built before this process:
    # its report then comes from a build of the same source beside it.
    ptxas = {"this": smoke._ptxas_usage(log) if log else build(
        _build.CSRC_DIR / "stft_fft.cu", _build.BUILD_DIR / "report.so")}
    for i, src in enumerate(sources):
        target = _build.BUILD_DIR / f"variant_{i}_{src.stem}.so"
        name = f"{i}:{src.stem}"
        ptxas[name] = build(src, target)
        lib = ctypes.CDLL(str(target))
        lib.avsep_error_string.argtypes = [ctypes.c_int]
        lib.avsep_error_string.restype = ctypes.c_char_p
        module = modules[i] if i < len(modules) else None
        if module is None:
            module = Path(stft.__file__)
        mods[name] = _load_module(module, lib, str(i))
    names = list(mods)
    order = names + names[::-1]
    rows = {"small": _small_rows, "bluestein": _bluestein_rows}.get(
        which, lambda smoke: _large_noise_rows())(smoke)
    saved = {n: m.fft_tile_frames for n, m in mods.items()}
    out = {"ptxas": ptxas}
    try:
        for label, audio, n_fft, hop in rows:
            tiles = [None]
            if which == "large" and stft.route(n_fft) == "fft":
                tiles = [1, 2]
            for tile in tiles:
                # The versions whose block fits at this tile (each plans
                # its own transform).
                present = [n for n in names if tile is None or (
                    mods[n].route(n_fft) == "fft"
                    and mods[n].fft_smem_bytes(n_fft, hop, tile)
                    <= stft.MAX_SMEM_BYTES)]
                if "this" not in present:
                    continue
                for n, m in mods.items():
                    m.fft_tile_frames = saved[n] if tile is None else (
                        lambda *a, tile=tile: tile)

                def run(name, audio=audio, n_fft=n_fft, hop=hop):
                    return mods[name].stft_magnitude_fwd(audio, n_fft, hop)

                ref = run("this")
                same, diff = {}, {}
                for n in present:
                    got = run(n)
                    same[n] = bool(torch.equal(ref, got))
                    diff[n] = float((ref - got).abs().max())
                times = {n: [] for n in present}
                for name in [n for n in order if n in present]:
                    times[name].append(smoke.device_ms(
                        lambda: run(name), 20, None))
                key = label if tile is None else f"{label}, tile {tile}"
                out[key] = {"plan": str(stft.fft_plan(n_fft)),
                            "bit_identical": same, "max_abs_diff": diff,
                            "device_ms": times}
            out[label + ", torch.stft"] = smoke.device_ms(
                lambda: _torch_stft(audio, n_fft, hop), 20, None)
    finally:
        for n, m in mods.items():
            m.fft_tile_frames = saved[n]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("tiles", "rows", "variants"))
    parser.add_argument("--root", default=str(Path(__file__).parents[1]))
    parser.add_argument("--source", type=Path, action="append", default=[],
                        help="variants mode: another stft_fft.cu")
    parser.add_argument("--module", type=Path, action="append", default=[],
                        help="variants mode: the ops/kernels/stft.py of "
                             "the source of the same position")
    parser.add_argument("--rows", choices=("small", "bluestein", "large"),
                        default="small", help="variants mode: the rows")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_stft_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from av_separation_torch.ops.kernels import _build
    log = _build.build(("stft_fft",), ptxas_verbose=True)["stft_fft"]
    if args.mode == "variants":
        result = variants(chip_smoke, [p.resolve() for p in args.source],
                          [p.resolve() for p in args.module], args.rows, log)
    else:
        result = (tiles if args.mode == "tiles" else rows)(chip_smoke)
    print(json.dumps({"mode": args.mode, "root": args.root,
                      "card": chip_smoke.card_line(), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
