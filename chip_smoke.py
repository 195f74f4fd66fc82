#!/usr/bin/env python3
"""Drive the PyTorch port (`av_separation_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failed phase makes the exit code nonzero:
  env      card name and power limit (nvidia-smi); TF32 off for matmuls and
           cuDNN convolutions, so every float32 product is a float32 product.
  build    nvcc builds every kernel of `av_separation_torch/csrc/` (in
           parallel) into build/torch_kernels/; prints the build seconds and
           each kernel's registers and spills.
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the serving and training paths give it (plus the demo
           shapes and one T > 512 attention): max abs error with its
           tolerance, kernel / plain / library times (CUDA events) and the
           kernel's bound.  Flash attention at dropout 0 and 0.1, forward
           and backward; each backward is run twice and must give
           bit-identical gradients.
  golden   demo config with the reference weights (tests/golden/) through
           the kernels, against the reference's outputs at the tolerances of
           tests/test_parity.py.
  serve    the scaled config at full width and depth (seeded random
           weights): a Separator on the card behind a
           BatchingSeparatorServer(max_batch=8) answers 16 waveform requests
           (4 s at 16 kHz, 200 lip frames) from 4 threads.  The launch counts
           are zeroed just before and read just after; every forward must
           launch 16 attention, 1 projection and 1 decoder kernel.  One
           batch is checked against the same model on the CPU.  No
           backward kernel may launch.
  profile  where the time of one served batch of 8 goes: host-clock batch
           time, then a torch.profiler trace summed per kernel name and
           group, and the device's busy share.
  train    the scaled config at full width and depth (seeded random
           weights), dropout 0.1, batches of 8 from the port's synthetic
           dataset, through create_train_state -> make_train_step: loss
           and grad norm per step (finite), ms per step, training audio-s/s
           and launches per step (16 flash forward, 16 flash backward,
           1 projection, 0 decoder; counts zeroed just before, read just
           after).  Then one step at dropout 0 and batch 2 on the card,
           against the same weights and batch in float64 on the CPU: loss,
           grad norm and the largest gradient error against stated
           tolerances (the CPU's float32 errors are printed beside them).
  train_profile  where the time of one train step goes (torch.profiler).
  demo     `av_separation_torch.demo`: 100 steps of the demo config on the
           card; fails below +35 dB or with masks outside [0, 1].
Then the kernel summary line, the card line, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero, printing no result, without a CUDA device or outside a
checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores

PALLAS = "av_separation_tpu/ops/pallas/"
KERNELS = {
    "flash_attn_fwd": {
        "source": "av_separation_torch/csrc/flash_attn_fwd.cu",
        "replaces": PALLAS + "attention.py:462",
        "also_replaces": [PALLAS + "attention.py:269",
                          PALLAS + "attention.py:677"],
    },
    "flash_attn_bwd": {
        "source": "av_separation_torch/csrc/flash_attn_bwd.cu",
        "replaces": PALLAS + "attention.py:502",
        "head_rate": 0.1,
        "also_replaces": [PALLAS + "attention.py:320",
                          PALLAS + "attention.py:828",
                          PALLAS + "attention.py:842",
                          PALLAS + "attention.py:870"],
    },
    "audio_proj_fwd": {
        "source": "av_separation_torch/csrc/audio_proj.cu",
        "replaces": PALLAS + "audio_proj.py:75",
        "also_replaces": [],
    },
    "mask_decoder_fwd": {
        "source": "av_separation_torch/csrc/mask_decoder.cu",
        "replaces": PALLAS + "decoder.py:82",
        "also_replaces": [],
    },
}
ATTN_SEED = -12345  # an int32 dropout seed with the sign bit set


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def within(a, b, atol: float, rtol: float = 0.0) -> bool:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(state):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["card"] = card_line()
    return {"card": state["card"],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": "off (cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False)"}


def phase_build(state):
    from av_separation_torch.ops.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    usage = {name: [ln.split("ptxas info    : ")[-1].strip()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    return {"build_s": round(secs, 2), "ptxas": usage}


def _attn_inputs(b, h, tq, tk, dh, kind, gen):
    """q/k/v as the serving path lays them out: self-attention reads three
    column slices of one fused projection; cross-attention reads q from its
    own projection and k/v from a fused (B, Tk, 2d) one; 'split' is the
    (B*H, T, dh) layout of the JAX `flash_attention` path."""
    from av_separation_torch.ops.attention import split_heads
    d = h * dh
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    if kind == "self":
        q, k, v = rnd(b, tq, 3 * d).split(d, dim=-1)
    elif kind == "cross":
        q = rnd(b, tq, d)
        k, v = rnd(b, tk, 2 * d).split(d, dim=-1)
    else:
        q = rnd(b * h, tq, dh).unsqueeze(1)
        k, v = (rnd(b * h, tk, dh).unsqueeze(1) for _ in range(2))
        return q, k, v
    return split_heads(q, h), split_heads(k, h), split_heads(v, h)


def phase_kernels(state):
    from av_separation_torch.ops.kernels.audio_proj import (
        audio_proj_fwd, audio_proj_fwd_torch)
    from av_separation_torch.ops.kernels.decoder import (
        mask_decoder_fwd, mask_decoder_fwd_torch)

    gen = torch.Generator().manual_seed(0)
    results = {name: [] for name in KERNELS}
    failures = []

    def record(name, shape, err, tol, extra_errs, fn_k, fn_p, fn_lib,
               nbytes, flops, iters, **extra):
        # In turns (kernel, plain, plain, kernel), each the mean of the two.
        times = [cuda_ms(fn, iters) for fn in (fn_k, fn_p, fn_p, fn_k)]
        ms, plain_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        lib_ms = cuda_ms(fn_lib, iters) if fn_lib is not None else None
        bound_ms, bound_by = bound(nbytes, flops)
        ok = err <= tol and all(e <= t for e, t in extra_errs.values()) \
            and extra.get("bit_identical", True)
        row = {"shape": shape, "max_abs_err": err, "tol": tol,
               "extra_errs": extra_errs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "ok": ok, **extra}
        results[name].append(row)
        emit({"kernel": name, **row})
        if not ok:
            failures.append(f"{name} {shape}")

    # flash attention: the scaled path's three shapes (serving at dropout
    # 0, training at 0.1), demo, split, long; forward, then backward.
    attn_cases = [
        ("scaled audio self", 8, 4, 501, 501, 128, "self"),
        ("scaled visual self", 8, 4, 200, 200, 128, "self"),
        ("scaled fusion cross", 8, 4, 501, 501, 128, "cross"),
        ("demo self", 4, 4, 63, 63, 32, "self"),
        ("demo cross split", 4, 4, 63, 50, 32, "split"),
        ("long self Tk>512", 2, 4, 1024, 1024, 128, "self"),
    ]
    for rate in (0.0, 0.1):
        for label, b, h, tq, tk, dh, kind in attn_cases:
            q, k, v = _attn_inputs(b, h, tq, tk, dh, kind, gen)
            _attn_rows(record, label, rate, q, k, v, gen)

    # fused audio projection at the scaled shape and the demo shape.
    for label, b, t, f, d in (("scaled", 8, 501, 257, 512),
                              ("demo", 4, 63, 257, 128)):
        x = torch.randn(b, t, f, generator=gen).abs().cuda()
        lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
        w1 = ((torch.rand(3, f, d, generator=gen) * 2 - 1) * lim1).cuda()
        b1 = ((torch.rand(d, generator=gen) * 2 - 1) * lim1).cuda()
        w2 = ((torch.rand(3, d, d, generator=gen) * 2 - 1) * lim2).cuda()
        b2 = ((torch.rand(d, generator=gen) * 2 - 1) * lim2).cuda()
        y_k, h_k = audio_proj_fwd(x, w1, b1, w2, b2)
        y_p, h_p = audio_proj_fwd_torch(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        nbytes = 4 * (b * t * f + 3 * f * d + 3 * d * d + 2 * d
                      + 2 * b * t * d)
        flops = 2 * b * t * 3 * (f + d) * d
        record("audio_proj_fwd", f"{label} B={b} T={t} F={f} D={d}",
               max_err(y_k, y_p), 1e-4, {"h": (max_err(h_k, h_p), 1e-4)},
               lambda: audio_proj_fwd(x, w1, b1, w2, b2),
               lambda: audio_proj_fwd_torch(x, w1, b1, w2, b2),
               None, nbytes, flops, 20)

    # fused mask decoder at the scaled shape and the demo shape.
    for label, b, t, d, s, f in (("scaled", 8, 501, 512, 2, 257),
                                 ("demo", 4, 63, 128, 2, 257)):
        x = torch.randn(b, t, d, generator=gen).cuda()
        lim1, lim2 = d ** -0.5, (2 * d) ** -0.5
        w1 = ((torch.rand(d, 2 * d, generator=gen) * 2 - 1) * lim1).cuda()
        b1 = ((torch.rand(2 * d, generator=gen) * 2 - 1) * lim1).cuda()
        w2 = ((torch.rand(2 * d, s * f, generator=gen) * 2 - 1)
              * lim2).cuda()
        b2 = ((torch.rand(s * f, generator=gen) * 2 - 1) * lim2).cuda()
        mixed = (torch.randn(b, f, t, generator=gen).abs() * 10).cuda()
        sep_k, m_k = mask_decoder_fwd(x, w1, b1, w2, b2, mixed, s)
        sep_p, m_p = mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, s)
        torch.cuda.synchronize()
        sf = s * f
        nbytes = 4 * (b * t * d + 2 * d * d + 2 * d + 2 * d * sf + sf
                      + b * f * t + 2 * b * sf * t)
        flops = 2 * b * t * (d * 2 * d + 2 * d * sf)
        sep_tol = 1e-5 * float(mixed.abs().max())
        record("mask_decoder_fwd", f"{label} B={b} T={t} d={d} S={s} F={f}",
               max_err(m_k, m_p), 1e-5,
               {"separated": (max_err(sep_k, sep_p), sep_tol)},
               lambda: mask_decoder_fwd(x, w1, b1, w2, b2, mixed, s),
               lambda: mask_decoder_fwd_torch(x, w1, b1, w2, b2, mixed, s),
               None, nbytes, flops, 20)

    state["kernel_rows"] = results
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    return {"checked": {n: len(r) for n, r in results.items()}}


def _attn_rows(record, label, rate, q, k, v, gen):
    """One forward row and one backward row of flash attention at `rate`.

    Float32 on both sides, sums over <= 1024 keys in another order: 2e-5
    on o and on the gradients (O(1) values), 1e-4 on lse.  The library
    yardstick is F.scaled_dot_product_attention (float32, same dropout
    rate), forward alone for the forward row and forward + backward for
    the backward row; the port never calls it.
    """
    import torch.nn.functional as F

    from av_separation_torch.ops.kernels.attention import (
        flash_attn_bwd, flash_attn_bwd_torch, flash_attn_fwd,
        flash_attn_fwd_torch)

    b, h, tq, dh = q.shape
    tk = k.shape[2]
    seed = ATTN_SEED
    shape = (f"{label} B={b} H={h} Tq={tq} Tk={tk} dh={dh} "
             f"dropout={rate}")
    o_k, lse_k = flash_attn_fwd(q, k, v, rate, seed)
    o_p, lse_p = flash_attn_fwd_torch(q, k, v, rate, seed)
    do = torch.randn(o_p.shape, generator=gen).cuda()
    g_k = flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed)
    g_k2 = flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed)
    g_p = flash_attn_bwd_torch(q, k, v, o_p, do, lse_p, rate, seed)
    torch.cuda.synchronize()
    bh = b * h
    lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     dropout_p=rate)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
        torch.autograd.grad(out, (qg, kg, vg), do)

    # Forward: 2 products of 2*Tq*Tk*dh against q, k, v in and o, lse out.
    record("flash_attn_fwd", shape, max_err(o_k, o_p), 2e-5,
           {"lse": (max_err(lse_k, lse_p), 1e-4)},
           lambda: flash_attn_fwd(q, k, v, rate, seed),
           lambda: flash_attn_fwd_torch(q, k, v, rate, seed), lib_fwd,
           4 * (bh * (2 * tq * dh + 2 * tk * dh) + bh * tq),
           4 * bh * tq * tk * dh, 20, dropout=rate)
    # Backward: the least work is 5 products (QK^T, dO V^T, dV, dQ, dK)
    # against q, k, v, o, dO, lse in and dQ, dK, dV out; what the kernels
    # recompute on top is not counted.
    errs = [max_err(x, y) for x, y in zip(g_k, g_p)]
    record("flash_attn_bwd", shape, max(errs), 2e-5,
           {"dq": (errs[0], 2e-5), "dk": (errs[1], 2e-5),
            "dv": (errs[2], 2e-5)},
           lambda: flash_attn_bwd(q, k, v, o_k, do, lse_k, rate, seed),
           lambda: flash_attn_bwd_torch(q, k, v, o_p, do, lse_p, rate, seed),
           lib_fwd_bwd,
           4 * (bh * (3 * tq * dh + 2 * tk * dh + tq)
                + bh * (tq * dh + 2 * tk * dh)),
           10 * bh * tq * tk * dh, 10, dropout=rate,
           bit_identical=all(torch.equal(x, y) for x, y in zip(g_k, g_k2)),
           library="F.scaled_dot_product_attention forward + backward")


def phase_golden(state):
    from av_separation_torch.config import get_config
    from av_separation_torch.models.model import AVSeparationTransformer
    from av_separation_torch.ops import kernels
    from av_separation_torch.utils.transplant import load_reference_state_dict

    path = ROOT / "tests" / "golden" / "golden_model.npz"
    cfg = get_config("demo").model
    model = AVSeparationTransformer(cfg)
    model.load_state_dict(load_reference_state_dict(str(path)))
    model = model.eval().cuda()
    g = np.load(path)
    mixed = torch.from_numpy(g["mixed"]).cuda()
    frames = torch.from_numpy(g["frames"]).cuda()
    t = mixed.shape[-1]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        separated, masks = model(mixed, frames)
        launches = dict(kernels.LAUNCHES)
        outs = {
            "masks": (masks, 2e-5),
            "separated": (separated, 2e-3),
            "audio_emb": (model.audio_encoder(mixed), 2e-4),
            "visual_emb": (model.visual_encoder(frames, t), 2e-4),
            "fused": (model.fusion(torch.from_numpy(g["audio_emb"]).cuda(),
                                   torch.from_numpy(g["visual_emb"]).cuda()),
                      2e-4),
        }
    errs, bad = {}, []
    for name, (out, atol) in outs.items():
        got = out.cpu().numpy()
        errs[name] = {"max_abs_err": float(np.abs(got - g[name]).max()),
                      "atol": atol, "rtol": 1e-4}
        if not within(got, g[name], atol, 1e-4):
            bad.append(name)
    want = {"flash_attn_fwd": 2 * cfg.num_encoder_layers
            + cfg.num_fusion_layers, "flash_attn_bwd": 0,
            "audio_proj_fwd": 1, "mask_decoder_fwd": 1}
    if launches != want:
        bad.append(f"launches {launches} != {want}")
    if bad:
        raise AssertionError(f"golden mismatch: {bad} {errs}")
    return {"errors": errs, "launches_per_forward": launches}


def phase_serve(state):
    from av_separation_torch.config import get_config
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops import kernels
    from av_separation_torch.serving import BatchingSeparatorServer

    cfg = get_config("scaled")
    state_dict = build_model(cfg.model, device="cpu", seed=0).state_dict()
    ds = SyntheticAVDataset(cfg.data)
    n_req, n_threads = 16, 4
    mixes, lips = [], []
    for i in range(n_req):
        audios, rng = ds.clean_audios(i)
        mixes.append(audios.sum(axis=0).astype(np.float32))
        lips.append(ds.lip_stream(audios, rng))

    sep = Separator(cfg.model, state_dict, cfg.data, device="cuda")
    server = BatchingSeparatorServer(sep, max_batch=8)
    try:
        server.warmup(batch_sizes=(1, 2, 4, 8), wave=True)
        torch.cuda.synchronize()
        results = [None] * n_req
        errors = []

        def client(tid):
            try:
                mine = list(range(tid, n_req, n_threads))
                handles = [(i, server.submit_waveform(mixes[i], lips[i]))
                           for i in mine]
                for i, handle in handles:
                    results[i] = handle.result(timeout=300)
            except Exception:  # noqa: BLE001 — reported by the phase
                errors.append(traceback.format_exc())

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats = server.stats.snapshot()
        latencies = sorted(server.stats.latency_ms)
    finally:
        server.close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"client failures: {errors}")
    state["launches"]["serve"] = launches
    state["serve_batch"] = (sep, np.stack(mixes[:8]), np.stack(lips[:8]))

    s, n_audio = cfg.model.num_speakers, cfg.data.num_samples_audio
    bad = []
    for i, (waves, masks) in enumerate(results):
        if waves.shape != (s, n_audio) or not np.isfinite(waves).all():
            bad.append(f"request {i}: waveforms {waves.shape}")
        if not (np.isfinite(masks).all() and masks.min() >= 0.0
                and masks.max() <= 1.0):
            bad.append(f"request {i}: masks outside [0, 1]")
    batches = stats["batches"]
    want = {"flash_attn_fwd": 16 * batches, "flash_attn_bwd": 0,
            "audio_proj_fwd": batches, "mask_decoder_fwd": batches}
    per_forward = 2 * cfg.model.num_encoder_layers \
        + cfg.model.num_fusion_layers
    if per_forward != 16 or launches != want:
        bad.append(f"launches {launches} != {want} over {batches} forwards")
    if stats["max_batch"] <= 1:
        bad.append("the server never coalesced requests")

    # One full batch of the same requests through the same model on the CPU.
    n_ref = server.max_batch
    cpu = Separator(cfg.model, state_dict, cfg.data, device="cpu")
    ref = cpu.separate_waveform(np.stack(mixes[:n_ref]),
                                np.stack(lips[:n_ref]))
    got_w = np.stack([results[i][0] for i in range(n_ref)])
    got_m = np.stack([results[i][1] for i in range(n_ref)])
    mask_err = float(np.abs(got_m - ref["masks"]).max())
    peak = float(np.abs(ref["waveforms"]).max())
    wave_err = float(np.abs(got_w - ref["waveforms"]).max())
    if mask_err > 1e-4:
        bad.append(f"masks vs CPU {mask_err} > 1e-4")
    if wave_err > 1e-3 * peak:
        bad.append(f"waveforms vs CPU {wave_err} > 1e-3 * {peak}")
    if bad:
        raise AssertionError("; ".join(bad))
    audio_s = n_req * cfg.data.duration
    return {"config": "scaled", "card": state["card"], "requests": n_req,
            "client_threads": n_threads, "batches": batches,
            "max_batch": stats["max_batch"],
            "mean_batch": stats["mean_batch"], "launches": launches,
            "latency_ms_p50": stats["latency_ms_p50"],
            "latency_ms_p95": stats["latency_ms_p95"],
            "latency_ms_all": [round(x, 2) for x in latencies],
            "wall_s": wall, "audio_s_per_s": audio_s / wall,
            "cpu_check": {"requests": n_ref, "mask_max_abs_err": mask_err,
                          "wave_max_abs_err": wave_err, "wave_peak": peak}}


def phase_profile(state):
    """Where the time of one served batch goes: a batch of 8 waveform
    requests through the serve phase's Separator, timed (host clock around
    synchronised calls) and then traced with torch.profiler; device time is
    summed per kernel name from the CUDA kernel events."""
    from torch.profiler import ProfilerActivity, profile

    sep, audio, frames = state["serve_batch"]
    iters = 5
    sep.separate_waveform(audio, frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        sep.separate_waveform(audio, frames)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / iters * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            sep.separate_waveform(audio, frames)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / iters * 1e3
    return {"config": "scaled", "batch": int(audio.shape[0]),
            "card": state["card"], "batch_ms": batch_ms,
            "traced_batch_ms": traced_ms,
            **device_split(prof, iters, traced_ms, "batch")}


def _group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attn_fwd (ours)"
    if "dkv_kernel" in low or "dq_kernel" in low or "delta_kernel" in low:
        return "flash_attn_bwd (ours)"
    if "audio_proj" in low:
        return "audio_proj_fwd (ours)"
    if "mask_decoder" in low:
        return "mask_decoder_fwd (ours)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    if "fprop" in low or "grad" in low or "conv" in low or "cudnn" in low:
        return "conv stem (cuDNN)"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "norm" in low:
        return "layer norm"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach Adam)"
    return "other (elementwise, reductions, index_add)"


def device_split(prof, iters: int, traced_ms: float, unit: str) -> dict:
    """Device time per `unit` from a torch.profiler trace: summed per kernel
    name and per group, and its share of the host-clock time."""
    from torch.autograd import DeviceType

    by_name, launches = {}, 0
    for e in prof.events():
        # Kernels and copies only: a user annotation (such as
        # Optimizer.step) spans kernels that are already counted.
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / iters
            launches += 1
    if not by_name:
        return {f"device_ms_per_{unit}": "not measured",
                "device_busy_share": "not measured"}
    device_ms = sum(by_name.values())
    groups = {}
    for name, ms in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {f"device_ms_per_{unit}": device_ms,
            "device_busy_share": device_ms / traced_ms,
            f"kernels_per_{unit}": launches / iters,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[name[:90], ms] for name, ms in top]}


def _scaled_train_setup(dropout: float, n_samples: int, batch: int):
    """The scaled config at `dropout` and its first `batch_iterator` batches
    over a cut of the synthetic dataset (`n_samples` of its 1000; widths,
    depths and the data geometry are the config's)."""
    import dataclasses

    from av_separation_torch.config import get_config
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset

    cfg = get_config("scaled")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=dropout),
        data=dataclasses.replace(cfg.data, num_samples=n_samples),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    return cfg, batch_iterator(SyntheticAVDataset(cfg.data), batch, seed=0)


def phase_train(state):
    from av_separation_torch.ops import kernels
    from av_separation_torch.train import create_train_state, make_train_step

    cfg, batches = _scaled_train_setup(0.1, 24, 8)
    m = cfg.model
    if (m.d_model, m.nhead, m.num_encoder_layers, m.num_fusion_layers) \
            != (512, 4, 6, 4):
        raise AssertionError(f"not the scaled config: {m}")
    ts = create_train_state(cfg, device="cuda")
    step = make_train_step(cfg)
    per_step = 2 * m.num_encoder_layers + m.num_fusion_layers
    want = {"flash_attn_fwd": per_step, "flash_attn_bwd": per_step,
            "audio_proj_fwd": 1, "mask_decoder_fwd": 0}
    n_steps, rows, bad = 6, [], []
    total = {name: 0 for name in kernels.LAUNCHES}
    for i in range(n_steps):
        batch = next(batches)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ts, metrics = step(ts, batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            total[name] += n
        rows.append({"step": i, "loss": loss, "grad_norm": norm, "ms": ms,
                     "launches": launches})
        if not (np.isfinite(loss) and np.isfinite(norm)):
            bad.append(f"step {i}: loss {loss}, grad norm {norm}")
        if launches != want:
            bad.append(f"step {i}: launches {launches} != {want}")
    state["launches"]["train"] = total
    state["train"] = (cfg, ts, step, batch)
    # Step 0 pays cuBLAS / cuDNN set-up; the rate is over the others.
    step_ms = float(np.mean([r["ms"] for r in rows[1:]]))
    audio_s = cfg.train.batch_size * cfg.data.duration

    check = _train_cpu_check(bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return {"config": "scaled", "card": state["card"],
            "batch": cfg.train.batch_size, "dropout": m.dropout,
            "steps": rows, "ms_per_step": step_ms,
            "audio_s_per_s": audio_s / step_ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cpu_check_dropout0_batch2": check}


def _train_cpu_check(bad: list) -> dict:
    """One step of the scaled config at dropout 0 and batch 2 through
    make_train_step on the card, against the same weights and batch on the
    CPU in float64 (forward, loss, backward, the same clip).

    Float64 is the reference because the CPU's own float32 run can be the
    noisier side (its float32 loss reductions over 257k elements); its
    errors against float64 are reported beside the card's.  Tolerances:
    the loss (SI-SNR in dB plus L1) to 1e-3, the global norm to 1e-4
    relative, every clipped gradient element to 1e-3 of the largest."""
    from av_separation_torch.losses import separation_loss
    from av_separation_torch.train import create_train_state, make_train_step

    cfg0, batches0 = _scaled_train_setup(0.0, 8, 2)
    batch0 = next(batches0)
    ref = create_train_state(cfg0, device="cpu").model.double()
    mixed, frames, clean = (torch.as_tensor(batch0[k], dtype=torch.float64)
                            for k in ("mixed_spec", "lip_frames",
                                      "clean_specs"))
    lc = cfg0.loss
    loss_ref = separation_loss(ref(mixed, frames)[0], clean, lc.l1_weight,
                               lc.pit_mode, lc.eps)
    loss_ref.backward()
    g_ref = {n: p.grad for n, p in ref.named_parameters()}
    n_ref = float(torch.sqrt(sum(g.square().sum() for g in g_ref.values())))
    clip = min(1.0, cfg0.train.grad_clip_norm / n_ref)

    g_max = max(float(g.abs().max()) for g in g_ref.values()) * clip
    runs = {}
    for device in ("cuda", "cpu"):
        s0 = create_train_state(cfg0, device=device)
        s0, met = make_train_step(cfg0)(s0, batch0)
        runs[device] = (float(met["loss"]), float(met["grad_norm"]), max(
            float((p.grad.double().cpu() - g_ref[n] * clip).abs().max())
            for n, p in s0.model.named_parameters()))
    (l_g, n_g, g_err), (l_c, n_c, g_err_c) = runs["cuda"], runs["cpu"]
    l_r = float(loss_ref.detach())
    if abs(l_g - l_r) > 1e-3:
        bad.append(f"loss card {l_g} vs CPU float64 {l_r}")
    if abs(n_g - n_ref) > 1e-4 * n_ref:
        bad.append(f"grad norm card {n_g} vs CPU float64 {n_ref}")
    if g_err > 1e-3 * g_max:
        bad.append(f"gradients card vs CPU float64 {g_err} > 1e-3 * {g_max}")
    return {"reference": "CPU float64", "loss": [l_g, l_r, 1e-3],
            "grad_norm": [n_g, n_ref, 1e-4 * n_ref],
            "max_grad_err": [g_err, g_max, 1e-3 * g_max],
            "cpu_float32": {"loss": l_c, "grad_norm": n_c,
                            "max_grad_err": g_err_c}}


def phase_train_profile(state):
    """Where the time of one scaled train step goes: host-clock step time,
    then a torch.profiler trace of two steps summed per kernel and group."""
    from torch.profiler import ProfilerActivity, profile

    cfg, ts, step, batch = state["train"]
    iters = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            ts, metrics = step(ts, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / iters * 1e3
    return {"config": "scaled", "batch": cfg.train.batch_size,
            "card": state["card"], "traced_step_ms": traced_ms,
            **device_split(prof, iters, traced_ms, "step")}


def phase_demo(state):
    from av_separation_torch import demo
    from av_separation_torch.ops import kernels

    lines = []
    kernels.reset_launch_counts()
    out = demo.run(device="cuda", log=lines.append)
    launches = dict(kernels.LAUNCHES)
    print("\n".join(lines), file=sys.stderr, flush=True)
    state["launches"]["demo"] = launches
    if not out["passed"]:
        raise AssertionError(f"demo gate failed: {out}")
    if not all(launches[n] > 0 for n in ("flash_attn_fwd", "flash_attn_bwd",
                                         "audio_proj_fwd")):
        raise AssertionError(f"demo launches {launches}")
    return {"config": "demo", "card": state["card"], **out,
            "gate_db": demo.PASS_DB, "launches": launches}


def kernel_summary(state):
    """One entry per kernel: errors are the worst over the shapes checked;
    times and the bound are those of the first scaled shape at the rate of
    the kernel's main path (serving at dropout 0, the backward at the
    training rate 0.1); launches are summed over the serve, train and demo
    runs, each counted from 0."""
    rows = state.get("kernel_rows", {})
    by_path = state.get("launches", {})
    out = []
    for name, meta in KERNELS.items():
        mine = rows.get(name, [])
        rate = meta.get("head_rate", 0.0)
        head = next((r for r in mine if r.get("dropout", 0.0) == rate),
                    mine[0] if mine else {})
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "also_replaces": meta["also_replaces"],
            "launches": sum(p.get(name, 0) for p in by_path.values()),
            "launches_by_path": {path: p.get(name, 0)
                                 for path, p in by_path.items()},
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "shape": head.get("shape"),
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "av_separation_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    state = {"launches": {}}
    failed = []
    for name, phase in (("env", phase_env), ("build", phase_build),
                        ("kernels", phase_kernels), ("golden", phase_golden),
                        ("serve", phase_serve), ("profile", phase_profile),
                        ("train", phase_train),
                        ("train_profile", phase_train_profile),
                        ("demo", phase_demo)):
        t0 = time.perf_counter()
        try:
            info = phase(state)
            emit({"phase": name, "ok": True,
                  "s": round(time.perf_counter() - t0, 2), **info})
        except Exception as e:  # noqa: BLE001 — recorded, fails the run
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(e)[:2000]})
    emit(kernel_summary(state))
    print(card_line(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
