#!/usr/bin/env python3
"""The PyTorch port's audio-projection kernels alone on one NVIDIA GPU.

    python3 tools/torch_proj_rows.py [--root DIR] [--timed] [--dtype f32|bf16]

Builds the projection's sources (`audio_proj*.cu` of the checkout) with
`nvcc -Xptxas -v` and prints one JSON line per kernel instance
(registers, spill bytes), then one JSON line per case: the kernel of the
checkout at DIR (this one by default) against its plain version (float32:
1e-4 on y and h; bf16: 2 bf16 ulps at the peak, the float32 h that conv1
writes for conv2 within 1e-4, and the weight split bit for bit), and at
the timed cases (the only ones with --timed: compare two checkouts in
turns, A B B A) its device time, each device kernel's (the split, conv1,
conv2) and cuDNN's two conv1d in the same dtype.  Each case runs in a child process, so a kernel that faults or
hangs costs that case alone (150 s).

Device times come from `chip_smoke.device_ms` (torch.profiler kernel
durations).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# (label, B, T, D, dtype, timed)
CASES = [
    ("small", 1, 5, 64, "bf16", False),
    ("ragged", 3, 130, 200, "bf16", False),
    ("scaled", 8, 501, 512, "bf16", True),
    ("bench demo", 128, 63, 128, "bf16", True),
    ("three_speaker", 8, 63, 512, "bf16", True),
    ("multihost", 16, 501, 1024, "bf16", True),
    ("wide", 2, 501, 1536, "bf16", False),
    ("grid cap", 65536, 8, 64, "bf16", False),
    ("scaled", 8, 501, 512, "f32", True),
    ("demo", 4, 63, 128, "f32", True),
    ("three_speaker", 8, 63, 512, "f32", True),
    ("multihost", 16, 501, 1024, "f32", True),
    ("odd width", 2, 501, 196, "f32", True),
    ("wide", 2, 501, 1536, "f32", True),
    ("small", 1, 5, 64, "f32", False),
    ("ragged", 3, 130, 200, "f32", False),
    ("grid cap", 65536, 8, 64, "f32", True),
]


def instances(log: str):
    """(kernel<template args>, registers, spill store bytes) per entry."""
    name, spill = None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"\d(audio_proj\w*?kernel)(?:I(\w*?)EE)?",
                          m.group(1))
            name = (k.group(1) + "<" + ",".join(re.findall(
                r"L[a-z](\d+)E", (k.group(2) or "") + "E")) + ">") if k \
                else m.group(1)
        elif name and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln:
            yield name, int(re.search(r"Used (\d+)", ln).group(1)), spill
            name = None


def build():
    from av_separation_torch.ops.kernels import _build
    have = [n for n in _build.SOURCES if n.startswith("audio_proj")]
    for src, log in _build.build(have, ptxas_verbose=True).items():
        for name, regs, spill in instances(log):
            print(json.dumps({"source": src, "instance": name,
                              "registers": regs, "spill_bytes": spill}),
                  flush=True)
        if "warning" in log.lower():
            print(json.dumps({"source": src, "warnings": [
                ln for ln in log.splitlines() if "warning" in ln.lower()]}),
                flush=True)


def case(args):
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from av_separation_torch.ops.kernels import audio_proj as P

    label, b, t, d, dt, timed = args
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    f = 257
    x = torch.randn(b, t, f, generator=gen).abs().to(dtype).cuda()
    lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
    w1 = ((torch.rand(3, f, d, generator=gen) * 2 - 1) * lim1).cuda()
    b1 = ((torch.rand(d, generator=gen) * 2 - 1) * lim1).cuda()
    w2 = ((torch.rand(3, d, d, generator=gen) * 2 - 1) * lim2).cuda()
    b2 = ((torch.rand(d, generator=gen) * 2 - 1) * lim2).cuda()
    # The model's rows (a checkout without `proj_input` takes x as is).
    pad = getattr(P, "proj_input", None)
    xk = pad(x.transpose(1, 2)) if pad else x
    y, h = P.audio_proj_fwd(xk, w1, b1, w2, b2)
    yp, hp = P.audio_proj_fwd_torch(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    tol = c.bf16_tol if dt == "bf16" else (lambda ref: 1e-4)
    out = {"case": list(args), "y_err": c.max_err(y, yp), "y_tol": tol(yp),
           "h_err": c.max_err(h, hp), "h_tol": tol(hp)}
    out["ok"] = out["y_err"] <= out["y_tol"] and out["h_err"] <= out["h_tol"]
    if dt == "bf16" and "keep_h32" in inspect.signature(
            P._launch).parameters and d % 8 == 0:
        h32 = P._launch(xk, w1, b1, w2, b2, keep_h32=True)[2]
        out["h32_err"] = c.max_err(
            h32, P.audio_proj_fwd_torch(x.float(), w1, b1, w2, b2)[1])
        out["ok"] = out["ok"] and out["h32_err"] <= 1e-4
    if hasattr(P, "audio_proj_split") and (dt == "bf16" or "dtype" in
                                           inspect.signature(
                                               P.audio_proj_split).parameters):
        parts = P.audio_proj_split(w1, w2)
        out["split_err"] = max(c.max_err(a, P.weight_parts_torch(w))
                               for a, w in zip(parts, (w1, w2)))
        out["ok"] = out["ok"] and out["split_err"] == 0.0
    if timed:
        fn = lambda: P.audio_proj_fwd(xk, w1, b1, w2, b2)
        names = c.KERNEL_NAMES.get("audio_proj_fwd" + (
            "[bf16]" if dt == "bf16" else "")) or c.KERNEL_NAMES[
                "audio_proj_fwd"]
        out["device_ms"] = c.device_ms(fn, 20, names)
        for name in names:
            out[name + "_device_ms"] = c.device_ms(fn, 20, (name,))
        c1, c2 = (w.permute(2, 1, 0).contiguous().to(dtype) for w in (w1, w2))
        lb1, lb2 = b1.to(dtype), b2.to(dtype)
        x_bft = x.transpose(1, 2).contiguous()
        out["cudnn_device_ms"] = c.device_ms(
            lambda: torch.relu(F.conv1d(torch.relu(F.conv1d(
                x_bft, c1, lb1, padding=1)), c2, lb2, padding=1)), 20)
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--timed", action="store_true",
                        help="only the cases that are timed")
    parser.add_argument("--dtype", choices=("f32", "bf16"),
                        help="only the cases at this dtype of x")
    parser.add_argument("--case", help=argparse.SUPPRESS)
    args = parser.parse_args()
    args.root = str(Path(args.root).resolve())
    sys.path.insert(0, args.root)
    os.chdir(args.root)
    if args.case:
        case(json.loads(args.case))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_proj_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    build()
    bad = 0
    for cs in CASES:
        if (args.timed and not cs[5]) or args.dtype not in (None, cs[4]):
            continue
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--root", args.root, "--case",
                 json.dumps(cs)], capture_output=True, text=True,
                timeout=150)
            print(r.stdout.strip() or json.dumps({"case": cs}), flush=True)
            bad += r.returncode != 0 or '"ok": true' not in r.stdout
            if r.returncode:
                print(r.stderr[-1500:], file=sys.stderr, flush=True)
        except subprocess.TimeoutExpired:
            bad += 1
            print(json.dumps({"case": cs, "timeout_s": 150}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
