#!/usr/bin/env python3
"""The PyTorch port's flash-attention kernels alone on one NVIDIA GPU.

    python3 tools/torch_flash_rows.py [--root DIR] [--timed]

Builds the two flash sources of each dtype route with `nvcc -Xptxas -v`
and prints one JSON line per kernel instance (registers, spill bytes),
then one JSON line per case: the forward and backward of the checkout at
DIR (this one by default) against their plain versions (bf16: 2 bf16 ulps
at the peak; float32: 3e-5; lse 1e-4; the backward run twice and
bit-identical), and at the timed cases (the only ones with --timed:
compare two checkouts in turns, A B B A) the device time of the forward
and of each backward kernel (delta, dK/dV, dQ) beside SDPA's (forward,
and forward + backward).  Each case runs in a child process, so a kernel
that faults or hangs costs that case alone (150 s).

Device times come from `chip_smoke.device_ms` (torch.profiler kernel
durations).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

# (B, H, Tq, Tk, dh, layout, dropout, timed, dtype)
CASES = [
    (4, 4, 63, 50, 32, "split", 0.1, False, "bf16"),
    (2, 2, 77, 150, 256, "cross", 0.1, False, "bf16"),
    (2, 2, 100, 90, 320, "self", 0.1, False, "bf16"),
    (2, 2, 100, 90, 320, "self", 0.1, False, "f32"),
    (8, 4, 501, 501, 128, "self", 0.0, True, "bf16"),
    (8, 4, 501, 501, 128, "self", 0.1, True, "bf16"),
    (8, 4, 501, 501, 64, "self", 0.1, True, "bf16"),
    (2, 4, 1024, 1024, 128, "self", 0.1, True, "bf16"),
    (8, 2, 501, 501, 256, "self", 0.1, True, "bf16"),
    (8, 4, 501, 501, 128, "self", 0.1, True, "f32"),
    (8, 2, 501, 501, 512, "self", 0.0, True, "bf16"),
    (128, 4, 63, 63, 32, "self", 0.0, True, "bf16"),
    (128, 4, 63, 50, 32, "cross", 0.1, True, "bf16"),
    # B*H 65,536: grid x folds the tile and B*H
    (16384, 4, 16, 16, 32, "self", 0.1, False, "f32"),
    (16384, 4, 16, 16, 32, "self", 0.1, False, "bf16"),
    (16384, 4, 16, 16, 128, "self", 0.0, False, "bf16"),
]
SOURCES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_attn_fwd",
           "flash_attn_bwd")


def instances(log: str):
    """(kernel<template ints>, registers, spill store bytes) per entry."""
    name, spill = None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"\d(flash_\w+?kernel\w*?)I(.*?)EEv", m.group(1))
            name = (k.group(1) + "<" + ",".join(
                re.findall(r"Li(\d+)E", k.group(2) + "E")) + ">") if k \
                else m.group(1)
        elif name and "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif name and "Used" in ln:
            yield name, int(re.search(r"Used (\d+)", ln).group(1)), spill
            name = None


def build():
    from av_separation_torch.ops.kernels import _build
    for src, log in _build.build(SOURCES, ptxas_verbose=True).items():
        for name, regs, spill in instances(log):
            print(json.dumps({"source": src, "instance": name,
                              "registers": regs, "spill_bytes": spill}),
                  flush=True)


def case(args):
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from av_separation_torch.ops.kernels import attention as A

    b, h, tq, tk, dh, kind, rate, timed, dt = args
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    q, k, v = c._attn_inputs(b, h, tq, tk, dh, kind, gen, dtype)
    seed = c.ATTN_SEED
    o, lse = A.flash_attn_fwd(q, k, v, rate, seed)
    op, lp = A.flash_attn_fwd_torch(q, k, v, rate, seed)
    tol = c.bf16_tol if dt == "bf16" else (lambda ref: 3e-5)
    do = torch.randn(op.shape, generator=gen).to(dtype).cuda()
    g = A.flash_attn_bwd(q, k, v, o, do, lse, rate, seed)
    g2 = A.flash_attn_bwd(q, k, v, o, do, lse, rate, seed)
    gp = A.flash_attn_bwd_torch(q, k, v, op, do, lp, rate, seed)
    torch.cuda.synchronize()
    out = {"case": list(args), "o_err": c.max_err(o, op), "o_tol": tol(op),
           "lse_err": c.max_err(lse, lp),
           "grad_errs": [c.max_err(x, y) for x, y in zip(g, gp)],
           "grad_tols": [tol(y) for y in gp],
           "bit_identical": all(torch.equal(x, y) for x, y in zip(g, g2))}
    out["ok"] = out["o_err"] <= out["o_tol"] and out["lse_err"] <= 1e-4 \
        and all(e <= t for e, t in zip(out["grad_errs"], out["grad_tols"])) \
        and out["bit_identical"]
    if timed:
        fwd = lambda: A.flash_attn_fwd(q, k, v, rate, seed)
        bwd = lambda: A.flash_attn_bwd(q, k, v, o, do, lse, rate, seed)
        out["fwd_device_ms"] = c.device_ms(fwd, 20, ("flash_fwd",))
        for name in ("flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"):
            out[name + "_device_ms"] = c.device_ms(bwd, 10, (name,))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
            torch.autograd.grad(y, (qg, kg, vg), do)

        out["sdpa_fwd_device_ms"] = c.device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate),
            20)
        out["sdpa_fwd_bwd_device_ms"] = c.device_ms(sdpa_fwd_bwd, 10)
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--timed", action="store_true",
                        help="only the cases that are timed")
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
        print("torch_flash_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    build()
    bad = 0
    for cs in CASES:
        if args.timed and not cs[7]:
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
