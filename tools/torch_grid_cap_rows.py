#!/usr/bin/env python3
"""Device times of the port's grid-cap rows, one trace at a time.

    python3 tools/torch_grid_cap_rows.py [--iters N]

The `kernels` phase of chip_smoke.py holds flash attention at B*H 65,536
(B 16,384, H 4, T 16: dh 32 in float32 and bf16, dh 128 in bf16; dropout
0 and 0.1) and the audio projection at B 65,536 (T 8, D 64, float32 and
bf16) against their plain versions, but its profiler traces of these
~1 GB calls come back short of events.  This script takes each
measurement in a process of its own, each trace over `--iters` calls
(default 3) through chip_smoke.device_ms: the kernel's own device kernels
per call (the flash forward; the backward's delta, dK/dV and dQ kernels;
the projection's split and two convs) and every device kernel of the
library call (SDPA forward, and forward + backward; cuDNN conv1d in
float32, and in bf16 for a bf16 x).  A trace short of events is taken
again, up to three times, then printed as not measured.  Needs a CUDA
device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# ("flash", dtype, dh, dropout) and ("proj", dtype)
CASES = [("flash", dt, dh, rate) for dt, dh in (("f32", 32), ("bf16", 32),
                                                ("bf16", 128))
         for rate in (0.0, 0.1)] + [("proj", "f32"), ("proj", "bf16")]


def case(spec, iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as c

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    traced = lambda fn, names=None: c.device_ms(fn, iters, names)
    out = {"case": spec}
    if spec[0] == "flash":
        from av_separation_torch.ops.kernels import attention as A
        _, dt, dh, rate = spec
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = c._attn_inputs(16384, 4, 16, 16, dh, "self", gen, dtype)
        seed = c.ATTN_SEED
        o, lse = A.flash_attn_fwd(q, k, v, rate, seed)
        do = torch.randn(o.shape, generator=gen).to(dtype).cuda()
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate)
            torch.autograd.grad(y, (qg, kg, vg), do)

        out["fwd"] = traced(lambda: A.flash_attn_fwd(q, k, v, rate, seed),
                            c.KERNEL_NAMES["flash_attn_fwd"])
        out["bwd"] = traced(
            lambda: A.flash_attn_bwd(q, k, v, o, do, lse, rate, seed),
            c.KERNEL_NAMES["flash_attn_bwd"])
        out["sdpa_fwd"] = traced(
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate))
        out["sdpa_fwd_bwd"] = traced(sdpa_fwd_bwd)
    else:
        from av_separation_torch.ops.kernels.audio_proj import (
            audio_proj_fwd, proj_input)
        dt = spec[1]
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        b, t, f, d = 65536, 8, 257, 64
        x = torch.randn(b, t, f, generator=gen).abs().to(dtype).cuda()
        xk = proj_input(x.transpose(1, 2))
        lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
        w1 = ((torch.rand(3, f, d, generator=gen) * 2 - 1) * lim1).cuda()
        b1 = ((torch.rand(d, generator=gen) * 2 - 1) * lim1).cuda()
        w2 = ((torch.rand(3, d, d, generator=gen) * 2 - 1) * lim2).cuda()
        b2 = ((torch.rand(d, generator=gen) * 2 - 1) * lim2).cuda()
        x_bft = x.transpose(1, 2).contiguous()
        c1, c2 = (w.permute(2, 1, 0).contiguous() for w in (w1, w2))
        name = "audio_proj_fwd" + ("[bf16]" if dt == "bf16" else "")
        out["kernel"] = traced(lambda: audio_proj_fwd(xk, w1, b1, w2, b2),
                               c.KERNEL_NAMES[name])
        out["cudnn_float32"] = traced(lambda: torch.relu(F.conv1d(
            torch.relu(F.conv1d(x_bft.float(), c1, b1, padding=1)), c2, b2,
            padding=1)).to(dtype))
        if dt == "bf16":
            lb = [w.to(dtype) for w in (c1, b1, c2, b2)]
            out["cudnn_bf16"] = traced(lambda: torch.relu(F.conv1d(
                torch.relu(F.conv1d(x_bft, lb[0], lb[1], padding=1)), lb[2],
                lb[3], padding=1)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--case", help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    if args.case:
        print(json.dumps(case(json.loads(args.case), args.iters)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_grid_cap_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    from av_separation_torch.ops.kernels import _build
    _build.build()
    bad = 0
    for spec in CASES:
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--iters", str(args.iters),
                 "--case", json.dumps(spec)], capture_output=True,
                text=True, timeout=300)
            print(r.stdout.strip() or json.dumps({"case": spec}), flush=True)
            if r.returncode:
                bad += 1
                print(r.stderr[-1500:], file=sys.stderr, flush=True)
        except subprocess.TimeoutExpired:
            bad += 1
            print(json.dumps({"case": spec, "timeout_s": 300}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
