#!/usr/bin/env python3
"""The PyTorch port's flash-attention kernels alone on one NVIDIA GPU.

    python3 tools/torch_flash_rows.py [--root DIR] [--timed]
    python3 tools/torch_flash_rows.py --source FILE [--source FILE ...]
        [--probe no_sum|no_exchange ...] [--rows all|wide]

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

With --source (other versions of `flash_attn_fwd.cu`, `flash_attn_bwd.cu`
or `flash_fwd_wgmma.cu`, e.g. the parent's from `git show
HEAD~1:av_separation_torch/csrc/flash_attn_fwd.cu` written under
`build/`): each is built beside this checkout's libraries (against this
checkout's headers) and the rows of VARIANT_ROWS run through this
checkout's route and through the variant's entry points, in turns (this,
variant, variant, this), in one process: the device time of each (all
its flash kernels a call), the largest difference of their outputs, and
SDPA's device time beside each row.  Where the variant has no source
for a row's route, this checkout's library runs it.  Sources are grouped
by directory, one variant a directory.  --probe adds variants of this
checkout's cluster kernels that time the cross-block exchange above dh
256 (and of its float32 pair kernels at dh 256, the exchange between two
warps of a block), their results wrong by design: `no_sum` drops the
sums of the partials (each block or warp keeps its own: no loads from
other blocks or the partner warp), `no_exchange` also the cluster (pair)
barriers of the tile loop and the partials' stores; the exchange's share
of a row is its time less theirs.  --rows wide keeps the rows above dh
256, --rows pair the float32 ones at (padded) dh 256.

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
    # above dh 256: clusters of 3, 4, 9 (non-portable) and 16 blocks
    (2, 2, 100, 90, 320, "self", 0.0, False, "f32"),
    (2, 2, 100, 90, 320, "self", 0.0, False, "bf16"),
    (2, 1, 77, 150, 1152, "cross", 0.1, False, "f32"),
    (2, 1, 77, 150, 1152, "cross", 0.1, False, "bf16"),
    (1, 2, 70, 65, 2048, "cross", 0.1, False, "f32"),
    (1, 2, 70, 65, 2048, "cross", 0.1, False, "bf16"),
    # above dh 2048 blocks own several chunks: 17 on 9 blocks (the last
    # owns one), 33 on 11 (three each)
    (1, 2, 70, 65, 2176, "cross", 0.1, False, "f32"),
    (1, 2, 70, 65, 2176, "cross", 0.1, False, "bf16"),
    (1, 1, 77, 90, 4224, "self", 0.0, False, "f32"),
    (1, 1, 77, 90, 4224, "self", 0.1, False, "bf16"),
    (8, 2, 501, 501, 512, "self", 0.1, True, "f32"),
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
    # dh 129-256 in float32: the 8-warp pair kernels, at 256 and padded
    (8, 2, 501, 501, 256, "self", 0.0, True, "f32"),
    (8, 2, 501, 501, 256, "self", 0.1, True, "f32"),
    (8, 2, 501, 501, 200, "self", 0.1, False, "f32"),
    (2, 2, 77, 150, 200, "cross", 0.0, False, "f32"),
]
SOURCES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_attn_fwd",
           "flash_attn_bwd")


def instances(log: str):
    """(kernel<template args>, registers, spill store bytes) per entry."""
    name, spill = None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"\d(flash_\w+?kernel\w*?)(?:I(.*?)EEv|E)",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|^(f)",
                              k.group(2) or "") if k else []
            name = (k.group(1) + ("<" + ",".join(
                a or ("bf16" if b else "float") for a, b, _ in args)
                + ">" if args else "")) if k else m.group(1)
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


# (label, B, H, T, dh, dtype, pass): the wide rows of PERF.md's kernel
# table (dh 320 runs at 384), the float32 rows at dh 256 and 200 (padded
# to 256: the pair kernels) and rows up to dh 128 and in bf16; each at
# dropout 0 and 0.1.
VARIANT_ROWS = [(f"dh{dh} {dt} {ps}", 8, 2, 501, dh, dt, ps)
                for dh in (512, 320) for dt in ("f32", "bf16")
                for ps in ("fwd", "bwd")] + [
    ("audio self dh128 f32 fwd", 8, 4, 501, 128, "f32", "fwd"),
    ("audio self dh128 f32 bwd", 8, 4, 501, 128, "f32", "bwd"),
    ("self dh64 f32 bwd", 8, 4, 501, 64, "f32", "bwd"),
    ("dh256 f32 fwd", 8, 2, 501, 256, "f32", "fwd"),
    ("dh256 f32 bwd", 8, 2, 501, 256, "f32", "bwd"),
    ("dh200 f32 fwd", 8, 2, 501, 200, "f32", "fwd"),
    ("dh200 f32 bwd", 8, 2, 501, 200, "f32", "bwd"),
    ("audio self dh128 bf16 fwd", 8, 4, 501, 128, "bf16", "fwd"),
    ("dh256 bf16 fwd", 8, 2, 501, 256, "bf16", "fwd")]


PROBES = {
    # Each block (each warp of a dh-256 pair) keeps its own partial: no
    # partial or sum read from another block (or the partner warp).
    "no_sum": [r"\n *cluster_sum<[^;]*;", r"\n *(?:if \([^)]*\)\n *)?"
               r"(?:reduce|gather)_slots<[^;]*;", r"\n *pair_sum<[^;]*;"],
    # ... and no cluster (pair) barrier in the tile loop, no partial
    # stored.
    "no_exchange": [r"\n *cluster_sum<[^;]*;", r"\n *(?:if \([^)]*\)\n *)?"
                    r"(?:reduce|gather)_slots<[^;]*;",
                    r"\n *cluster_sync\(\);(?=\n *(?://[^\n]*\n *)*"
                    r"(?:if|//|$))", r"\n *put_partials<[^;]*;",
                    r"\n *pair_sum<[^;]*;", r"\n *pair_sync\([^;]*;"],
}
PROBED = ("flash_attn_fwd", "flash_fwd_wgmma", "flash_attn_bwd")


def _probe_sources(names):
    """This checkout's cluster sources with the exchange cut out (PROBES),
    written under build/probe_<name>/."""
    from av_separation_torch.ops.kernels import _build
    out = []
    for name in names:
        cut = {}
        folder = _build.BUILD_DIR.parent / f"probe_{name}"
        folder.mkdir(parents=True, exist_ok=True)
        for stem in PROBED:
            text = (_build.CSRC_DIR / f"{stem}.cu").read_text()
            for pattern in PROBES[name]:
                text, n = re.subn(pattern, "", text)
                cut[pattern] = cut.get(pattern, 0) + n
            (folder / f"{stem}.cu").write_text(text)
            out.append(folder / f"{stem}.cu")
        if not all(cut.values()):
            raise SystemExit(f"probe {name}: a pattern cut nothing {cut}")
    return out


def _variant_libs(sources):
    """{variant (the source's directory): {stem: (lib, fn, takes_dtype,
    takes_scratch)}}, each source built alike, against this checkout's
    headers.  A version from before the cluster kernels' scratch buffer
    (no `*_scratch` export) takes no scratch pointer."""
    import ctypes

    from av_separation_torch.ops.kernels import _build
    from av_separation_torch.ops.kernels import attention as A
    mine = {"flash_attn_fwd": (A._fwd_entry()[1], True),
            "flash_fwd_wgmma": (A._wgmma_fwd_entry()[1], False),
            "flash_attn_bwd": (A._bwd_entry()[1], True),
            "flash_bwd_wgmma": (A._wgmma_bwd_entry()[1], False)}
    scratch = {"flash_attn_fwd": "avsep_flash_attn_fwd_scratch",
               "flash_fwd_wgmma": "avsep_flash_fwd_wgmma_scratch",
               "flash_attn_bwd": "avsep_flash_attn_bwd_scratch"}
    symbols = {"flash_attn_fwd": "avsep_flash_attn_fwd",
               "flash_fwd_wgmma": "avsep_flash_fwd_wgmma",
               "flash_attn_bwd": "avsep_flash_attn_bwd",
               "flash_bwd_wgmma": "avsep_flash_bwd_wgmma"}
    libs = {"this": {stem: (None, fn, takes, stem in scratch)
                     for stem, (fn, takes) in mine.items()}}
    for src in sources:
        if src.stem not in mine:
            raise SystemExit(f"no flash entry point in {src.name}")
        name = src.parent.name
        target = _build.BUILD_DIR / f"variant_{name}_{src.stem}.so"
        target.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC_DIR), "-o", str(target), str(src)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(target))
        lib.avsep_error_string.argtypes = [ctypes.c_int]
        lib.avsep_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, symbols[src.stem])
        takes_scratch = hasattr(lib, scratch.get(src.stem, "-"))
        argtypes = mine[src.stem][0].argtypes
        fn.argtypes = argtypes if takes_scratch or src.stem not in scratch \
            else argtypes[:-1]
        fn.restype = ctypes.c_int
        libs.setdefault(name, dict(libs["this"]))[src.stem] = \
            (lib, fn, mine[src.stem][1], takes_scratch)
    return libs


def variants(sources, rows="all") -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from av_separation_torch.ops import kernels
    from av_separation_torch.ops.kernels import _build
    from av_separation_torch.ops.kernels import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _variant_libs(sources)
    names = list(libs)
    gen = torch.Generator().manual_seed(0)
    seed = c.ATTN_SEED

    def stem(name, dtype, dh, ps):
        # The routes of every version: bf16 up to 256 on the wgmma sources,
        # the bf16 forward above 256 on flash_fwd_wgmma.cu where it has the
        # cluster kernel (else on flash_attn_fwd.cu, as the parent), every
        # other call on flash_attn_fwd.cu / flash_attn_bwd.cu.
        if A.wgmma_route(dtype, dh):
            return "flash_fwd_wgmma" if ps == "fwd" else "flash_bwd_wgmma"
        lib = libs[name]["flash_fwd_wgmma"][0]
        if ps == "fwd" and dtype == torch.bfloat16 and (
                lib is None or hasattr(lib, "avsep_flash_fwd_wgmma_cluster_smem")):
            return "flash_fwd_wgmma"
        return "flash_attn_fwd" if ps == "fwd" else "flash_attn_bwd"

    def launch(ent, call, dtype, dev):
        # outs: the outputs, then the scratch buffer (held to the launch)
        lib, fn, takes_dtype, takes_scratch = ent
        *outs, args = call
        extra = (kernels.DTYPE_CODES[dtype],) if takes_dtype else ()
        ptr = (A._ptr(outs[-1]),) if takes_scratch else ()
        rc = fn(*args, *extra, dev,
                torch.cuda.current_stream().cuda_stream, *ptr)
        if lib is not None:
            _build.check(lib, rc, "variant")
        elif rc:
            raise RuntimeError(f"CUDA error {rc}")
        return outs

    bad = 0
    for label, b, h, t, dh, dt, ps in VARIANT_ROWS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        width = A.padded_head_dim(dh)
        if rows == "wide" and width <= 256 or rows == "pair" and (
                width != 256 or dt != "f32"):
            continue
        q, k, v = c._attn_inputs(b, h, t, t, dh, "self", gen, dtype)
        do = torch.randn(q.shape, generator=gen).to(dtype).cuda()
        for rate in (0.0, 0.1):
            o, lse = A.flash_attn_fwd(q, k, v, rate, seed)
            runs = {"this": (lambda: A.flash_attn_fwd(q, k, v, rate, seed))
                    if ps == "fwd" else
                    (lambda: A.flash_attn_bwd(q, k, v, o, do, lse, rate,
                                              seed))}
            for name in names[1:]:
                ent = libs[name][stem(name, dtype, width, ps)]
                if ps == "fwd":
                    def other(*a, scale=None, ent=ent):
                        o_, lse_ = launch(ent, A.fwd_call(*a, scale=scale),
                                          dtype, q.device.index)[:2]
                        return o_, lse_
                    runs[name] = lambda other=other: A.padded_fwd(
                        other, q, k, v, rate, seed)
                else:
                    def other(*a, scale=None, ent=ent):
                        return launch(ent, A.bwd_call(*a, scale=scale),
                                      dtype, q.device.index)[:3]
                    runs[name] = lambda other=other: A.padded_bwd(
                        other, q, k, v, o, do, lse, rate, seed)
            if ps == "fwd":
                per_call = 1
                sdpa = lambda: F.scaled_dot_product_attention(
                    q, k, v, dropout_p=rate)
            else:
                per_call = 3
                qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

                def sdpa():
                    y = F.scaled_dot_product_attention(qg, kg, vg,
                                                       dropout_p=rate)
                    torch.autograd.grad(y, (qg, kg, vg), do)
            mine = runs["this"]()
            outs = {n: runs[n]() for n in names[1:]}
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                times[name].append(c.device_ms(runs[name], 20, ("flash_",),
                                               per_call))
            row = {"row": label, "shape": [b, h, t, t, dh, width],
                   "dropout": rate, "device_ms": times,
                   "max_abs_diff": {n: max(c.max_err(x, y)
                                           for x, y in zip(mine, outs[n]))
                                    for n in names[1:]},
                   "bit_identical": {n: all(torch.equal(x, y) for x, y in
                                            zip(mine, outs[n]))
                                     for n in names[1:]}}
            row["sdpa_device_ms"] = c.device_ms(sdpa, 20)
            print(json.dumps(row), flush=True)
            bad += not all(isinstance(x, float)
                           for ts in times.values() for x in ts)
    return 1 if bad else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                               .parents[1]))
    parser.add_argument("--timed", action="store_true",
                        help="only the cases that are timed")
    parser.add_argument("--source", type=Path, action="append", default=[],
                        help="another flash_attn_fwd.cu, flash_attn_bwd.cu "
                             "or flash_fwd_wgmma.cu, timed in turns")
    parser.add_argument("--probe", action="append", default=[],
                        choices=sorted(PROBES),
                        help="time this checkout without its exchange")
    parser.add_argument("--rows", choices=("all", "wide", "pair"),
                        default="all",
                        help="wide: only the cases and rows above dh 256; "
                             "pair: only the float32 ones at (padded) dh "
                             "256")
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
    if args.source or args.probe:
        return variants([p.resolve() for p in args.source]
                        + _probe_sources(args.probe), args.rows)
    build()
    bad = 0
    for cs in CASES:
        width = 256 if 128 < cs[4] <= 256 else cs[4]
        if args.timed and not cs[7] or args.rows == "wide" and cs[4] <= 256 \
                or args.rows == "pair" and (width != 256 or cs[8] != "f32"):
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
