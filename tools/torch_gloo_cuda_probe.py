#!/usr/bin/env python3
"""Which collectives the gloo backend carries on CUDA tensors, with two
ranks on one card (NCCL refuses two ranks on one device in one
communicator).

    python3 tools/torch_gloo_cuda_probe.py [--timeout S]

Each collective runs in its own pair of processes, so one that crashes
or hangs cannot take the others with it.  Prints one JSON line per
collective ({"op", "ok", "detail"}), then one line with the lists
`carried` and `refused`, then the card's name and power limit.  Also
checks that a one-rank NCCL group comes up through a tcp://127.0.0.1
store and that NCCL refuses a second rank on the same card.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "broadcast", "send_recv",
       "batch_isend_irecv", "device_mesh_cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(op: str, rank: int, world: int, port: int, backend: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    if op == "all_reduce":
        dist.all_reduce(x)
        want = sum(torch.arange(4.) + 10 * r for r in range(world))
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        x = torch.cat(out)
        want = torch.cat([torch.arange(4.) + 10 * r for r in range(world)])
    elif op == "all_gather_into_tensor":
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        x = out
        want = torch.cat([torch.arange(4.) + 10 * r for r in range(world)])
    elif op == "reduce_scatter_tensor":
        full = torch.arange(2 * world, dtype=torch.float32, device=dev) \
            + 10 * rank
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, full)
        x = out
        want = sum(torch.arange(2. * world) + 10 * r
                   for r in range(world))[2 * rank:2 * rank + 2]
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        want = torch.arange(4.)
    elif op in ("send_recv", "batch_isend_irecv"):
        out = torch.empty_like(x)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if op == "send_recv":
            if rank == 0:
                dist.send(x, nxt)
                dist.recv(out, prv)
            else:
                dist.recv(out, prv)
                dist.send(x, nxt)
        else:
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                           dist.P2POp(dist.irecv, out, prv)])
            for r in reqs:
                r.wait()
        x = out
        want = torch.arange(4.) + 10 * prv
    elif op == "device_mesh_cuda":
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (1, world, 1, 1), mesh_dim_names=(
            "data", "fsdp", "seq", "model"))
        dist.all_reduce(x, group=mesh.get_group("fsdp"))
        want = sum(torch.arange(4.) + 10 * r for r in range(world))
    else:
        raise SystemExit(f"unknown op {op}")
    torch.cuda.synchronize()
    ok = torch.equal(x.cpu(), want)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": bool(ok),
                      "got": x.cpu().tolist()}), flush=True)


def run_pair(op: str, world: int, backend: str, timeout: float) -> dict:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", op, str(r), str(world),
         str(port), backend],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs, rcs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            rcs.append("timeout")
            outs.append(err[-300:])
            continue
        rcs.append(p.returncode)
        outs.append(out.strip().splitlines()[-1] if p.returncode == 0
                    and out.strip() else err.strip()[-400:])
    ok = all(rc == 0 for rc in rcs) and all(
        '"ok": true' in o for o in outs)
    return {"op": op, "backend": backend, "world": world, "ok": ok,
            "rcs": rcs, "detail": outs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=5, default=None)
    ap.add_argument("--timeout", type=float, default=25.0)
    args = ap.parse_args()
    if args.worker:
        op, rank, world, port, backend = args.worker
        worker(op, int(rank), int(world), int(port), backend)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rows = [run_pair(op, 2, "gloo", args.timeout) for op in OPS]
    rows.append(run_pair("all_reduce", 1, "nccl", args.timeout))
    nccl2 = run_pair("all_reduce", 2, "nccl", args.timeout)
    nccl2["op"] = "nccl_two_ranks_one_card"
    rows.append(nccl2)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({
        "carried": [r["op"] for r in rows[:len(OPS)] if r["ok"]],
        "refused": [r["op"] for r in rows[:len(OPS)] if not r["ok"]],
        "nccl_one_rank": rows[len(OPS)]["ok"],
        "nccl_two_ranks_one_card": nccl2["ok"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
