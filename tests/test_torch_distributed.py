"""Multi-process runs of the port (`parallel/distributed.py`, the CLI's
multi-process flags) over gloo on 127.0.0.1, as tests/test_distributed.py
runs the JAX package's: `initialize` is a no-op in one process and checks
its arguments; `cli train --cpu --num-processes 2` on the demo config,
fed by the host dataset and by the native tier, where both processes
print the same final loss; a batch the process count does not divide
exits with the JAX CLI's message; a killed rank seen by the survivor's
`barrier(timeout_s=...)` as a TimeoutError."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import torch_parallel_worker as worker
from av_separation_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = ["--config", "demo", "--cpu", "--steps", "2", "--batch", "4"]


def test_initialize_is_a_no_op_in_one_process():
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    assert distributed.process_count() == 1 and distributed.is_main()
    distributed.barrier(1.0)  # no group: returns at once
    assert distributed.check_alive(1.0)


@pytest.mark.parametrize("kw", [
    dict(coordinator_address="127.0.0.1:1"),
    dict(num_processes=2, process_id=0),
    dict(coordinator_address="127.0.0.1", num_processes=2, process_id=0),
    dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2)])
def test_initialize_validates_its_arguments(kw):
    with pytest.raises(ValueError):
        distributed.initialize(**kw)
    assert not dist.is_initialized()


def _final_losses(outs):
    losses = []
    for out in outs:
        for line in out.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "final_step" in rec:
                losses.append(rec["loss"])
    return losses


def _two_processes(extra, cwd):
    port = worker.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "av_separation_torch.cli", "train", *DEMO,
         *extra, "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"avsep train failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("data", ["host", "native"])
def test_two_process_cli_train(data):
    """DP over the job (no mesh configured): each process keeps its rows
    of the global stream; the loss is the global batch's, the same on
    both.  (At the demo's dropout 0.1 each row block draws its own
    dropout, so no one-process run gives the same number:
    tests/test_torch_parallel_train.py holds the step at dropout 0.)"""
    outs = _two_processes(["--data", data, "--eval-every", "2"], REPO)
    losses = _final_losses(outs)
    assert len(losses) == 2 and losses[0] == losses[1], outs
    assert np.isfinite(losses[0])
    # Process 0 alone logs the eval line; every process the final line.
    assert [len(o.splitlines()) for o in outs] == [2, 1], outs


def test_a_batch_the_processes_cannot_divide_exits():
    port = worker.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "av_separation_torch.cli", "train",
         "--config", "demo", "--cpu", "--steps", "1", "--batch", "3",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for i in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 1
        assert "avsep: batch_size 3 not divisible by 2 processes" in err


def test_killed_rank_is_seen_by_the_barrier(tmp_path):
    args = dict(timeout_s=10.0)
    with open(tmp_path / "args.json", "w") as f:
        json.dump(args, f)
    port = worker.free_port()
    script = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script, role, str(i), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for i, role in enumerate(("survivor", "die"))]
    try:
        procs[1].communicate(timeout=120)
        out, err = procs[0].communicate(timeout=120)  # no hang: detection
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "FAILURE_DETECTED TimeoutError" in out, (out, err[-2000:])
