"""Command line: train, evaluate, separate, serve and bench (port of
`av_separation_tpu/cli.py`).

    python -m av_separation_torch.cli train --config demo --steps 100
    python -m av_separation_torch.cli train --config scaled --data device --fused
    python -m av_separation_torch.cli train --config scaled --data files --data-root corpus
    python -m av_separation_torch.cli train --config scaled --data native
    python -m av_separation_torch.cli train --config scaled --dtype bfloat16
    python -m av_separation_torch.cli eval --config demo --checkpoint-dir ckpt
    python -m av_separation_torch.cli separate --config demo --checkpoint-dir ckpt
    python -m av_separation_torch.cli serve --config scaled --serve-port 8571
    python -m av_separation_torch.cli bench [--mode per_step] [--dtype float32]
    python -m av_separation_torch.cli train --config demo --cpu \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
    python -m av_separation_torch.cli train --config multihost \
        --coordinator HOST:PORT --num-processes 8 --process-id I

Every command runs on the CUDA device and raises without one; `--cpu` runs
it on the CPU (the kernels' plain versions).  `--dtype` sets the model's
compute dtype.  The JSON lines are the JAX CLI's: one per logged step, eval
lines between them, and a final {"final_step", "loss", "audio_s_per_s"}
line, whose loss is printed unrounded so that two runs can be compared.
`--data` picks the per-step loop's batches: the host NumPy dataset, batches
generated on the device, the native C++ generator, or a corpus on disk
(`--data files --data-root DIR`, `--dynamic-mix` to remix its speakers on
the fly); `--fused` always generates on the device, as in the JAX CLI.
`eval` scores the 20 deterministic synthetic host samples whatever the
pipeline.  `--debug-nans` raises FloatingPointError at the module or
backward function that first produces a NaN (`utils/debug.py`).  `serve`
takes the JAX CLI's `--serve-*` flags and `AVSEP_AUTH_TOKEN`, and stops on
SIGINT.  `bench` is `av_separation_torch.bench` (its flags `--config
--steps --batch --dtype --mode --cpu`, the JAX bench's defaults: demo,
250, 128, bfloat16, fused) and prints its one JSON line.

`train` runs over a mesh (`parallel/`) in a job of one process a device:
`--coordinator host:port --num-processes N --process-id I` join it (gloo
with `--cpu`, else NCCL on CUDA device I % device count) before any device
is touched; `--mesh-data/-fsdp/-seq/-model` override the config's mesh.
As in the JAX CLI, an unconfigured mesh becomes DP over the job, a mesh
whose device count is not the job's exits, every process iterates the same
global batch stream and keeps its rows (a batch the process count does not
divide exits), step lines come from process 0 and the final line from
every process.  One process runs without a mesh; the other commands take
the flags and run on one device, as the JAX CLI's do.  `--impl` is not
carried over: a tensor on the card always runs the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="demo",
                   help="named config: demo|scaled|three_speaker|lrs2|"
                        "multihost")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="compute dtype (default: the config's, float32)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--pit", choices=("global", "per_sample"), default=None)
    p.add_argument("--data", choices=("host", "device", "native", "files"),
                   default=None,
                   help="batch pipeline: the host NumPy dataset, batches "
                        "generated on the model's device, the native C++ "
                        "generator, or a corpus on disk (--data-root)")
    p.add_argument("--data-root", default=None,
                   help="corpus directory for --data files")
    p.add_argument("--dynamic-mix", action="store_true",
                   help="remix the speakers of --data files on the fly")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "training loop into this directory")
    p.add_argument("--fused", action="store_true",
                   help="K steps per call on batches generated on the "
                        "device, reading back to the host only between "
                        "segments (logging, eval, checkpoints)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="run the SNR eval every N steps")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the module or backward "
                        "function that first produces a NaN")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-fsdp", type=int, default=None,
                   help="ZeRO-style parameter + Adam-moment sharding axis")
    p.add_argument("--mesh-seq", type=int, default=None,
                   help="sequence-parallel axis: the audio time axis is "
                        "split over it")
    p.add_argument("--mesh-model", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the rank-0 store's host:port")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: the job's process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's rank")


def _build_config(args):
    from av_separation_torch.config import NAMED_CONFIGS, get_config

    if args.config not in NAMED_CONFIGS:
        sys.exit(f"avsep: unknown config '{args.config}'. "
                 f"Available: {', '.join(sorted(NAMED_CONFIGS))}")
    cfg = get_config(args.config)
    if args.dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.dtype))
    train_kw = {}
    for field, attr in (("batch_size", "batch"), ("steps", "steps"),
                        ("checkpoint_dir", "checkpoint_dir"),
                        ("checkpoint_every", "checkpoint_every"),
                        ("data_pipeline", "data"), ("data_root", "data_root"),
                        ("seed", "seed")):
        v = getattr(args, attr)
        if v is not None:
            train_kw[field] = v
    if args.dynamic_mix:
        train_kw["dynamic_mix"] = True
    if train_kw:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **train_kw))
    if args.pit:
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, pit_mode=args.pit))
    if (args.mesh_data or args.mesh_fsdp or args.mesh_seq
            or args.mesh_model):
        from av_separation_torch.config import MeshConfig
        cfg = dataclasses.replace(
            cfg, mesh=MeshConfig(data=args.mesh_data or 1,
                                 fsdp=args.mesh_fsdp or 1,
                                 seq=args.mesh_seq or 1,
                                 model=args.mesh_model or 1))
    return cfg


def _init_multiprocess(args) -> bool:
    """Join the job when the multi-process flags are given, before any
    device is touched; False for a one-process run."""
    from av_separation_torch.parallel.distributed import initialize
    try:
        return initialize(args.coordinator, args.num_processes,
                          args.process_id, cpu=args.cpu)
    except ValueError as e:
        sys.exit(f"avsep: {e}")


def _mesh_or_none(cfg):
    """(mesh, its config): in a multi-process job, the config's mesh over
    the job (DP over the job when none was configured); in one process,
    none."""
    import torch.distributed as dist

    from av_separation_torch.config import MeshConfig
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh_cfg = cfg.mesh
    if mesh_cfg.num_devices != n:
        if mesh_cfg.num_devices == 1:  # unconfigured: DP over the job
            mesh_cfg = MeshConfig(data=n)
        else:
            sys.exit(f"avsep: mesh {mesh_cfg} needs {mesh_cfg.num_devices} "
                     f"devices but the job has {n}")
    if n == 1:
        return None, mesh_cfg
    from av_separation_torch.parallel.distributed import global_mesh
    return global_mesh(mesh_cfg), mesh_cfg


def _device(args):
    from av_separation_torch.models.model import resolve_device
    return resolve_device("cpu" if args.cpu else "cuda")


def _nan_checks(args, model):
    """`utils.debug.debug_nans(model)` under --debug-nans, else nothing."""
    if not args.debug_nans:
        return contextlib.nullcontext()
    from av_separation_torch.utils.debug import debug_nans
    return debug_nans(model)


def _batches(cfg, device, start_step: int = 0, mesh=None):
    """Batch stream of the per-step loop; `start_step` makes a resumed run
    see the stream an uninterrupted run sees from that step.  The caller
    closes it (the files and native tiers run threads).  Under a mesh the
    device tier generates the rank's rows; the others give the global
    batch, of which the caller keeps the rank's rows."""
    pipeline = cfg.train.data_pipeline
    if pipeline == "device":
        from av_separation_torch.data.device_synthetic import (
            device_batch_iterator)
        from av_separation_torch.parallel.mesh import split_rows
        rows = slice(None) if mesh is None \
            else split_rows(cfg.train.batch_size, mesh)
        return device_batch_iterator(cfg.data, cfg.train.batch_size,
                                     seed=cfg.train.seed,
                                     start_step=start_step, device=device,
                                     rows=rows)
    if pipeline == "files":
        from av_separation_torch.data.files import (FileAVDataset,
                                                    PrefetchIterator)
        if not cfg.train.data_root:
            sys.exit("avsep: --data files requires --data-root")
        ds = FileAVDataset(cfg.train.data_root, cfg.data,
                           dynamic_mix=cfg.train.dynamic_mix,
                           seed=cfg.train.seed)
        return PrefetchIterator(ds, cfg.train.batch_size,
                                seed=cfg.train.seed, start_step=start_step)
    if pipeline == "native":
        from av_separation_torch.data.native_loader import (
            NativeBatchIterator)
        return NativeBatchIterator(cfg.data, cfg.train.batch_size,
                                   seed=cfg.train.seed,
                                   start_step=start_step)
    from av_separation_torch.data.loader import batch_iterator
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    return batch_iterator(SyntheticAVDataset(cfg.data), cfg.train.batch_size,
                          seed=cfg.train.seed, start_step=start_step)


def _eval_metrics(model, batch, mesh=None) -> dict:
    from av_separation_torch.train import make_eval_step

    m = make_eval_step(mesh)(model, batch)
    out = {k: round(float(v), 4) for k, v in m.items()}
    out["snr_improvement_db"] = round(
        float(m["output_snr"]) - float(m["input_snr"]), 4)
    return out


def _eval_runner(cfg, mesh=None, device=None):
    """(state) -> metrics of the 20 deterministic host eval samples (under
    a mesh, the rank's rows of them)."""
    from av_separation_torch.data.loader import eval_batch
    from av_separation_torch.data.synthetic import SyntheticAVDataset

    batch = eval_batch(SyntheticAVDataset(cfg.data), 20)
    if mesh is not None:
        from av_separation_torch.parallel.distributed import (
            host_local_batch_to_global)
        batch = host_local_batch_to_global(batch, mesh, device)
    return lambda state: _eval_metrics(state.model, batch, mesh)


def _final_line(step: int, loss, audio_s: float, dt: float) -> None:
    print(json.dumps({"final_step": step, "loss": float(loss),
                      "audio_s_per_s": round(audio_s / max(dt, 1e-9), 2)}),
          flush=True)


def _save_every(cfg, step: int, state) -> None:
    if (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
            and step % cfg.train.checkpoint_every == 0):
        from av_separation_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(cfg.train.checkpoint_dir, step, state)


def cmd_train(args) -> int:
    from av_separation_torch.parallel import distributed
    from av_separation_torch.train import create_train_state, make_train_step
    from av_separation_torch.utils.profiling import (Timer, step_metrics_line,
                                                     trace)

    cfg = _build_config(args)
    joined = _init_multiprocess(args)
    mesh, mesh_cfg = _mesh_or_none(cfg)
    nproc, is_main = distributed.process_count(), distributed.is_main()
    if nproc > 1 and cfg.train.batch_size % nproc:
        sys.exit(f"avsep: batch_size {cfg.train.batch_size} not divisible "
                 f"by {nproc} processes")
    device = _device(args)

    def say(line: str, **kw) -> None:
        if is_main:
            print(line, flush=True, **kw)

    shape = "x".join(str(n) for n in (mesh_cfg.data, mesh_cfg.fsdp,
                                       mesh_cfg.seq, mesh_cfg.model))
    say(f"config={cfg.name} device={device} processes={nproc} "
        f"mesh={shape if mesh else 1} data={cfg.train.data_pipeline} "
        f"fused={args.fused}", file=sys.stderr)
    state = create_train_state(cfg, device=device, mesh=mesh)
    start_step = 0
    if cfg.train.checkpoint_dir:
        from av_separation_torch.utils.checkpoint import restore_checkpoint
        state = restore_checkpoint(cfg.train.checkpoint_dir, state)
        start_step = state.step
        if start_step:
            say(f"resumed from step {start_step}", file=sys.stderr)

    evaluate = _eval_runner(cfg, mesh, device) if args.eval_every else None
    ctx = trace(args.profile_dir) if args.profile_dir and is_main \
        else contextlib.nullcontext()
    per_step_audio = cfg.train.batch_size * cfg.data.duration
    with ctx, _nan_checks(args, state.model):
        if args.fused:
            state = _fused_train(args, cfg, state, start_step, evaluate, mesh,
                                 say)
        else:
            step_fn = make_train_step(cfg, mesh)
            batches = _batches(cfg, device, start_step, mesh)
            local = _local_rows(cfg, mesh, device)
            timer = Timer()
            try:
                for i in range(start_step, cfg.train.steps):
                    state, metrics = step_fn(state, local(next(batches)))
                    if cfg.train.log_every \
                            and (i + 1) % cfg.train.log_every == 0:
                        audio_s = (i + 1 - start_step) * per_step_audio
                        say(step_metrics_line(i + 1, metrics, {
                            "audio_s_per_s": round(
                                audio_s / timer.elapsed(), 2)}))
                    if evaluate and (i + 1) % args.eval_every == 0:
                        say(step_metrics_line(i + 1, evaluate(state)))
                    _save_every(cfg, i + 1, state)
            finally:
                batches.close()
            if cfg.train.steps > start_step:
                # A summary line even when steps < log_every.
                dt = timer.elapsed()
                _final_line(cfg.train.steps, metrics["loss"],
                            (cfg.train.steps - start_step) * per_step_audio,
                            dt)

    if cfg.train.checkpoint_dir:
        from av_separation_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(cfg.train.checkpoint_dir, state.step, state,
                        wait=True)
        say(f"saved checkpoint at step {state.step}", file=sys.stderr)
    if joined:
        # Every process waits for the others before the group goes down.
        try:
            distributed.barrier(timeout_s=120.0)
        finally:
            distributed.shutdown()
    return 0


def _local_rows(cfg, mesh, device):
    """batch -> the rank's rows of it on its device under a mesh (the
    device tier already generated only those); the batch itself without
    one."""
    if mesh is None or cfg.train.data_pipeline == "device":
        return lambda batch: batch
    from av_separation_torch.parallel.distributed import (
        host_local_batch_to_global)
    return lambda batch: host_local_batch_to_global(batch, mesh, device)


def _fused_train(args, cfg, state, start_step: int, evaluate, mesh=None,
                 say=print):
    """K steps per call on device-generated batches
    (`train.make_fused_train_steps`), reading back to the host only at
    segment ends for logging, eval and checkpoints."""
    from av_separation_torch.train import make_fused_train_steps
    from av_separation_torch.utils.profiling import Timer, step_metrics_line

    # The longest segment that still lands on every log, eval and
    # checkpoint step.
    seg = cfg.train.log_every or 20
    for every in (cfg.train.checkpoint_every, args.eval_every):
        if every:
            seg = math.gcd(seg, every)
    fused = {}
    per_step_audio = cfg.train.batch_size * cfg.data.duration
    step = start_step
    timer = Timer()
    loss = None
    while step < cfg.train.steps:
        k = min(seg, cfg.train.steps - step)
        if k not in fused:
            fused[k] = make_fused_train_steps(cfg, k, mesh)
        state, loss = fused[k](state)
        step += k
        if cfg.train.log_every and step % cfg.train.log_every == 0:
            audio_s = (step - start_step) * per_step_audio
            say(step_metrics_line(step, {"loss": loss}, {
                "audio_s_per_s": round(audio_s / timer.elapsed(), 2),
                "fused_segment": k}))
        if evaluate and step % args.eval_every == 0:
            say(step_metrics_line(step, evaluate(state)))
        _save_every(cfg, step, state)
    if step > start_step:
        dt = timer.elapsed()
        _final_line(step, loss, (step - start_step) * per_step_audio, dt)
    return state


def cmd_eval(args) -> int:
    from av_separation_torch.data.loader import eval_batch
    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.train import create_train_state

    cfg = _build_config(args)
    state = create_train_state(cfg, device=_device(args))
    if cfg.train.checkpoint_dir:
        from av_separation_torch.utils.checkpoint import restore_checkpoint
        state = restore_checkpoint(cfg.train.checkpoint_dir, state)
    batch = eval_batch(SyntheticAVDataset(cfg.data), 20)
    with _nan_checks(args, state.model):
        metrics = _eval_metrics(state.model, batch)
    print(json.dumps(metrics), flush=True)
    return 0


def _separator(cfg, device, what: str):
    """A Separator over --checkpoint-dir, else over the seeded untrained
    init (`build_model` from --seed)."""
    from av_separation_torch.inference import Separator
    from av_separation_torch.models.model import build_model

    if cfg.train.checkpoint_dir:
        return Separator.from_checkpoint(cfg.train.checkpoint_dir, cfg.model,
                                         cfg.data, device=device)
    weights = build_model(cfg.model, device="cpu",
                          seed=cfg.train.seed).state_dict()
    print(f"{what}: no --checkpoint-dir, using untrained init",
          file=sys.stderr)
    return Separator(cfg.model, weights, cfg.data, device=device)


def cmd_separate(args) -> int:
    """Serving-path smoke: synthetic mixtures (deterministic per index)
    through `Separator.separate_waveform`, with the waveform SI-SNR against
    the clean sources.  Loads the model from --checkpoint-dir when given,
    else draws it from --seed."""
    import numpy as np
    import torch

    from av_separation_torch.data.synthetic import SyntheticAVDataset
    from av_separation_torch.ops.istft import permutation_si_snr_waveform

    cfg = _build_config(args)
    sep = _separator(cfg, _device(args), "separate")

    ds = SyntheticAVDataset(cfg.data)
    n = args.batch or 4
    cleans = np.stack([ds.clean_audios(i)[0] for i in range(n)])  # (B, S, N)
    lips = np.stack([ds[i]["lip_frames"] for i in range(n)])
    with _nan_checks(args, sep.model):
        out = sep.separate_waveform(cleans.sum(axis=1), lips)
    snr = permutation_si_snr_waveform(torch.from_numpy(out["waveforms"]),
                                      torch.from_numpy(cleans))
    print(json.dumps({
        "batch": n,
        "waveform_shape": list(out["waveforms"].shape),
        "si_snr_waveform_db": round(float(snr.mean()), 3),
        "mask_min": round(float(out["masks"].min()), 4),
        "mask_max": round(float(out["masks"].max()), 4),
    }), flush=True)
    return 0


def cmd_serve(args) -> int:
    """The micro-batching HTTP separation server (`serving.serve_forever`)
    until SIGINT; then one JSON line of the kernel launches the process
    made (warm-up included)."""
    from av_separation_torch.ops import kernels
    from av_separation_torch.serving import serve_forever

    cfg = _build_config(args)
    sep = _separator(cfg, _device(args), "serve")
    warmup = tuple(int(b) for b in args.serve_warmup.split(",") if b)
    with _nan_checks(args, sep.model):
        try:
            serve_forever(sep, host=args.serve_host, port=args.serve_port,
                          max_batch=args.serve_max_batch,
                          max_delay_ms=args.serve_max_delay_ms,
                          auth_token=args.serve_auth_token
                          or os.environ.get("AVSEP_AUTH_TOKEN"),
                          max_request_bytes=args.serve_max_request_mb << 20,
                          certfile=args.serve_certfile,
                          keyfile=args.serve_keyfile, warmup_batches=warmup,
                          max_pending=args.serve_max_pending)
        except KeyboardInterrupt:
            print("avsep: interrupted, stopped serving", file=sys.stderr,
                  flush=True)
    print(json.dumps({"kernel_launches": dict(kernels.LAUNCHES)}),
          flush=True)
    return 0


def _add_serve(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's --serve-* flags."""
    p.add_argument("--serve-host", default="0.0.0.0")
    p.add_argument("--serve-port", type=int, default=8571)
    p.add_argument("--serve-max-batch", type=int, default=32)
    p.add_argument("--serve-max-delay-ms", type=float, default=5.0)
    p.add_argument("--serve-auth-token", default=None,
                   help="bearer token required on every endpoint except "
                        "/healthz (or env AVSEP_AUTH_TOKEN)")
    p.add_argument("--serve-max-request-mb", type=int, default=64,
                   help="refuse request bodies above this size (413)")
    p.add_argument("--serve-certfile", default=None,
                   help="PEM certificate: serve TLS")
    p.add_argument("--serve-keyfile", default=None)
    p.add_argument("--serve-max-pending", type=int, default=1024,
                   help="pending-request queue depth; beyond it requests "
                        "are shed with 503 + Retry-After")
    p.add_argument("--serve-warmup", default="",
                   help="comma-separated batch sizes to run through both "
                        "APIs before accepting traffic, e.g. '1,8,32'")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m av_separation_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("train", cmd_train), ("eval", cmd_eval),
                     ("separate", cmd_separate), ("serve", cmd_serve)):
        p = sub.add_parser(name)
        _add_common(p)
        if name == "serve":
            _add_serve(p)
        p.set_defaults(fn=fn)
    p = sub.add_parser("bench")
    from av_separation_torch import bench
    bench.add_flags(p)
    p.set_defaults(fn=bench.cmd)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
