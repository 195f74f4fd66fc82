"""One rank of the port's parallel-tier tests (the tests/test_torch_*.py
files spawn 2 or 4 of these over gloo on 127.0.0.1, one torch thread each).

    python tests/torch_parallel_worker.py ROLE RANK WORLD PORT DIR

DIR holds `args.json` (the role's arguments) and the inputs; each rank
writes its results to DIR/rank<RANK>.pt.  Roles:

  train     create_train_state + make_train_step over a mesh on the rank's
            rows of DIR/batch.npz: losses, grad norms, the full state dict
            after the steps, the local and full sizes of every parameter
            and Adam moment; optionally a checkpoint and a mesh Separator.
  seq_ops   all-gather-KV and ring attention (self, and cross with a
            shorter KV) on the rank's time blocks, with their gradients.
  sp        make_sp_forward of a model sharded over a 'seq' mesh.
  attn      on each of several meshes over the same ranks:
            multi_head_attention(mesh=) at dropout on the block of
            DIR/qkv<dh>.npz that the JAX mesh gives device RANK, with its
            gradients; the runtime's raises on shapes the mesh does not
            divide (rows, heads, time).
  die       a barrier, then exit at once (the injected fault).
  survivor  a barrier, then barrier(timeout) with the peer gone.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _cfg(a):
    from av_separation_torch.config import (DataConfig, ExperimentConfig,
                                            LossConfig, MeshConfig,
                                            ModelConfig, TrainConfig)
    return ExperimentConfig(
        name="mp", model=ModelConfig(**a["model"]),
        data=DataConfig(**a["data"]), loss=LossConfig(**a.get("loss", {})),
        mesh=MeshConfig(**a.get("mesh", {})),
        train=TrainConfig(**a.get("train", {})))


def train(a, out, rank):
    import numpy as np
    import torch

    from av_separation_torch.parallel import shard
    from av_separation_torch.parallel.distributed import (
        global_mesh, host_local_batch_to_global)
    from av_separation_torch.train import create_train_state, make_train_step

    cfg = _cfg(a)
    mesh = global_mesh(cfg.mesh)
    state = create_train_state(cfg, device="cpu", mesh=mesh)
    step = make_train_step(cfg, mesh)
    with np.load(os.path.join(a["dir"], "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    local = host_local_batch_to_global(batch, mesh, "cpu")
    losses, norms = [], []
    for _ in range(a.get("steps", 1)):
        state, m = step(state, local)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = shard.full_state_dict(state.model, mesh)
    adam = state.optimizer.adam.state
    sizes = {name: (sh.param.numel(), full[name].numel(),
                    adam[sh.param]["exp_avg"].numel(),
                    adam[sh.param]["exp_avg_sq"].numel(),
                    sh.placement.fsdp_dim is not None,
                    sh.placement.model_dim is not None)
             for name, sh in state.model.avsep_shards.items()}
    res = {"loss": losses, "grad_norm": norms, "sizes": sizes}
    if rank == 0:
        res["state"] = {k: v.clone() for k, v in full.items()}
    if a.get("checkpoint"):
        from av_separation_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(a["checkpoint"], state.step, state, wait=True)
    if a.get("separate"):
        from av_separation_torch.inference import Separator
        sep = Separator(cfg.model, full, cfg.data, device="cpu", mesh=mesh)
        n = a["separate"]
        res["separated"] = sep.separate(batch["mixed_spec"][:n],
                                        batch["lip_frames"][:n])
    torch.save(res, out)


def seq_ops(a, out, rank):
    import numpy as np
    import torch

    from av_separation_torch.config import MeshConfig
    from av_separation_torch.parallel.distributed import global_mesh
    from av_separation_torch.parallel.sequence import (
        ring_attention, sequence_parallel_attention)

    mesh = global_mesh(MeshConfig(seq=a["seq"]))
    blk = lambda t: t.chunk(a["seq"], dim=1)[mesh.get_local_rank("seq")]
    res = {}
    with np.load(os.path.join(a["dir"], "qkv.npz")) as f:
        arrays = {k: torch.from_numpy(f[k]) for k in f.files}
    for case in ("self", "cross"):
        for name, fn in (("gather", sequence_parallel_attention),
                         ("ring", ring_attention)):
            q, k, v = (blk(arrays[f"{case}_{x}"]).clone().requires_grad_()
                       for x in "qkv")
            o = fn(q, k, v, a["nhead"], mesh)
            (o * blk(arrays[f"{case}_do"])).sum().backward()
            res[f"{case}_{name}"] = [t.detach() for t in
                                     (o, q.grad, k.grad, v.grad)]
    torch.save(res, out)


def sp(a, out, rank):
    import numpy as np
    import torch

    from av_separation_torch.models.model import build_model
    from av_separation_torch.parallel.distributed import (
        global_mesh, host_local_batch_to_global)
    from av_separation_torch.parallel.sequence import make_sp_forward
    from av_separation_torch.parallel.shard import shard_model

    cfg = _cfg(a)
    mesh = global_mesh(cfg.mesh)
    model = shard_model(build_model(cfg.model, device="cpu", seed=3), mesh)
    with np.load(os.path.join(a["dir"], "batch.npz")) as f:
        batch = host_local_batch_to_global(
            {k: f[k] for k in ("mixed_spec", "lip_frames")}, mesh, "cpu")
    sep, masks = make_sp_forward(model, mesh)(batch["mixed_spec"],
                                              batch["lip_frames"])
    torch.save({"separated": sep, "masks": masks}, out)


def attn(a, out, rank):
    import numpy as np
    import torch

    from av_separation_torch.config import MeshConfig, ModelConfig
    from av_separation_torch.models.model import build_model
    from av_separation_torch.ops.attention import (merge_heads,
                                                   multi_head_attention,
                                                   split_heads)
    from av_separation_torch.parallel import comm
    from av_separation_torch.parallel.distributed import global_mesh
    from av_separation_torch.parallel.mesh import split_rows
    from av_separation_torch.parallel.shard import shard_model

    inputs = {}
    for dh in a["head_dims"]:
        with np.load(os.path.join(a["dir"], f"qkv{dh}.npz")) as z:
            inputs[dh] = [torch.from_numpy(z[x]) for x in
                          ("q", "k", "v", "do")]  # (B, H, T, dh)
    res = {}
    for mesh_id, axes in a["meshes"].items():
        cfg = MeshConfig(**axes)
        mesh = global_mesh(cfg)
        # Rank r is device r of the JAX mesh: (data, fsdp, seq, model),
        # 'model' innermost.  The block is cut from that, not from the
        # runtime's own coordinates, so a runtime that read them in
        # another order would fold the wrong seed and fail the comparison.
        d, f, s, m = (int(i) for i in np.unravel_index(
            rank, (cfg.data, cfg.fsdp, cfg.seq, cfg.model)))
        mine = res[mesh_id] = {"at": (d, f, s, m)}
        for dh, (q, k, v, do) in inputs.items():
            rb = q.shape[0] // (cfg.data * cfg.fsdp)
            hb = q.shape[1] // cfg.model
            tb = q.shape[2] // cfg.seq
            r0 = (d * cfg.fsdp + f) * rb

            def blk(t):
                return t[r0:r0 + rb, m * hb:(m + 1) * hb,
                         s * tb:(s + 1) * tb]

            ql, kl, vl = (merge_heads(blk(t)).requires_grad_() for t in
                          (q, k, v))
            o = multi_head_attention(
                ql, kl, vl, hb, a["rate"],
                torch.Generator().manual_seed(a["generator_seed"]),
                mesh=mesh)
            o.backward(merge_heads(blk(do)))
            mine[dh] = [split_heads(t.detach(), hb) for t in
                        (o, ql.grad, kl.grad, vl.grad)]
        raises = mine["raises"] = {}
        for name, call in (
                ("rows", lambda: split_rows(cfg.data * cfg.fsdp + 1, mesh)),
                ("heads", lambda: shard_model(build_model(ModelConfig(
                    freq_bins=17, d_model=3 * cfg.model + 3,
                    nhead=cfg.model + 1, num_encoder_layers=1,
                    num_fusion_layers=1), device="cpu"), mesh)),
                ("time", lambda: comm.seq_block(cfg.seq + 1, mesh))):
            try:
                call()
                raises[name] = None
            except ValueError as e:
                raises[name] = str(e)
    torch.save(res, out)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(role, world, args, d, timeout=120.0):
    """Spawn `world` ranks of `role` with `args` in directory `d`; the
    per-rank results (torch.load of DIR/rank<r>.pt) once all exit 0."""
    import subprocess

    import torch

    with open(os.path.join(d, "args.json"), "w") as f:
        json.dump(args, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), role, str(r), str(world),
         str(port), str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if errs:
        raise RuntimeError(f"{role} rank failed:\n" + "\n".join(errs))
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main() -> int:
    role, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    with open(os.path.join(d, "args.json")) as f:
        a = json.load(f)
    a["dir"] = d
    from av_separation_torch.parallel.distributed import (barrier,
                                                          initialize,
                                                          shutdown)
    initialize(f"127.0.0.1:{port}", world, rank, cpu=True)
    out = os.path.join(d, f"rank{rank}.pt")
    if role == "die":
        barrier(timeout_s=60.0)
        os._exit(0)  # no shutdown handshake: the injected fault
    if role == "survivor":
        barrier(timeout_s=60.0)
        time.sleep(1.0)  # let the peer die
        try:
            barrier(timeout_s=a.get("timeout_s", 5.0))
        except TimeoutError:
            print("FAILURE_DETECTED TimeoutError", flush=True)
            os._exit(0)
        except RuntimeError as e:
            print(f"FAILURE_DETECTED RuntimeError {e}", flush=True)
            os._exit(0)
        print("BARRIER_UNEXPECTEDLY_PASSED", flush=True)
        os._exit(1)
    roles = {"train": train, "seq_ops": seq_ops, "sp": sp, "attn": attn}
    roles[role](a, out, rank)
    barrier(timeout_s=60.0)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
