"""A training cell: the port's training step on batches generated on the
device, as `train.make_fused_train_steps` makes the calls.

Set-up builds one train state (model, optimizer, generators) from weights
the benchmark made, and drives it through the traffic's check steps on
the window's own calls; they are the warm-up too.  The window then steps
the same state for `seconds`; nothing is read back but the last loss,
which ends it.  After the window the reference trains the same weights on
its own batches with the same draws, and the check steps are compared.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from av_separation_torch.data.device_synthetic import (generate_batch,
                                                       step_generator)
from av_separation_torch.models.layers import Generators
from av_separation_torch.train import (TrainState, make_optimizer,
                                       make_train_step)

from avbench import compare, program
from avbench.trace import profiled, span


class TrainCell:
    def __init__(self, cell, seeds: Dict[str, int], device):
        self.cell, self.seeds, self.device = cell, seeds, device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.ref = cell.reference()
        self.batch = int(self.traffic["batch_size"])
        self.exp = program.experiment(self.cfg, self.batch)
        self.audio_s = self.batch * self.cfg["data"]["duration"]

    # -- the system under test
    def setup(self) -> None:
        t0 = time.perf_counter()
        self.marks = []
        weights = self.ref.make_weights(self.cfg, self.seeds["weights"],
                                        self.device)
        net = program.model(self.exp, weights,
                            self.ref.bn_buffers(self.cfg), self.device)
        del weights
        _sync(self.device)
        self.marks.append(("model", time.perf_counter() - t0))
        self.state = TrainState(
            step=0, model=net.train(),
            optimizer=make_optimizer(self.exp, net.parameters()),
            generators=Generators(
                seeds=torch.Generator().manual_seed(self.seeds["attn"]),
                bits=torch.Generator(device=self.device)
                .manual_seed(self.seeds["bits"])))
        self.step_fn = make_train_step(self.exp)
        n_check = int(self.traffic["check_steps"])
        losses = []
        for i in range(n_check):
            t1 = time.perf_counter()
            batch, loss = self.one_step()
            losses.append(loss)
            if i == 0:
                self.first_batch = {k: v.detach().cpu()
                                    for k, v in batch.items()}
                self.first_grads = self._adam_first_grads()
            del batch
            _sync(self.device)
            self.marks.append((f"step {i + 1}", time.perf_counter() - t1))
        self.check_losses = torch.stack(losses).tolist()
        self.change = self._change_norms()
        _sync(self.device)

    def one_step(self):
        with span("data"):
            batch = generate_batch(
                step_generator(self.seeds["data"], self.state.step,
                               self.device), self.exp.data, self.batch)
        with span("step"):
            _, metrics = self.step_fn(self.state, batch)
        return batch, metrics["loss"]

    def _adam_first_grads(self) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient as the optimizer got it, from its state
        after one step: Adam's first moment is (1 - b1) g."""
        adam = self.state.optimizer.adam
        b1 = adam.param_groups[0]["betas"][0]
        out = {}
        for name, p in self.state.model.named_parameters():
            st = adam.state.get(p, {})
            out[name] = (st["exp_avg"].norm() / (1.0 - b1)
                         if "exp_avg" in st else torch.zeros((), device=p.device))
        return out

    def _change_norms(self) -> Dict[str, torch.Tensor]:
        start = self.ref.make_weights(self.cfg, self.seeds["weights"],
                                      self.device)
        with torch.no_grad():
            return {name: (p.detach() - start[name]).norm()
                    for name, p in self.state.model.named_parameters()}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        steps, loss = 0, None
        while time.perf_counter() - t0 < seconds:
            _, loss = self.one_step()
            steps += 1
        last = float(loss)  # reads back: the device has finished
        wall = time.perf_counter() - t0
        return {"steps": steps, "wall_s": wall, "last_loss": last,
                "audio_s": steps * self.audio_s}

    def traced(self) -> dict:
        """`trace_steps` steps traced with the host's operations and spans,
        then as many on the device alone (busy and idle), so that the
        profiler's first session in the process is not the one the idle
        share is read from."""
        n = int(self.traffic["trace_steps"])
        out = {"steps": n}
        for key, host in (("timeline", True), ("busy_timeline", False)):
            _sync(self.device)
            with profiled(self.device.type, host) as holder:
                with span("window"):
                    for _ in range(n):
                        _, loss = self.one_step()
                    float(loss)
            out[key] = holder[0]
        return out

    def free(self) -> None:
        self.check_grads = {k: float(v) for k, v in self.first_grads.items()}
        self.check_change = {k: float(v) for k, v in self.change.items()}
        del self.state, self.step_fn, self.first_grads, self.change

    # -- the reference
    def reference_batch(self, step: int = 0) -> dict:
        return self.ref.synthetic_batch(self.seeds["data"], step,
                                        self.cfg["data"], self.batch,
                                        self.device)

    def reference_run(self, numerics: str, half_batch: bool = False) -> dict:
        """The reference's check steps at `numerics`; at the control's
        ('fp8') its batch is rounded to bfloat16, the precision below the
        generator's float32."""
        R = self.ref
        n_check = int(self.traffic["check_steps"])
        batches = [self.reference_batch(i) for i in range(n_check)]
        draws = R.Draws(torch.Generator().manual_seed(self.seeds["attn"]),
                        torch.Generator(device=self.device)
                        .manual_seed(self.seeds["bits"]))
        weights = R.make_weights(self.cfg, self.seeds["weights"], self.device)
        with exact_float32():
            out = R.train_steps(self.cfg, weights, batches, draws,
                                R.Numerics(numerics), half_batch)
        first = batches[0]
        if numerics == "fp8":
            first = {k: v.bfloat16().float() for k, v in first.items()}
        out["first_batch"] = {k: v.cpu() for k, v in first.items()}
        return out

    def numbers(self, ref: dict, prog: Optional[dict] = None) -> dict:
        """The compared numbers of `prog` (the program's readings by
        default) against the reference's."""
        if prog is None:
            prog = {"losses": self.check_losses,
                    "grad_norms": self.check_grads,
                    "change_norms": self.check_change,
                    "first_batch": self.first_batch}
        moving = compare.moving_leaves(ref["grad_norms"])
        return {
            "batch_rel": max(compare.rel_max(prog["first_batch"][k],
                                             ref["first_batch"][k])
                             for k in ref["first_batch"]),
            "loss_gap": max(abs(a - b) for a, b in
                            zip(prog["losses"], ref["losses"])),
            "grad_gap": compare.leaf_gap(prog["grad_norms"],
                                         ref["grad_norms"]),
            "change_gap": compare.leaf_gap(prog["change_norms"],
                                           ref["change_norms"], moving),
        }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class exact_float32:
    """float32 products and convolutions in full float32 (no TF32) for
    the reference, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved

