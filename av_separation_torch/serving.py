"""Micro-batching request scheduler (port of `av_separation_tpu/serving.py`,
the part before its HTTP front end).

One dispatch thread owns the device.  Requests enqueue (arrays + a one-slot
result queue); the scheduler takes the first, gathers up to ``max_batch``
requests of the same signature (kind and shapes) within ``max_delay_ms``,
puts the others back, and runs ONE bucketed forward through the
`inference.Separator`.  Results fan back out per request; a failed batch
resolves each of its requests with the error.  A bounded queue sheds load at
submit time (`ServerOverloaded`).  `ServerStats` counts requests, batches and
occupancy so that batching is observable.  The HTTP front end comes with a
later slice.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from av_separation_torch.inference import Separator, bucket_batch


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    shed: int = 0
    max_batch_seen: int = 0
    total_batched: int = 0
    # Bounded: percentiles are over the most recent window anyway.
    latency_ms: "deque[float]" = field(
        default_factory=lambda: deque(maxlen=4096))

    def snapshot(self) -> Dict[str, Any]:
        lat = sorted(list(self.latency_ms)[-1000:])
        pct = (lambda p: round(lat[min(len(lat) - 1,
                                       int(p * len(lat)))], 2)) \
            if lat else (lambda p: None)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "errors": self.errors,
            "shed": self.shed,
            "mean_batch": round(self.total_batched
                                / max(1, self.batches), 2),
            "max_batch": self.max_batch_seen,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
        }


class ServerOverloaded(RuntimeError):
    """Raised at submit when the pending queue is full (load shedding)."""


class _Request:
    __slots__ = ("kind", "mixed", "lip_frames", "future", "t0")

    def __init__(self, kind: str, mixed, lip_frames):
        self.kind = kind  # "spec" (magnitude in) | "wave" (raw audio in)
        self.mixed = mixed
        self.lip_frames = lip_frames
        self.future: "queue.Queue[Tuple[str, Any]]" = queue.Queue(1)
        self.t0 = time.perf_counter()

    @property
    def signature(self):
        return (self.kind, self.mixed.shape, self.lip_frames.shape)

    def resolve(self, ok: bool, payload):
        self.future.put(("ok" if ok else "err", payload))

    def result(self, timeout: Optional[float] = None):
        kind, payload = self.future.get(timeout=timeout)
        if kind == "err":
            raise payload
        return payload


class BatchingSeparatorServer:
    """Coalesces concurrent requests into batched forwards.

    Parameters
    ----------
    separator : the `inference.Separator` to dispatch on.
    max_batch : largest batch one dispatch may carry.
    max_delay_ms : how long a lone request may wait for companions.
    max_pending : bound of the pending queue; beyond it submit sheds.
    """

    def __init__(self, separator: Separator, max_batch: int = 32,
                 max_delay_ms: float = 5.0, max_pending: int = 1024):
        self.separator = separator
        self.max_batch = int(max_batch)
        self.max_delay = max_delay_ms / 1e3
        self.stats = ServerStats()
        self._shed_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue(int(max_pending))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="avsep-batcher")
        self._thread.start()

    # -- client side -------------------------------------------------
    def submit(self, mixed_spec: np.ndarray, lip_frames: np.ndarray
               ) -> _Request:
        """Enqueue one utterance ((F, T), (N, H, W)); .result() blocks for
        (separated (S, F, T), masks)."""
        mixed_spec = np.asarray(mixed_spec, np.float32)
        lip_frames = np.asarray(lip_frames, np.float32)
        if mixed_spec.ndim != 2 or lip_frames.ndim != 3:
            raise ValueError(
                f"expected mixed_spec (F, T) and lip_frames (N, H, W); got "
                f"{mixed_spec.shape} and {lip_frames.shape}")
        return self._enqueue(_Request("spec", mixed_spec, lip_frames))

    def submit_waveform(self, mixed_audio: np.ndarray,
                        lip_frames: np.ndarray) -> _Request:
        """Enqueue one raw-audio utterance ((N_audio,), (N, H, W));
        .result() blocks for (waveforms (S, N_audio), masks)."""
        if self.separator.data_cfg is None:
            raise ValueError("waveform serving requires the Separator to "
                             "carry data_cfg (STFT geometry)")
        mixed_audio = np.asarray(mixed_audio, np.float32)
        lip_frames = np.asarray(lip_frames, np.float32)
        if mixed_audio.ndim != 1 or lip_frames.ndim != 3:
            raise ValueError(
                f"expected mixed_audio (N_audio,) and lip_frames (N, H, W); "
                f"got {mixed_audio.shape} and {lip_frames.shape}")
        return self._enqueue(_Request("wave", mixed_audio, lip_frames))

    def _count_shed(self) -> None:
        with self._shed_lock:  # client threads and the scheduler both shed
            self.stats.shed += 1

    def _enqueue(self, req: _Request) -> _Request:
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._count_shed()
            raise ServerOverloaded(
                f"pending queue full ({self._queue.maxsize} requests); "
                f"retry later") from None
        return req

    def separate(self, mixed_spec: np.ndarray, lip_frames: np.ndarray,
                 timeout: Optional[float] = 60.0):
        return self.submit(mixed_spec, lip_frames).result(timeout=timeout)

    def separate_waveform(self, mixed_audio: np.ndarray,
                          lip_frames: np.ndarray,
                          timeout: Optional[float] = 60.0):
        return self.submit_waveform(mixed_audio,
                                    lip_frames).result(timeout=timeout)

    def warmup(self, batch_sizes: Tuple[int, ...] = (1,),
               wave: bool = False, timeout: float = 600.0) -> int:
        """Send the deployment's native shapes through the dispatch thread,
        one full batch per bucket, so the first real request does not pay
        one-time set-up: kernel builds and loads, and the dispatch thread's
        own cuBLAS and cuDNN handles (PyTorch keeps them per thread).  Call
        it before serving: it clears `stats` when done, so warmup traffic is
        not counted.  Returns the batches sent."""
        cfg, d = self.separator.cfg, self.separator.data_cfg
        if d is None:
            raise ValueError("warmup requires the Separator to carry "
                             "data_cfg (feature geometry)")
        lips = np.zeros((d.total_lip_frames, d.frame_h, d.frame_w),
                        np.float32)
        kinds = [(self.submit,
                  np.zeros((cfg.freq_bins, d.num_stft_frames), np.float32))]
        if wave:
            kinds.append((self.submit_waveform,
                          np.zeros(d.num_samples_audio, np.float32)))
        n = 0
        buckets = {bucket_batch(int(b)) for b in batch_sizes}
        for bucket in sorted(min(b, self.max_batch) for b in buckets):
            for submit, mixed in kinds:
                handles = [submit(mixed, lips) for _ in range(bucket)]
                for handle in handles:
                    handle.result(timeout=timeout)
                n += 1
        self.stats = ServerStats()
        return n

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- scheduler side ----------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Drain up to max_batch same-signature requests; a lone request
        waits at most max_delay for companions."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        reqs = [first]
        sig = first.signature
        deadline = time.perf_counter() + self.max_delay
        leftovers: List[_Request] = []
        while len(reqs) < self.max_batch:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remain)
            except queue.Empty:
                break
            if nxt.signature == sig:
                reqs.append(nxt)
            else:
                leftovers.append(nxt)
        for r in leftovers:  # different signature: requeue for a later batch
            try:
                self._queue.put_nowait(r)
            except queue.Full:
                self._count_shed()
                r.resolve(False, ServerOverloaded(
                    "pending queue full while regrouping; retry later"))
        return reqs

    def _loop(self):
        while not self._stop.is_set():
            reqs = self._take_batch()
            if not reqs:
                continue
            try:
                mixed = np.stack([r.mixed for r in reqs])
                lips = np.stack([r.lip_frames for r in reqs])
                if reqs[0].kind == "wave":
                    out = self.separator.separate_waveform(mixed, lips)
                    payloads = [(out["waveforms"][i], out["masks"][i])
                                for i in range(len(reqs))]
                else:
                    separated, masks = self.separator.separate(mixed, lips)
                    payloads = [(separated[i], masks[i])
                                for i in range(len(reqs))]
            except Exception as e:  # noqa: BLE001 — resolve, don't die
                self.stats.errors += len(reqs)
                for r in reqs:
                    r.resolve(False, e)
                continue
            now = time.perf_counter()
            self.stats.batches += 1
            self.stats.requests += len(reqs)
            self.stats.total_batched += len(reqs)
            self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                            len(reqs))
            for r, payload in zip(reqs, payloads):
                self.stats.latency_ms.append((now - r.t0) * 1e3)
                r.resolve(True, payload)
