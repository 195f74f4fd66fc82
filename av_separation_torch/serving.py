"""Micro-batching request scheduler and its stdlib HTTP front end (port of
`av_separation_tpu/serving.py`).

One dispatch thread owns the device.  Requests enqueue (arrays + a one-slot
result queue); the scheduler takes the oldest, gathers up to ``max_batch``
requests of the same signature (kind and shapes) within ``max_delay_ms``,
holds the others back per signature, and runs ONE bucketed forward through
the `inference.Separator`.  The oldest held group goes next, so a shape
that is rare in the traffic waits at most one batch behind the common one.
Results fan back out per request; a failed batch resolves each of its
requests with the error.  A bounded queue sheds load at submit time
(`ServerOverloaded`).  `ServerStats` counts requests, batches and occupancy
so that batching is observable.

`make_http_server` / `serve_forever` speak npz over HTTP (POST /separate,
POST /separate_waveform, GET /stats, GET /healthz), as the JAX front end,
with its hardening: bearer auth, a request size cap, TLS.  Unlike it, the
TLS handshake runs in the request's own thread under a timeout (a client
that stalls mid-handshake holds only its own thread), a Content-Length that
is not a non-negative integer is refused before any read, and a refused
oversized body is drained for at most 1 MB.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

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
        # Requests taken from the queue while another signature's batch was
        # gathered, per signature, oldest group first (dispatch thread only).
        self._held: "Dict[Any, Deque[_Request]]" = {}
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
        """Up to max_batch same-signature requests: the oldest held group
        if there is one, else the oldest queued request, joined by queued
        requests of its signature that arrive within max_delay (a held
        group, which has waited already, takes only those queued now).
        Requests of other signatures are held back, in arrival order."""
        if self._held:
            sig, group = next(iter(self._held.items()))
            reqs = [group.popleft()
                    for _ in range(min(self.max_batch, len(group)))]
            if not group:
                del self._held[sig]
            deadline = time.perf_counter()
        else:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                return []
            reqs, sig = [first], first.signature
            deadline = time.perf_counter() + self.max_delay
        held = sum(len(g) for g in self._held.values())
        while len(reqs) < self.max_batch and held < self._queue.maxsize:
            remain = deadline - time.perf_counter()
            try:
                nxt = self._queue.get(timeout=remain) if remain > 0 \
                    else self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt.signature == sig:
                reqs.append(nxt)
            else:
                self._held.setdefault(nxt.signature, deque()).append(nxt)
                held += 1
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


# ---------------------------------------------------------------------------
# stdlib HTTP front end
# ---------------------------------------------------------------------------

REQUEST_TIMEOUT_S = 30.0     # socket timeout a connection: TLS, reads, writes
MAX_DRAIN_BYTES = 1 << 20    # the most of a refused (413) body that is read


def make_http_server(server: BatchingSeparatorServer, host: str = "0.0.0.0",
                     port: int = 8571, auth_token: Optional[str] = None,
                     max_request_bytes: int = 64 * 1024 * 1024,
                     certfile: Optional[str] = None,
                     keyfile: Optional[str] = None):
    """ThreadingHTTPServer speaking npz: POST /separate (mixed_spec,
    lip_frames -> separated, masks), POST /separate_waveform (mixed_audio,
    lip_frames -> waveforms, masks), GET /stats, GET /healthz.

    Each handler thread blocks on its request's future while the batcher
    thread coalesces across connections: concurrency is the batch source.

    Hardening:
      auth_token        : when set, every endpoint except /healthz requires
                          ``Authorization: Bearer <token>`` (401 otherwise,
                          compared with hmac.compare_digest).
      max_request_bytes : bodies above this get 413 after at most 1 MB of
                          them is drained, and the connection closes; 411
                          without Content-Length, 400 when it is not a
                          non-negative integer, before any read.
      certfile/keyfile  : serve TLS (stdlib ssl; a PEM cert + key).  The
                          handshake runs in the connection's handler thread
                          under REQUEST_TIMEOUT_S, never in the accept loop.
    A server overloaded at submit answers 503 with ``Retry-After: 1``; a
    request that fails answers 400.
    """
    import hmac
    import ssl
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ctx = None
    if certfile:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile)

    class Handler(BaseHTTPRequestHandler):
        timeout = REQUEST_TIMEOUT_S

        def setup(self):
            self.request.settimeout(self.timeout)
            self.handshake_ok = True
            if ctx is not None:
                try:
                    self.request.do_handshake()
                except OSError:  # ssl.SSLError, a timeout, a reset
                    self.handshake_ok = False
            super().setup()

        def handle(self):
            if self.handshake_ok:
                super().handle()

        def log_message(self, *a):  # quiet; stats carry observability
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Tuple[Tuple[str, str], ...] = ()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _send_err(self, code: int, msg: str, headers=()):
            self._send(code, json.dumps({"error": msg}).encode(),
                       "application/json", headers)

        def _authorized(self) -> bool:
            if auth_token is None:
                return True
            got = self.headers.get("Authorization", "")
            ok = got.startswith("Bearer ") and hmac.compare_digest(
                got[len("Bearer "):].encode(), auth_token.encode())
            if not ok:
                self._send_err(401, "missing or invalid bearer token")
            return ok

        def do_GET(self):
            if self.path == "/healthz":  # liveness probe: never gated
                self._send(200, b'{"status": "ok"}', "application/json")
                return
            if not self._authorized():
                return
            if self.path != "/stats":
                self._send_err(404, "unknown endpoint")
                return
            body = json.dumps(server.stats.snapshot()).encode()
            self._send(200, body, "application/json")

        def _read_body(self) -> Optional[bytes]:
            length = self.headers.get("Content-Length")
            if length is None:
                self._send_err(411, "Content-Length required")
                return None
            try:
                n = int(length)
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                self._send_err(400, f"bad Content-Length {length!r}")
                return None
            if n > max_request_bytes:
                # Drain a little of the refused body so that a client that
                # is still sending sees the 413, then close: at most
                # MAX_DRAIN_BYTES, whatever the declared length.
                remaining = min(n, MAX_DRAIN_BYTES)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                self._send_err(413, f"request body {n} bytes exceeds limit "
                                    f"{max_request_bytes}")
                return None
            return self.rfile.read(n)

        def do_POST(self):
            if not self._authorized():
                return
            if self.path not in ("/separate", "/separate_waveform"):
                self._send_err(404, "unknown endpoint")
                return
            body = self._read_body()
            if body is None:
                return
            try:
                buf = io.BytesIO()
                if self.path == "/separate":
                    with np.load(io.BytesIO(body)) as z:
                        mixed, lips = z["mixed_spec"], z["lip_frames"]
                    separated, masks = server.separate(mixed, lips)
                    np.savez(buf, separated=separated, masks=masks)
                else:
                    with np.load(io.BytesIO(body)) as z:
                        audio, lips = z["mixed_audio"], z["lip_frames"]
                    waves, masks = server.separate_waveform(audio, lips)
                    np.savez(buf, waveforms=waves, masks=masks)
            except ServerOverloaded as e:
                self._send_err(503, str(e), (("Retry-After", "1"),))
                return
            except Exception as e:  # noqa: BLE001 — HTTP error, keep serving
                self._send_err(400, str(e))
                return
            self._send(200, buf.getvalue(), "application/npz")

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        block_on_close = False

        def get_request(self):
            sock, addr = super().get_request()
            if ctx is not None:  # no I/O here: the handshake is deferred
                sock = ctx.wrap_socket(sock, server_side=True,
                                       do_handshake_on_connect=False)
            return sock, addr

    return Server((host, port), Handler)


def serve_forever(separator: Separator, host: str = "0.0.0.0",
                  port: int = 8571, max_batch: int = 32,
                  max_delay_ms: float = 5.0,
                  auth_token: Optional[str] = None,
                  max_request_bytes: int = 64 * 1024 * 1024,
                  certfile: Optional[str] = None,
                  keyfile: Optional[str] = None,
                  warmup_batches: Tuple[int, ...] = (),
                  max_pending: int = 1024):
    """Blocking entry of `cli serve`: a batcher over `separator`, warmed up
    on `warmup_batches`, behind `make_http_server` until interrupted."""
    batcher = BatchingSeparatorServer(separator, max_batch=max_batch,
                                      max_delay_ms=max_delay_ms,
                                      max_pending=max_pending)
    httpd = None
    try:
        if warmup_batches:
            t0 = time.perf_counter()
            n = batcher.warmup(warmup_batches,
                               wave=separator.data_cfg is not None)
            print(f"avsep warmup: {n} programs compiled in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        httpd = make_http_server(batcher, host, port, auth_token=auth_token,
                                 max_request_bytes=max_request_bytes,
                                 certfile=certfile, keyfile=keyfile)
        scheme = "https" if certfile else "http"
        print(f"avsep serving on {scheme}://{host}:{port} "
              f"(max_batch={max_batch}, max_delay_ms={max_delay_ms}, "
              f"auth={'on' if auth_token else 'off'})", flush=True)
        httpd.serve_forever()
    finally:
        if httpd is not None:
            httpd.server_close()
        batcher.close()
