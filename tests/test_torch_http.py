"""The port's HTTP front end (`serving.make_http_server`) against the JAX
package's, and the faults of the JAX front end that the port leaves out.

The same request sequence (every endpoint and status code of
tests/test_serving.py's front-end tests) goes to a JAX server and to the
port's, each over the small model of tests/test_torch_inference.py on the
same weights, on the CPU: status codes and npz keys must agree, arrays
within test_torch_inference.py's tolerances.  Then the port alone: requests
coalesce, an overloaded server sheds with 503, a client that stalls in the
TLS handshake holds up no one else, a Content-Length that is not a
non-negative integer gets 400, a refused body is drained for at most 1 MB,
and a shape that is rare in the traffic is answered within two batches.
No socket waits longer than 10 s.
"""

import http.client
import io
import json
import socket
import ssl
import threading
import time

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from av_separation_tpu.config import DataConfig as JaxDataConfig
from av_separation_tpu.config import ModelConfig as JaxModelConfig
from av_separation_tpu.inference import Separator as JaxSeparator
from av_separation_tpu.models.model import AVSeparationTransformer as JaxModel
from av_separation_tpu.serving import BatchingSeparatorServer as JaxBatcher
from av_separation_tpu.serving import make_http_server as jax_http_server
from av_separation_torch.config import DataConfig, ModelConfig
from av_separation_torch.inference import Separator
from av_separation_torch.serving import (MAX_DRAIN_BYTES, REQUEST_TIMEOUT_S,
                                         BatchingSeparatorServer,
                                         make_http_server)
from av_separation_torch.utils.transplant import from_jax_variables

SMALL = dict(freq_bins=65, d_model=64, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, num_speakers=2, dropout=0.1)
DATA = dict(sample_rate=2000, duration=1.0, n_fft=128, hop_length=64,
            num_frames=5, frame_h=16, frame_w=16)
N_AUDIO, T = 2000, 32
EDGE = 128 - 64  # least-squares edge samples at each end
TOKEN = "sekrit"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
LIMIT = 256 * 1024  # max_request_bytes of the compared servers
TIMEOUT = 10


@pytest.fixture(scope="module")
def separators():
    """(JAX Separator, port Separator on the CPU) on the same weights."""
    jcfg = JaxModelConfig(**SMALL, attn_impl="xla", decoder_impl="xla",
                          proj_impl="xla", stem_impl="xla")
    variables = JaxModel(jcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 65, T)),
                                    jnp.zeros((1, 10, 16, 16)))
    variables = jtu.tree_map(np.asarray, variables)
    ours = Separator(ModelConfig(**SMALL), from_jax_variables(variables),
                     DataConfig(**DATA), device="cpu")
    return JaxSeparator(jcfg, variables, JaxDataConfig(**DATA)), ours


class Serving:
    """An HTTP server over a batcher, serving from a thread."""

    def __init__(self, make_server, batcher, **kw):
        self.batcher = batcher
        self.httpd = make_server(batcher, host="127.0.0.1", port=0, **kw)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def call(port, method, path, body=None, headers=None, tls=None):
    """One request -> (status, headers, body bytes)."""
    if tls is None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    else:
        conn = http.client.HTTPSConnection("127.0.0.1", port,
                                           timeout=TIMEOUT, context=tls)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def raw(port, head: bytes, body: bytes = b""):
    """Bytes over a plain socket -> the response's status line."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        s.sendall(head + body)
        return s.makefile("rb").readline().decode()


def npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def spec_request(seed):
    rng = np.random.default_rng(seed)
    return {"mixed_spec": np.abs(rng.normal(size=(65, T))).astype(np.float32),
            "lip_frames": rng.uniform(size=(10, 16, 16)).astype(np.float32)}


def wave_request(seed):
    rng = np.random.default_rng(seed)
    return {"mixed_audio": rng.normal(size=N_AUDIO).astype(np.float32),
            "lip_frames": rng.uniform(size=(10, 16, 16)).astype(np.float32)}


def no_length(port, path):
    """A POST without Content-Length."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Authorization", AUTH["Authorization"])
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


# (label, request) over a server with auth TOKEN and max_request_bytes
# LIMIT: tests/test_serving.py's front-end sequence, plus 404s, 411 and a
# body that is no npz.
SEQUENCE = [
    ("healthz", lambda p: call(p, "GET", "/healthz")),
    ("stats no token", lambda p: call(p, "GET", "/stats")),
    ("stats wrong token", lambda p: call(
        p, "GET", "/stats", headers={"Authorization": "Bearer nope"})),
    ("separate", lambda p: call(p, "POST", "/separate",
                                npz(**spec_request(9)), AUTH)),
    ("separate_waveform", lambda p: call(p, "POST", "/separate_waveform",
                                         npz(**wave_request(11)), AUTH)),
    ("separate no token", lambda p: call(p, "POST", "/separate",
                                         npz(**spec_request(9)))),
    ("stats", lambda p: call(p, "GET", "/stats", headers=AUTH)),
    ("unknown GET", lambda p: call(p, "GET", "/nope", headers=AUTH)),
    ("unknown POST", lambda p: call(p, "POST", "/nope", b"x", AUTH)),
    ("oversized", lambda p: call(p, "POST", "/separate",
                                 b"x" * (LIMIT + 4096), AUTH)),
    ("no Content-Length", lambda p: no_length(p, "/separate")),
    ("not npz", lambda p: call(p, "POST", "/separate_waveform",
                               b"not an npz", AUTH)),
    ("wrong keys", lambda p: call(p, "POST", "/separate",
                                  npz(**wave_request(12)), AUTH)),
]


def assert_waves_close(got, ref):
    np.testing.assert_allclose(got[..., EDGE:-EDGE], ref[..., EDGE:-EDGE],
                               atol=1e-4, rtol=1e-4)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_request_sequence_matches_jax(separators):
    jsep, sep = separators
    kw = dict(auth_token=TOKEN, max_request_bytes=LIMIT)
    servers = [Serving(jax_http_server, JaxBatcher(jsep, max_batch=4), **kw),
               Serving(make_http_server,
                       BatchingSeparatorServer(sep, max_batch=4), **kw)]
    try:
        replies = [[request(s.port) for _, request in SEQUENCE]
                   for s in servers]
    finally:
        for s in servers:
            s.close()
    codes = {label: [r[i][0] for r in replies]
             for i, (label, _) in enumerate(SEQUENCE)}
    assert codes == {
        "healthz": [200, 200], "stats no token": [401, 401],
        "stats wrong token": [401, 401], "separate": [200, 200],
        "separate_waveform": [200, 200], "separate no token": [401, 401],
        "stats": [200, 200], "unknown GET": [404, 404],
        "unknown POST": [404, 404], "oversized": [413, 413],
        "no Content-Length": [411, 411], "not npz": [400, 400],
        "wrong keys": [400, 400]}
    ref, ours = replies
    at = {label: i for i, (label, _) in enumerate(SEQUENCE)}
    for i, (label, _) in enumerate(SEQUENCE):
        r, o = ref[i], ours[i]
        assert o[1]["Content-Type"] == r[1]["Content-Type"], label
        if r[1]["Content-Type"] == "application/json":
            assert set(json.loads(o[2])) == set(json.loads(r[2])), label
    stats = json.loads(ours[at["stats"]][2])
    assert stats["requests"] == 2 and stats["errors"] == 0

    def arrays(reply):
        with np.load(io.BytesIO(reply[2])) as z:
            return {k: z[k] for k in z.files}

    (r_sep, o_sep), (r_wave, o_wave) = (
        (arrays(ref[at[k]]), arrays(ours[at[k]]))
        for k in ("separate", "separate_waveform"))
    assert set(o_sep) == set(r_sep) == {"separated", "masks"}
    assert set(o_wave) == set(r_wave) == {"waveforms", "masks"}
    np.testing.assert_allclose(o_sep["masks"], r_sep["masks"], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(o_sep["separated"], r_sep["separated"],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(o_wave["masks"], r_wave["masks"], atol=2e-5,
                               rtol=1e-4)
    assert o_wave["waveforms"].shape == (2, N_AUDIO)
    assert_waves_close(o_wave["waveforms"], r_wave["waveforms"])


def test_concurrent_waveform_posts_coalesce(separators):
    _, sep = separators
    server = Serving(make_http_server,
                     BatchingSeparatorServer(sep, max_batch=8,
                                             max_delay_ms=200.0))
    codes = [None] * 8
    try:
        def client(i):
            codes[i] = call(server.port, "POST", "/separate_waveform",
                            npz(**wave_request(20 + i)))[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stats = json.loads(call(server.port, "GET", "/stats")[2])
    finally:
        server.close()
    assert codes == [200] * 8
    assert stats["requests"] == 8 and stats["max_batch"] > 1


class StubSeparator:
    """A separator whose forwards wait for `release` and record the kind
    and batch size of each dispatch."""

    data_cfg = DataConfig(**DATA)

    def __init__(self, delay_s=0.0):
        self.release = threading.Event()
        self.delay_s = delay_s
        self.batches = []

    def _run(self, mixed, kind):
        self.release.wait(TIMEOUT)
        time.sleep(self.delay_s)
        self.batches.append((kind, mixed.shape))
        return np.zeros((len(mixed), 2) + mixed.shape[1:], np.float32)

    def separate(self, mixed, lips):
        out = self._run(mixed, "spec")
        return out, out

    def separate_waveform(self, mixed, lips):
        out = self._run(mixed, "wave")
        return {"waveforms": out, "masks": out}


def test_overload_sheds_with_503_and_retry_after():
    stub = StubSeparator()
    batcher = BatchingSeparatorServer(stub, max_batch=1, max_pending=1)
    server = Serving(make_http_server, batcher)
    body = npz(**wave_request(30))
    codes = []
    try:
        def post():
            codes.append(call(server.port, "POST", "/separate_waveform",
                              body)[0])

        first = threading.Thread(target=post)
        first.start()   # taken by the dispatch thread, waits on the stub
        deadline = time.monotonic() + TIMEOUT
        while batcher._queue.qsize() or not first.is_alive():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.1)
        second = threading.Thread(target=post)
        second.start()  # fills the one-slot queue
        while not batcher._queue.qsize():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        status, headers, reply = call(server.port, "POST",
                                      "/separate_waveform", body)
        stub.release.set()
        first.join(TIMEOUT)
        second.join(TIMEOUT)
    finally:
        stub.release.set()
        server.close()
    assert status == 503 and headers["Retry-After"] == "1"
    assert "pending queue full" in json.loads(reply)["error"]
    assert sorted(codes) == [200, 200]
    assert batcher.stats.shed == 1


def make_cert(tmp_path):
    """A self-signed certificate for 127.0.0.1 -> (certfile, keyfile)."""
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    try:
        import datetime

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        import shutil
        import subprocess
        if shutil.which("openssl") is None:
            pytest.skip("neither the cryptography package nor openssl")
        subprocess.run(["openssl", "req", "-x509", "-newkey", "ec",
                        "-pkeyopt", "ec_paramgen_curve:prime256v1",
                        "-nodes", "-days", "1", "-subj", "/CN=127.0.0.1",
                        "-keyout", str(key), "-out", str(cert)],
                       check=True, capture_output=True)
        return str(cert), str(key)
    pk = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    crt = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
           .public_key(pk.public_key()).serial_number(1)
           .not_valid_before(now - datetime.timedelta(minutes=1))
           .not_valid_after(now + datetime.timedelta(days=1))
           .sign(pk, hashes.SHA256()))
    cert.write_bytes(crt.public_bytes(serialization.Encoding.PEM))
    key.write_bytes(pk.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(cert), str(key)


def test_a_stalled_tls_handshake_blocks_no_one(tmp_path):
    certfile, keyfile = make_cert(tmp_path)
    server = Serving(make_http_server,
                     BatchingSeparatorServer(StubSeparator()),
                     certfile=certfile, keyfile=keyfile)
    client = ssl.create_default_context(cafile=certfile)
    client.check_hostname = False
    stalled = socket.create_connection(("127.0.0.1", server.port),
                                       timeout=TIMEOUT)
    try:
        # The stalled client sent nothing: in a handshake in the accept
        # loop it would hold every later connection.
        time.sleep(0.2)
        t0 = time.monotonic()
        status, _, body = call(server.port, "GET", "/healthz", tls=client)
        assert status == 200 and json.loads(body) == {"status": "ok"}
        assert time.monotonic() - t0 < 5
    finally:
        stalled.close()
        server.close()


@pytest.mark.parametrize("length", ["-1", "abc", "1.5"])
def test_bad_content_length_gets_400_before_any_read(length):
    server = Serving(make_http_server,
                     BatchingSeparatorServer(StubSeparator()))
    try:
        # Nothing follows the headers: a server that read a body would
        # wait here.
        status = raw(server.port, f"POST /separate HTTP/1.1\r\nHost: x\r\n"
                                  f"Content-Length: {length}\r\n\r\n"
                                  .encode())
    finally:
        server.close()
    assert status.split()[1] == "400"
    assert server.httpd.RequestHandlerClass.timeout == REQUEST_TIMEOUT_S


def test_refused_body_is_drained_for_at_most_1mb():
    server = Serving(make_http_server,
                     BatchingSeparatorServer(StubSeparator()),
                     max_request_bytes=MAX_DRAIN_BYTES)
    try:
        # 16 MB declared, 1 MB sent: the 413 must come without the rest
        # (the JAX front end drains up to 8x the limit, 8 MB here).
        head = (f"POST /separate HTTP/1.1\r\nHost: x\r\n"
                f"Content-Length: {16 * MAX_DRAIN_BYTES}\r\n\r\n").encode()
        status = raw(server.port, head, b"x" * MAX_DRAIN_BYTES)
    finally:
        server.close()
    assert status.split()[1] == "413"


def test_a_minority_shape_is_answered_within_two_batches():
    # A steady stream of one shape with one request of another shape among
    # it: that request is held back while its neighbours' batch gathers,
    # and dispatched next.
    stub = StubSeparator(delay_s=0.005)
    batcher = BatchingSeparatorServer(stub, max_batch=4, max_delay_ms=50.0)
    common = wave_request(40)
    odd_audio = np.zeros(N_AUDIO + 400, np.float32)
    try:
        handles = [batcher.submit_waveform(common["mixed_audio"],
                                           common["lip_frames"])
                   for _ in range(6)]
        odd = batcher.submit_waveform(odd_audio, common["lip_frames"])
        handles += [batcher.submit_waveform(common["mixed_audio"],
                                            common["lip_frames"])
                    for _ in range(30)]
        stub.release.set()
        odd.result(timeout=TIMEOUT)
        for h in handles:
            h.result(timeout=TIMEOUT)
    finally:
        batcher.close()
    shapes = [shape[1] for _, shape in stub.batches]
    at = shapes.index(N_AUDIO + 400)
    # Requests 0-3 form batch 0; batch 1 gathers 4, 5, holds the odd one
    # and fills with two more; the odd one goes third.
    assert at <= 2, shapes
    assert shapes.count(N_AUDIO + 400) == 1
