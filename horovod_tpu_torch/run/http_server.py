"""HTTP key-value rendezvous server.

The port of ``horovod_tpu/run/http_server.py`` (role parity with the
reference's ``run/http/http_server.py``, RendezvousHTTPServer /
KVStoreServer): a scoped KV store over HTTP GET/PUT, the plane the
workers' metrics and trace pushers write to, with ``GET /metrics`` (the
Prometheus exposition of this process's registry and every pushed worker
snapshot) and ``GET /clock`` (the pushers' clock probe). The wire is the
JAX package's: either package's client talks to the other's server.

The client's bounded retry is :mod:`..fault.backoff`'s
(``HOROVOD_RPC_RETRIES``, ``HOROVOD_RPC_BACKOFF_*``, jitter seeded by
``HOROVOD_FAULT_SEED``), and each attempt passes the fault plan's ``kv``
tap first, so a ``drop`` burst there exercises the retry itself.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import urlparse

from .. import metrics as _metrics
from ..fault import injector as _fault
from ..fault.backoff import Backoff, retry_call


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):  # noqa: N802
        key = urlparse(self.path).path
        if key == "/metrics":
            self._serve_metrics()
            return
        if key == "/clock":
            # Fleet-tracing clock probe (docs/timeline.md "Fleet
            # tracing"): workers ping this at attach and estimate their
            # offset as driver_time - (t_send + t_recv)/2; the estimate
            # is trace METADATA only, never applied to timestamps.
            import json as _json

            body = _json.dumps({"time": time.time()}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_kv_server_requests_total", method="GET")
        with self.server.kv_lock:
            value = self.server.kv.get(key)
        if value is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):  # noqa: N802
        key = urlparse(self.path).path
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_kv_server_requests_total", method="PUT")
        with self.server.kv_lock:
            self.server.kv[key] = value
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):  # noqa: N802
        key = urlparse(self.path).path
        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_kv_server_requests_total", method="DELETE")
        with self.server.kv_lock:
            self.server.kv.pop(key, None)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _serve_metrics(self) -> None:
        """Prometheus text exposition (docs/metrics.md): the serving
        process's own registry plus every worker snapshot pushed into the
        KV ``metrics`` scope, each series stamped with its source's
        identity labels (``role="driver"`` / ``rank="N"``)."""
        from ..metrics import export as _export

        prefix = f"/{_export.KV_SCOPE}/"
        with self.server.kv_lock:
            pushed = {
                k[len(prefix):]: v
                for k, v in self.server.kv.items()
                if k.startswith(prefix)
            }
        body = _export.aggregate_kv_snapshots(
            pushed, local_snapshot=_metrics.snapshot()
        ).encode()
        self.send_response(200)
        self.send_header("Content-Type", _export.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _KVServer(ThreadingHTTPServer):
    # Explicit SO_REUSEADDR (http.server defaults to it, but a resumed
    # driver's ability to reclaim its advertised rendezvous port is a
    # correctness requirement here, not an inherited accident): lingering
    # TIME_WAIT connections from the crashed driver's clients must not
    # block the rebind.
    allow_reuse_address = True
    daemon_threads = True


class KVStoreServer:
    """In-process threaded HTTP KV server.

    ``port=0`` picks a free port. A pinned port (``HOROVOD_METRICS_PORT``
    at first launch, or the journal-recorded port on ``--resume``) is
    bound with SO_REUSEADDR; ``reclaim_wait_s`` additionally retries a
    failing bind for that long — a resumed driver racing the OS's
    cleanup of its predecessor's socket reclaims the port instead of
    dying in TIME_WAIT."""

    def __init__(self, port: int = 0, reclaim_wait_s: float = 0.0):
        import errno

        deadline = time.monotonic() + max(0.0, reclaim_wait_s)
        while True:
            try:
                self._server = _KVServer(("0.0.0.0", port), _Handler)
                break
            except OSError as exc:
                if (port == 0 or exc.errno != errno.EADDRINUSE
                        or time.monotonic() >= deadline):
                    raise OSError(
                        exc.errno,
                        f"could not bind rendezvous KV port {port}: "
                        f"{exc.strerror or exc} (pinned port still held; "
                        "waited "
                        f"{max(0.0, reclaim_wait_s):g}s for reclaim)",
                    ) from exc
                time.sleep(0.1)
        self._server.kv = {}
        self._server.kv_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="hvd_kv_server", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._server.server_close()

    def close(self) -> None:
        """Release the bound port WITHOUT the serve_forever handshake —
        for a server that was constructed but never start()ed
        (``stop()``'s shutdown() would block forever on the event only
        serve_forever sets)."""
        if self._thread is not None:
            self.stop()
        else:
            self._server.server_close()

    def put(self, scope: str, key: str, value: bytes) -> None:
        """In-process store (no HTTP round-trip) under the same lock the
        handler uses — for the owning driver's own writes."""
        with self._server.kv_lock:
            self._server.kv[f"/{scope}/{key}"] = value

    def delete(self, scope: str, key: str) -> None:
        """In-process delete (driver-side retraction of worker signals)."""
        with self._server.kv_lock:
            self._server.kv.pop(f"/{scope}/{key}", None)

    def snapshot(self, scope: str) -> Dict[str, bytes]:
        """In-process read of every key under a scope (driver-side scan
        of worker-written signals)."""
        prefix = f"/{scope}/"
        with self._server.kv_lock:
            return {
                k[len(prefix):]: v
                for k, v in self._server.kv.items()
                if k.startswith(prefix)
            }


class KVHTTPError(Exception):
    """Non-200 KV answer (e.g. 404 for a missing key). Not an OSError on
    purpose — the retry path must not spin on a definitive answer."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class KVUnavailableError(ConnectionError):
    """The KV endpoint could not be reached within the retry budget.
    Subclasses ConnectionError so existing transport-failure handling
    still matches, but the message names the endpoint, how long it has
    been down across consecutive failures, and the retry budget spent —
    a dead driver reads as "driver at host:port unreachable for 12.3s",
    not a bare timeout with a phase name."""


class KVStoreClient:
    """Plain-TCP HTTP KV client built on ``http.client.HTTPConnection``.

    Deliberately NOT ``urllib.request.urlopen``: urlopen's default opener
    constructs an HTTPS handler (``ssl.create_default_context`` →
    ``load_default_certs``) even for http:// URLs, and that OpenSSL
    initialization can deadlock in a process forked from a multi-threaded
    parent — exactly the Spark-task fork pattern this client serves.
    A raw HTTPConnection never touches ssl."""

    def __init__(self, addr: str, port: int):
        self._addr = addr
        self._port = port
        # Bounded retry with exponential backoff (HOROVOD_RPC_* knobs): a
        # dropped request must cost one backoff, not the job.
        self._backoff = Backoff.from_env()
        # First monotonic instant of the CURRENT consecutive-failure
        # streak (None = last request succeeded): errors against a dead
        # driver report elapsed downtime, not just the final attempt.
        self._down_since: Optional[float] = None

    @property
    def endpoint(self) -> str:
        return f"{self._addr}:{self._port}"

    def downtime(self) -> float:
        """Seconds this endpoint has been failing consecutively (0 when
        the last request succeeded)."""
        return (0.0 if self._down_since is None
                else time.monotonic() - self._down_since)

    def _request(self, method: str, path: str, body=None) -> bytes:
        import http.client

        if _metrics.ACTIVE:
            _metrics.TAP.inc("hvd_kv_requests_total", method=method)

        def once() -> bytes:
            if _fault.ACTIVE:
                # Chaos tap: 'drop' raises a ConnectionError before the
                # request leaves, exercising this very retry loop.
                _fault.fault_point("kv", f"{method} {path}")
            conn = http.client.HTTPConnection(
                self._addr, self._port, timeout=30
            )
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    # Deliberately NOT an OSError: a 404 is an answer
                    # (missing key), not a transport failure to retry.
                    raise KVHTTPError(
                        f"KV {method} {path}: HTTP {resp.status}",
                        status=resp.status,
                    )
                return data
            finally:
                conn.close()

        try:
            data = retry_call(
                once,
                retryable=(OSError, EOFError),
                backoff=self._backoff,
                describe=f"KV {method} {path} to {self.endpoint}",
                on_retry=lambda attempt, exc, delay: (
                    _metrics.TAP.inc("hvd_kv_retries_total", method=method)
                    if _metrics.ACTIVE else None
                ),
            )
        except KVHTTPError:
            self._down_since = None  # the server answered; it is up
            raise
        except (OSError, EOFError) as exc:
            now = time.monotonic()
            if self._down_since is None:
                self._down_since = now
            raise KVUnavailableError(
                f"KV endpoint {self.endpoint} unreachable for "
                f"{now - self._down_since:.1f}s "
                f"({method} {path}; retry budget spent: "
                f"{self._backoff.retries + 1} attempts): {exc}"
            ) from exc
        self._down_since = None
        return data

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._request("PUT", f"/{scope}/{key}", body=value)

    def get(self, scope: str, key: str,
            strict: bool = False) -> Optional[bytes]:
        """Fetch a key. Default (lenient) mode folds EVERY failure into
        None — callers that only care "is the value there yet" keep
        their simple polling loops. ``strict=True`` distinguishes the
        two reasons a value can be absent: a missing key (HTTP 404)
        still returns None, but a transport failure (dead driver)
        raises :class:`KVUnavailableError` so the caller can tell "the
        driver says no such key" from "there is no driver". Only a 404
        means "missing key": any other HTTP status (a listening but
        erroring driver — handler exception, wedged state) is a control
        plane failure, and in strict mode it must count toward the
        driver-lost threshold exactly like a dead endpoint."""
        try:
            return self._request("GET", f"/{scope}/{key}")
        except KVHTTPError as exc:
            if exc.status == 404 or not strict:
                return None
            raise KVUnavailableError(
                f"KV endpoint {self.endpoint} answering but failing: "
                f"HTTP {exc.status} for GET /{scope}/{key}"
            ) from exc
        except Exception:
            if strict:
                raise
            return None

    def wait(self, scope: str, key: str, timeout: float = 60.0) -> bytes:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = self.get(scope, key)
            if v is not None:
                return v
            time.sleep(0.1)
        raise TimeoutError(f"KV key {scope}/{key} not available")
