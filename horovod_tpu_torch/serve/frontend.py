"""HTTP frontend of the serving engine: the request plane.

The counterpart of ``horovod_tpu/serve/frontend.py``: one threaded
``ThreadingHTTPServer``, quiet logging, SO_REUSEADDR. Endpoints:

- ``POST /v1/completions``: body ``{"prompt": [token ids], "max_tokens":
  N}``; blocks until the engine ledgers the answer and returns ``{"id",
  "outcome", "completion"}``. The outcome sets the status: ``ok`` 200,
  ``rejected`` (queue bound) 429, ``dropped`` (injected fault) 503, so a
  dropped request is still answered.
- ``GET /healthz``: live replica count and queue depth.
- ``GET /metrics``: the Prometheus exposition of this process's metrics
  registry (``hvd_request_*``, ``hvd_serve_*`` and every other series;
  empty unless ``HOROVOD_METRICS`` is set), as
  ``horovod_tpu/serve/frontend.py:55-59`` serves it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

from .. import metrics as _metrics


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, status: int, body: bytes,
               ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, doc) -> None:
        self._reply(status, json.dumps(doc, sort_keys=True).encode())

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        engine = self.server.engine
        if path == "/healthz":
            self._reply_json(200, {
                "replicas": engine.live_replicas(),
                "queue_depth": engine._batcher.depth(),
            })
            return
        if path == "/metrics":
            from ..metrics import export as _export

            body = _export.aggregate_kv_snapshots(
                {}, local_snapshot=_metrics.snapshot()
            ).encode()
            self._reply(200, body, ctype=_export.CONTENT_TYPE)
            return
        self._reply_json(404, {"error": f"no such endpoint {path!r}"})

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path
        if path != "/v1/completions":
            self._reply_json(404, {"error": f"no such endpoint {path!r}"})
            return
        engine = self.server.engine
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length) or b"{}")
            prompt = doc["prompt"]
            max_tokens = int(doc.get("max_tokens", 16))
            rid = engine.submit(prompt, max_tokens=max_tokens)
        except (KeyError, TypeError, ValueError) as exc:
            self._reply_json(400, {"error": str(exc)})
            return
        comp = engine.result(rid, timeout=self.server.request_timeout_s)
        status = {"ok": 200, "rejected": 429, "dropped": 503}.get(
            comp.outcome, 500
        )
        self._reply_json(status, {
            "id": comp.id,
            "outcome": comp.outcome,
            "completion": list(comp.tokens),
        })


class _Server(ThreadingHTTPServer):
    allow_reuse_address = True
    daemon_threads = True


class ServeFrontend:
    """In-process threaded HTTP request plane over one ServeEngine
    (``port=0`` picks a free port)."""

    def __init__(self, engine, port: int = 0,
                 request_timeout_s: float = 120.0):
        self._server = _Server(("0.0.0.0", port), _Handler)
        self._server.engine = engine
        self._server.request_timeout_s = float(request_timeout_s)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="hvd_serve_http",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._server.server_close()
